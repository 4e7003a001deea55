"""Content-addressed caches of the host lane.

:class:`HostVerdictCache` memoizes the CPU oracle's verdicts for HOST
cells; :meth:`FlattenRowCache.digest` is the canonical body digest it
keys on. The rest of the JAX package's module (the watch-maintained
``ResourceCache`` and the flatten-row memo of ``FlattenRowCache``)
comes with the flattener's row memo.
"""

from __future__ import annotations

import threading
import time


class FlattenRowCache:
    """The canonical digest of the flatten-row memo. Only the digest is
    here so far: the host-verdict memo keys on it."""

    @staticmethod
    def digest(resource: dict, request: dict | None = None) -> bytes | None:
        import hashlib
        import json

        try:
            blob = json.dumps((resource, request), sort_keys=True,
                              separators=(",", ":"),
                              allow_nan=False).encode("utf-8")
        except (TypeError, ValueError):
            return None
        return hashlib.blake2b(blob, digest_size=16).digest()


class HostVerdictCache:
    """Content-addressed memo of CPU-oracle host-lane verdicts
    (models/engine.resolve_host_cells), keyed by (policy content digest,
    rule name, canonical body digest).

    An oracle verdict depends on exactly one policy's raw document plus
    the (resource, context) pair — nothing else in the set — so the key
    is the *policy content*, not the set: a recompiled policy whose raw
    is unchanged hashes to the same digest and keeps its entries, while
    an edited policy gets a fresh key space the moment it lands (no
    invalidation protocol to get wrong). Rule *names* replace rule
    indices for the same reason — indices move when the rule axis is
    relaid out, names don't.

    Entries carry a TTL: context-dependent rules (policies that are not
    oracle_pool.pool_safe — ConfigMap/APICall context entries read live
    cluster state) expire after ``context_ttl_s`` so a stale lookup
    can't outlive the state it read; pure pattern rules (verdict a
    function of the body alone) keep the long ``pure_ttl_s``. Bodies
    that JSON can't canonicalize simply skip the memo. LRU-bounded."""

    def __init__(self, max_cells: int = 65536, pure_ttl_s: float = 600.0,
                 context_ttl_s: float = 2.0):
        from collections import OrderedDict

        self.max_cells = max_cells
        self.pure_ttl_s = pure_ttl_s
        self.context_ttl_s = context_ttl_s
        self._lock = threading.Lock()
        # (policy_digest, rule_name, body_digest) -> (expiry, verdict, msg)
        self._cells: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.expired = 0

    @staticmethod
    def body_digest(resource: dict, context: dict | None = None) -> bytes | None:
        """Canonical digest of what the oracle reads besides the policy:
        the resource body and the admission context payload (None for
        the bare scan-path context). The oracle never depends on dict
        key order, so the digest sorts keys."""
        return FlattenRowCache.digest(resource, context)

    @staticmethod
    def policy_digest(policy) -> bytes | None:
        """blake2b of the policy's raw document, cached on the policy
        object (policies are immutable once loaded; an update is a new
        object). None (memo skip) when the raw isn't serializable."""
        d = getattr(policy, "_ktpu_content_digest", False)
        if d is False:
            import hashlib
            import json

            try:
                blob = json.dumps(policy.raw, sort_keys=True,
                                  separators=(",", ":"),
                                  allow_nan=False).encode("utf-8")
                d = hashlib.blake2b(blob, digest_size=16).digest()
            except (TypeError, ValueError, AttributeError):
                d = None
            try:
                policy._ktpu_content_digest = d
            except Exception:
                pass
        return d

    def get(self, key: tuple) -> tuple | None:
        """(verdict, message) or None; expiry counts as a miss."""
        now = time.monotonic()
        with self._lock:
            cell = self._cells.get(key)
            if cell is not None:
                expiry, verdict, msg = cell
                if now < expiry:
                    self._cells.move_to_end(key)
                    self.hits += 1
                    return (verdict, msg)
                del self._cells[key]
                self.expired += 1
            self.misses += 1
        return None

    def put(self, key: tuple, verdict, message: str, ttl_s: float) -> None:
        with self._lock:
            self._cells[key] = (time.monotonic() + ttl_s, verdict, message)
            self._cells.move_to_end(key)
            while len(self._cells) > self.max_cells:
                self._cells.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._cells)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"cells": len(self._cells), "hits": self.hits,
                    "misses": self.misses, "expired": self.expired,
                    "hit_ratio": (self.hits / total if total else 0.0)}

    def clear(self) -> None:
        with self._lock:
            self._cells.clear()
