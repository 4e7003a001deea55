"""Content-addressed caches of the host side.

:class:`FlattenRowCache` is the admission batcher's flatten-row memo
(its :meth:`~FlattenRowCache.digest` is the canonical body digest both
caches key on), and :class:`HostVerdictCache` memoizes the CPU oracle's
verdicts for HOST cells. The JAX package's watch-maintained
``ResourceCache`` (the cluster informer cache) comes with the client and
the webhook.
"""

from __future__ import annotations

import threading
import time


class FlattenRowCache:
    """Content-addressed memo of per-resource flattened rows
    (models/flatten.py PackedRow), keyed by (PolicyTensors fingerprint,
    canonical resource digest).

    The fingerprint covers exactly what flattening consumes — the path
    dictionary and kind index — so a policy recompile that moves the
    dictionary gets a different key space and stale rows can never splice
    into a new tensor set's batch (no explicit invalidation protocol to
    get wrong); recompiles that leave the dictionary untouched keep their
    hits. The digest is the blake2b of the sorted-key JSON of the
    (resource, request-envelope) pair — flattening never depends on dict
    key order, so the canonicalization is sound, and resources that JSON
    can't serialize simply skip the memo. LRU-bounded by row count.

    With incremental compilation the key space is the dictionary lineage
    (PolicyTensors.memo_space = dict_base) rather than the fingerprint,
    and entries are MemoRow (models/flatten.py) carrying their epoch:
    ``get_row``/``put_row`` revalidate rows across policy updates by
    delta-flattening only the appended paths, so a policy-update storm
    keeps the memo warm instead of flushing it. The JAX package's
    cross-replica read-through (its fleet fabric) is not here."""

    def __init__(self, max_rows: int = 4096):
        from collections import OrderedDict

        self.max_rows = max_rows
        self._lock = threading.Lock()
        self._rows: "OrderedDict[tuple[str, bytes], object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.extended = 0         # epoch-refreshed survivals within hits

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

    def get(self, fingerprint: str, digest: bytes | None):
        if digest is None:
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            row = self._rows.get((fingerprint, digest))
            if row is None:
                self.misses += 1
                return None
            self._rows.move_to_end((fingerprint, digest))
            self.hits += 1
            return row

    def put(self, fingerprint: str, digest: bytes | None, row) -> None:
        if digest is None:
            return
        with self._lock:
            self._rows[(fingerprint, digest)] = row
            self._rows.move_to_end((fingerprint, digest))
            while len(self._rows) > self.max_rows:
                self._rows.popitem(last=False)

    def get_row(self, space: str, digest: bytes | None, resource: dict,
                tensors, request: dict | None = None):
        """Epoch-aware lookup for incremental tensor sets: returns the
        memoized PackedRow revalidated against ``tensors`` (models/flatten
        refresh_packed_row), or None on miss / foreign lineage. An
        epoch-extended row counts as a hit — the prefix flatten work
        survived the policy update."""
        from ..models.flatten import MemoRow, refresh_packed_row

        if digest is None:
            with self._lock:
                self.misses += 1
            return None
        key = (space, digest)
        with self._lock:
            memo = self._rows.get(key)
            if isinstance(memo, MemoRow):
                self._rows.move_to_end(key)
            else:
                memo = None
        if memo is None:
            with self._lock:
                self.misses += 1
            return None
        refreshed, ext = refresh_packed_row(memo, resource, tensors,
                                            request=request)
        if refreshed is None:
            with self._lock:
                self._rows.pop(key, None)
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
            if ext:
                self.extended += 1
                # a concurrent put may have stored a fresher entry; only
                # upgrade our own stale one
                if self._rows.get(key) is memo:
                    self._rows[key] = refreshed
        return refreshed.row

    def put_row(self, space: str, digest: bytes | None, row,
                n_paths: int, epoch: int,
                fingerprint: str | None = None) -> None:
        """Store a freshly-split PackedRow with its dictionary coordinates
        so later epochs can revalidate instead of re-flattening.
        ``fingerprint`` keys the JAX package's cross-replica tier, which
        the port does not have; it is accepted and unused."""
        from ..models.flatten import MemoRow

        self.put(space, digest, MemoRow(row=row, n_paths=n_paths,
                                        epoch=epoch))

    def survival_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"rows": len(self._rows), "hits": self.hits,
                    "misses": self.misses, "extended": self.extended,
                    "survival_ratio": (self.hits / total if total
                                       else 0.0)}

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()


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
