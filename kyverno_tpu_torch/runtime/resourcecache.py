"""Caches of the host side.

:class:`ResourceCache` is the watch-maintained read-through lister per
GVK (upstream Kyverno's pkg/resourcecache: per-kind caches created on
demand, kept in sync by the cluster watch stream when the client provides
one — ``FakeCluster.watch``, or a ``RestClient``'s informers — and TTL
resync otherwise). The webhook reads namespace labels and ConfigMaps
through it, so steady-state admission does no synchronous API GETs.

:class:`FlattenRowCache` is the admission batcher's flatten-row memo
(its :meth:`~FlattenRowCache.digest` is the canonical body digest both
content-addressed caches key on), and :class:`HostVerdictCache` memoizes
the CPU oracle's verdicts for HOST cells.
"""

from __future__ import annotations

import threading
import time


class _Entry:
    __slots__ = ("resource", "stamp", "pending")

    def __init__(self, resource: dict | None, stamp: float,
                 pending: bool = False):
        self.resource = resource          # None caches a confirmed absence
        self.stamp = stamp
        self.pending = pending            # read-through fetch in flight


class ResourceCache:
    """pkg/resourcecache ResourceCache."""

    def __init__(self, client, resync_s: float = 60.0,
                 informer_sync_timeout_s: float = 10.0):
        self.client = client
        self.resync_s = resync_s
        self.informer_sync_timeout_s = informer_sync_timeout_s
        self._lock = threading.Lock()
        self._informer_create_lock = threading.Lock()
        self._entries: dict[tuple, _Entry] = {}
        self._watching = False
        self._informed: dict[tuple, object] = {}  # (apiVersion, kind) -> Reflector
        self._event_kinds: set[str] = set()       # kinds with events flowing
        self._sync_waited: set[tuple] = set()
        self.lookups = 0
        self.fetches = 0
        if client is not None and hasattr(client, "watch"):
            client.watch(self._on_event)
            self._watching = True

    @staticmethod
    def _key(kind: str, namespace: str, name: str) -> tuple:
        return (kind, namespace or "", name)

    def _on_event(self, event: str, resource: dict) -> None:
        meta = resource.get("metadata") or {}
        kind = resource.get("kind", "")
        key = self._key(kind, meta.get("namespace", ""),
                        meta.get("name", ""))
        with self._lock:
            # informer-watched kinds hold complete state: upsert every
            # event; the global FakeCluster watch only maintains keys a
            # reader already populated
            if key not in self._entries and kind not in self._event_kinds:
                return
            if event == "DELETED":
                self._entries[key] = _Entry(None, time.monotonic())
            else:
                self._entries[key] = _Entry(resource, time.monotonic())

    def _on_informer_sync(self, kind: str, items: list[dict]) -> None:
        """Full re-list for an informed kind: replace that kind's slice of
        the cache wholesale (objects deleted during a watch outage must
        not survive the re-list)."""
        now = time.monotonic()
        with self._lock:
            for key in [k for k in self._entries if k[0] == kind]:
                del self._entries[key]
            for r in items:
                meta = r.get("metadata") or {}
                key = self._key(kind, meta.get("namespace", ""),
                                meta.get("name", ""))
                self._entries[key] = _Entry(r, now)

    def _ensure_informer(self, api_version: str, kind: str):
        """First lookup of a kind on an informer-capable client starts its
        reflector (resourcecache.go CreateGVKInformer) and waits for the
        initial list; after that every lookup of the kind is a pure cache
        read — including confirmed absences — with zero polling GETs."""
        gvk = (api_version, kind)
        with self._lock:
            refl = self._informed.get(gvk)
        if refl is not None:
            return refl
        # ensure_informer may synchronously replay on_sync when the shared
        # WatchHub already holds a synced reflector for this GVK, and
        # _on_informer_sync takes self._lock — so the call must happen
        # OUTSIDE self._lock (non-reentrant: holding it here deadlocks the
        # admission thread). A separate creation mutex keeps the register
        # single-shot per GVK without involving self._lock.
        with self._informer_create_lock:
            with self._lock:
                refl = self._informed.get(gvk)
                if refl is None:
                    # open the event gate BEFORE registering: the hub
                    # starts delivering events the moment callbacks are in,
                    # and _on_event must not drop them (a dropped ADDED
                    # reads back as a confirmed absence until a re-list)
                    self._event_kinds.add(kind)
            if refl is not None:
                return refl
            refl = self.client.ensure_informer(
                api_version, kind,
                on_event=self._on_event,
                on_sync=lambda items, k=kind: self._on_informer_sync(
                    k, items))
            with self._lock:
                self._informed[gvk] = refl
        return refl

    def get(self, api_version: str, kind: str, namespace: str,
            name: str) -> dict | None:
        """Lister get: cache hit while watch-fresh (or within the resync
        window), read-through to the client otherwise."""
        self.lookups += 1
        key = self._key(kind, namespace, name)
        if self.client is not None and hasattr(self.client, "ensure_informer"):
            refl = self._ensure_informer(api_version, kind)
            # block for the initial list only once per GVK — a reflector
            # that cannot sync (RBAC-forbidden list, degraded apiserver)
            # must not turn every lookup into a 10s stall; later lookups
            # check non-blocking and read through until it recovers
            gvk = (api_version, kind)
            first = gvk not in self._sync_waited
            self._sync_waited.add(gvk)
            if refl.wait_synced(self.informer_sync_timeout_s if first
                                else 0):
                with self._lock:
                    entry = self._entries.get(key)
                    # complete state for this kind: a missing key IS a
                    # confirmed absence, no GET needed
                    return entry.resource if entry is not None else None
            # informer not synced (apiserver hiccup): read through below
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and not entry.pending and (
                    self._watching or now - entry.stamp < self.resync_s):
                return entry.resource
            # reserve the key BEFORE fetching so a watch event arriving
            # while the GET is in flight is captured (and wins below);
            # concurrent readers share the first reader's reservation
            # instead of overwriting it
            pending = None
            if entry is None or not entry.pending:
                pending = _Entry(None, now, pending=True)
                self._entries[key] = pending
        if self.client is None:
            with self._lock:
                if pending is not None and self._entries.get(key) is pending:
                    del self._entries[key]
            return None
        self.fetches += 1
        resource = self.client.get_resource(api_version, kind, namespace, name)
        with self._lock:
            current = self._entries.get(key)
            if pending is not None and current is pending:
                self._entries[key] = _Entry(resource, now)
                return resource
            if current is not None and not current.pending:
                # a watch event landed during the GET: it is fresher
                return current.resource
            # another reader still owns the reservation; our fetched copy
            # is the answer for THIS call either way
            return resource

    def get_namespace_labels(self, namespace: str) -> dict:
        ns = self.get("v1", "Namespace", "", namespace)
        if not ns:
            return {}
        return (ns.get("metadata") or {}).get("labels") or {}

    def get_configmap(self, namespace: str, name: str) -> dict | None:
        return self.get("v1", "ConfigMap", namespace, name)

    def invalidate(self, kind: str = "", namespace: str = "",
                   name: str = "") -> None:
        with self._lock:
            if not kind:
                self._entries.clear()
            else:
                self._entries.pop(self._key(kind, namespace, name), None)


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
    keeps the memo warm instead of flushing it."""

    def __init__(self, max_rows: int = 4096):
        from collections import OrderedDict

        self.max_rows = max_rows
        self._lock = threading.Lock()
        self._rows: "OrderedDict[tuple[str, bytes], object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.extended = 0         # epoch-refreshed survivals within hits
        # fleet wiring (fleet/fabric.attach_stack): cross-replica
        # read-through on the fingerprint-keyed tier; dormant while
        # unattached or KTPU_FABRIC is off
        self.fabric = None
        self.fabric_hits = 0

    def attach_fabric(self, client) -> None:
        self.fabric = client

    def _fabric_row(self, tensors, digest: bytes):
        """Cross-replica miss fill. The fabric keys on
        ``tensors.fingerprint`` — the content digest of exactly what
        flattening consumes — NOT memo_space (the incremental lineage is
        a per-process uuid), so a fingerprint-exact PackedRow fetched
        from another replica is byte-valid here with no epoch
        revalidation. Any failure is a plain miss."""
        if self.fabric is None or digest is None:
            return None
        try:
            from ..fleet import fabric as fabric_mod

            if not fabric_mod.fabric_enabled():
                return None
            fp = getattr(tensors, "fingerprint", None)
            if not fp:
                return None
            blob = self.fabric.get("flatten",
                                   fabric_mod.flatten_key(fp, digest))
            if blob is None:
                return None
            return fabric_mod.decode_flatten_row(blob)
        except Exception:
            return None

    def _memoize_fabric_row(self, key: tuple, row, tensors):
        """A fabric-fetched row enters the local memo at the current
        dictionary coordinates (fingerprint-exact = current-epoch-exact)
        and counts as a hit."""
        from ..models.flatten import MemoRow

        with self._lock:
            self.hits += 1
            self.fabric_hits += 1
            self._rows[key] = MemoRow(row=row, n_paths=tensors.n_paths,
                                      epoch=tensors.dict_epoch)
            self._rows.move_to_end(key)
            while len(self._rows) > self.max_rows:
                self._rows.popitem(last=False)
        return row

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
        self._store([((fingerprint, digest), row)])

    def _store(self, entries) -> None:
        """Insert each ``(key, row)`` of ``entries`` in order (a key with
        no digest is skipped) under one acquisition of the lock, then
        evict the least recently used rows past ``max_rows``."""
        with self._lock:
            for key, row in entries:
                if key[1] is None:
                    continue
                self._rows[key] = row
                self._rows.move_to_end(key)
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
            row = self._fabric_row(tensors, digest)
            if row is not None:
                return self._memoize_fabric_row(key, row, tensors)
            with self._lock:
                self.misses += 1
            return None
        refreshed, ext = refresh_packed_row(memo, resource, tensors,
                                            request=request)
        if refreshed is None:
            with self._lock:
                self._rows.pop(key, None)
            row = self._fabric_row(tensors, digest)
            if row is not None:
                return self._memoize_fabric_row(key, row, tensors)
            with self._lock:
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
        so later epochs can revalidate instead of re-flattening. With a
        ``fingerprint`` and an attached fabric, the bare row is also
        published to the shared tier (fingerprint-keyed — replicas
        revalidate nothing, so the MemoRow envelope stays local)."""
        self.put_rows(space, [(digest, row)], n_paths, epoch,
                      fingerprint=fingerprint)

    def put_rows(self, space: str, rows, n_paths: int, epoch: int,
                 fingerprint: str | None = None) -> None:
        """:meth:`put_row` for every ``(digest, row)`` of ``rows``, in
        order, under one acquisition of the memo's lock (a flush's rows
        at once), then each to the fabric."""
        from ..models.flatten import MemoRow

        rows = [(d, row) for d, row in rows if d is not None]
        self._store([((space, d), MemoRow(row=row, n_paths=n_paths,
                                          epoch=epoch))
                     for d, row in rows])
        if fingerprint and self.fabric is not None:
            try:
                from ..fleet import fabric as fabric_mod

                if fabric_mod.fabric_enabled():
                    for d, row in rows:
                        self.fabric.put(
                            "flatten", fabric_mod.flatten_key(fingerprint, d),
                            fabric_mod.encode_flatten_row(row))
            except Exception:
                pass

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
                    "fabric_hits": self.fabric_hits,
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
        # fleet wiring (fleet/fabric.attach_stack): cross-replica
        # read-through keyed the same (policy digest, rule, body digest)
        # way; dormant while unattached or KTPU_FABRIC is off
        self.fabric = None
        self.fabric_hits = 0

    def attach_fabric(self, client) -> None:
        self.fabric = client

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
        """(verdict, message) or None; expiry counts as a miss. A local
        miss consults the attached fabric before giving up."""
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
        hit = self._fabric_cell(key)
        if hit is not None:
            return hit
        with self._lock:
            self.misses += 1
        return None

    def _fabric_cell(self, key: tuple) -> tuple | None:
        """Cross-replica miss fill: the fabric value carries an absolute
        expiry, so the remaining validity window transfers (an expired
        remote verdict is a plain miss). Any failure is a miss."""
        if self.fabric is None:
            return None
        try:
            from ..fleet import fabric as fabric_mod

            if not fabric_mod.fabric_enabled():
                return None
            fkey = fabric_mod.host_key(key)
            if fkey is None:
                return None
            blob = self.fabric.get("host", fkey)
            if blob is None:
                return None
            verdict, msg, remaining = fabric_mod.decode_host_verdict(blob)
            if remaining <= 0:
                return None
            with self._lock:
                self.hits += 1
                self.fabric_hits += 1
                self._cells[key] = (time.monotonic() + remaining,
                                    verdict, msg)
                self._cells.move_to_end(key)
                while len(self._cells) > self.max_cells:
                    self._cells.popitem(last=False)
            return (verdict, msg)
        except Exception:
            return None

    def put(self, key: tuple, verdict, message: str, ttl_s: float) -> None:
        with self._lock:
            self._cells[key] = (time.monotonic() + ttl_s, verdict, message)
            self._cells.move_to_end(key)
            while len(self._cells) > self.max_cells:
                self._cells.popitem(last=False)
        if self.fabric is not None:
            try:
                from ..fleet import fabric as fabric_mod

                if fabric_mod.fabric_enabled():
                    fkey = fabric_mod.host_key(key)
                    if fkey is not None:
                        self.fabric.put(
                            "host", fkey,
                            fabric_mod.encode_host_verdict(
                                verdict, message, ttl_s))
            except Exception:
                pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._cells)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"cells": len(self._cells), "hits": self.hits,
                    "misses": self.misses, "expired": self.expired,
                    "fabric_hits": self.fabric_hits,
                    "hit_ratio": (self.hits / total if total else 0.0)}

    def clear(self) -> None:
        with self._lock:
            self._cells.clear()
