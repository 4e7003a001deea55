"""Fleet verdict fabric: a shared cache tier across replica boundaries.

Every replica today runs three per-process caches — the batcher's
decision cache, the :class:`~..runtime.resourcecache.FlattenRowCache`
row memo, and the :class:`~..runtime.resourcecache.HostVerdictCache`
oracle memo. Their keys are already content-addressed (policy-set /
dictionary fingerprints plus canonical body digests), which means a
verdict computed on replica A is byte-valid on replica B — the caches
just have no way to meet. This module is that meeting point: a
:class:`FabricHub` holds one shared, LRU-bounded, epoch-stamped store
per tier, and :class:`FabricClient` gives each replica read-through /
publish access over the stream plane's frame codec
(``F_CACHE_GET/PUT/INVALIDATE`` payloads from
``runtime/stream_server.py``, length-prefix framed on the socket
transport).

Keying (all replica-stable, no process-local identifiers):

``decision``
    ``policy-set digest | ptype | kind | namespace | body digest`` —
    the batcher's ``_cache_key`` with the per-process generation
    counter replaced by a content digest of the policy set (sorted
    per-policy raw-document digests).
``flatten``
    ``tensors.fingerprint | body digest`` — the *fingerprint*, not
    ``memo_space`` (the incremental dictionary lineage is a per-process
    uuid); a fingerprint-exact PackedRow is byte-valid on any replica.
``host``
    ``policy digest | rule name | body digest`` — HostVerdictCache's
    own key, hex-joined.

Invalidation is epoch-scoped: an ``F_CACHE_INVALIDATE`` (driven by
``IncrementalCompiler`` refreshes / policy-cache churn on any replica)
purges matching rows AND bumps the hub epoch; every ``PUT`` carries the
sender's last-observed epoch and the hub rejects stale ones, so a
verdict computed against pre-churn policy state can never be published
after the churn invalidated it (the classic read-compute-put race).

The ``KTPU_FABRIC`` master switch gates every consultation site: off
(the default), an attached fabric is never called and decisions are
bit-for-bit the single-replica ones (held by tests/test_torch_fleet.py
and chip_smoke.py's ``[fleet]`` phase).
Fabric *failures* are never decision failures — every client path
degrades to a local miss.
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
import threading
import weakref
from collections import OrderedDict

from ..runtime import featureplane
from ..runtime import metrics as metrics_mod
from ..runtime.stream_server import (
    F_CACHE_GET,
    F_CACHE_INVALIDATE,
    F_CACHE_MISS,
    F_CACHE_OK,
    F_CACHE_PUT,
    F_ERROR,
    MAX_FRAME_BYTES,
    decode_payload,
    encode_payload,
)

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_LEN_PREFIX = struct.Struct("<I")

TIERS = ("decision", "flatten", "host")


def fabric_enabled() -> bool:
    """KTPU_FABRIC master switch (default off = single-replica)."""
    return featureplane.enabled("KTPU_FABRIC") and \
        featureplane.raw("KTPU_FABRIC") != ""


def transport_preference() -> str:
    """inproc | socket (the deployment wiring knob)."""
    return featureplane.raw("KTPU_FABRIC_TRANSPORT")


class FabricError(RuntimeError):
    """Server-side F_ERROR reply."""


# ------------------------------------------------------------ frame codec
#
# Request bodies (little-endian, riding the stream payload codec):
#   GET         u16 tlen | tier | key
#   PUT         u64 epoch | u16 tlen | tier | u32 klen | key | value
#   INVALIDATE  u16 tlen | tier ("" = all tiers) | prefix ("" = all keys)
# Reply bodies:
#   OK (get)    u64 epoch | value
#   OK (put)    u64 epoch | u8 stored
#   OK (inval)  u64 epoch | u32 purged
#   MISS        u64 epoch


def encode_get(req_id: int, tier: str, key: bytes) -> bytes:
    t = tier.encode("ascii")
    return encode_payload(F_CACHE_GET, req_id,
                          b"".join((_U16.pack(len(t)), t, key)))


def encode_put(req_id: int, epoch: int, tier: str, key: bytes,
               value: bytes) -> bytes:
    t = tier.encode("ascii")
    return encode_payload(F_CACHE_PUT, req_id, b"".join((
        _U64.pack(epoch), _U16.pack(len(t)), t,
        _U32.pack(len(key)), key, value)))


def encode_invalidate(req_id: int, tier: str = "",
                      prefix: bytes = b"") -> bytes:
    t = tier.encode("ascii")
    return encode_payload(F_CACHE_INVALIDATE, req_id,
                          b"".join((_U16.pack(len(t)), t, prefix)))


def _split_tier(body: bytes) -> tuple[str, bytes]:
    (tlen,) = _U16.unpack_from(body, 0)
    off = _U16.size
    tier = bytes(body[off:off + tlen]).decode("ascii")
    return tier, body[off + tlen:]


def decode_get(body: bytes) -> tuple[str, bytes]:
    return _split_tier(body)


def decode_put(body: bytes) -> tuple[int, str, bytes, bytes]:
    (epoch,) = _U64.unpack_from(body, 0)
    tier, rest = _split_tier(body[_U64.size:])
    (klen,) = _U32.unpack_from(rest, 0)
    off = _U32.size
    return epoch, tier, bytes(rest[off:off + klen]), rest[off + klen:]


def decode_invalidate(body: bytes) -> tuple[str, bytes]:
    tier, prefix = _split_tier(body)
    return tier, bytes(prefix)


# ------------------------------------------------------------------- hub


class FabricHub:
    """The shared store: one LRU-bounded, epoch-stamped OrderedDict per
    tier behind one lock, handling the CACHE_* payloads. Stateless with
    respect to replicas — any number of clients (in-process or socket)
    share it."""

    def __init__(self, max_entries_per_tier: int = 65536):
        self._lock = threading.Lock()
        self._tiers: dict[str, OrderedDict] = {
            t: OrderedDict() for t in TIERS}
        self.max_entries = max_entries_per_tier
        self.epoch = 0
        self.stats = {"frames": 0, "gets": 0, "hits": 0, "misses": 0,
                      "puts": 0, "stale_puts": 0, "invalidations": 0,
                      "purged": 0, "errors": 0}
        _HUBS.add(self)

    # -------------------------------------------------------------- ops

    def get(self, tier: str, key: bytes) -> tuple[int, bytes | None]:
        with self._lock:
            self.stats["gets"] += 1
            store = self._tiers[tier]
            cell = store.get(key)
            if cell is None:
                self.stats["misses"] += 1
                return self.epoch, None
            store.move_to_end(key)
            self.stats["hits"] += 1
            return self.epoch, cell[1]

    def put(self, tier: str, key: bytes, value: bytes,
            epoch: int) -> tuple[int, bool]:
        """Store unless the sender's epoch is stale (computed against
        state an invalidation has since purged)."""
        with self._lock:
            self.stats["puts"] += 1
            if epoch != self.epoch:
                self.stats["stale_puts"] += 1
                return self.epoch, False
            store = self._tiers[tier]
            store[key] = (epoch, value)
            store.move_to_end(key)
            while len(store) > self.max_entries:
                store.popitem(last=False)
            return self.epoch, True

    def invalidate(self, tier: str = "",
                   prefix: bytes = b"") -> tuple[int, int]:
        """Purge matching rows and bump the epoch (so in-flight puts
        computed against the purged state are rejected on arrival)."""
        with self._lock:
            purged = 0
            tiers = (tier,) if tier else TIERS
            for t in tiers:
                store = self._tiers[t]
                if not prefix:
                    purged += len(store)
                    store.clear()
                else:
                    doomed = [k for k in store if k.startswith(prefix)]
                    for k in doomed:
                        del store[k]
                    purged += len(doomed)
            self.epoch += 1
            self.stats["invalidations"] += 1
            self.stats["purged"] += purged
            return self.epoch, purged

    # ------------------------------------------------------------ frames

    def handle_payload(self, payload: bytes) -> bytes:
        """One request payload in, one reply payload out (the in-process
        transport IS this method; the socket server length-frames it)."""
        reg = metrics_mod.registry()
        try:
            ftype, req_id, body = decode_payload(payload)
        except ValueError as e:
            with self._lock:
                self.stats["errors"] += 1
            return encode_payload(F_ERROR, 0, str(e).encode())
        with self._lock:
            self.stats["frames"] += 1
        try:
            if ftype == F_CACHE_GET:
                tier, key = decode_get(body)
                epoch, value = self.get(tier, key)
                metrics_mod.record_fabric_frame(reg, "get", tier)
                if value is None:
                    return encode_payload(F_CACHE_MISS, req_id,
                                          _U64.pack(epoch))
                return encode_payload(F_CACHE_OK, req_id,
                                      _U64.pack(epoch) + value)
            if ftype == F_CACHE_PUT:
                epoch, tier, key, value = decode_put(body)
                epoch_now, stored = self.put(tier, key, bytes(value),
                                             epoch)
                metrics_mod.record_fabric_frame(reg, "put", tier)
                return encode_payload(
                    F_CACHE_OK, req_id,
                    _U64.pack(epoch_now) + _U8.pack(int(stored)))
            if ftype == F_CACHE_INVALIDATE:
                tier, prefix = decode_invalidate(body)
                epoch_now, purged = self.invalidate(tier, prefix)
                metrics_mod.record_fabric_frame(reg, "invalidate",
                                                tier or "all")
                metrics_mod.record_fabric_invalidation(
                    reg, tier or "all", purged)
                return encode_payload(
                    F_CACHE_OK, req_id,
                    _U64.pack(epoch_now) + _U32.pack(purged))
            with self._lock:
                self.stats["errors"] += 1
            return encode_payload(
                F_ERROR, req_id,
                f"unknown fabric frame type {ftype:#x}".encode())
        except (KeyError, struct.error, UnicodeDecodeError) as e:
            with self._lock:
                self.stats["errors"] += 1
            return encode_payload(F_ERROR, req_id,
                                  f"{type(e).__name__}: {e}".encode())

    def snapshot(self) -> dict:
        with self._lock:
            return {"epoch": self.epoch,
                    "entries": {t: len(s)
                                for t, s in self._tiers.items()},
                    **dict(self.stats)}


# ------------------------------------------------------- socket transport


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class FabricSocketServer:
    """The hub behind the stream plane's u32 length-prefix framing on a
    plain TCP socket — the cross-process deployment shape. Port 0 picks
    a free port; read it back from :attr:`port`."""

    def __init__(self, hub: FabricHub, host: str = "127.0.0.1",
                 port: int = 0):
        self.hub = hub
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="fabric-hub", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="fabric-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                hdr = _read_exact(conn, _LEN_PREFIX.size)
                if hdr is None:
                    return
                (length,) = _LEN_PREFIX.unpack(hdr)
                if length > MAX_FRAME_BYTES:
                    return
                payload = _read_exact(conn, length)
                if payload is None:
                    return
                reply = self.hub.handle_payload(payload)
                conn.sendall(_LEN_PREFIX.pack(len(reply)) + reply)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass


class SocketTransport:
    """Synchronous request/response over one framed connection (one
    in-flight frame per transport; the per-replica client serializes)."""

    def __init__(self, host: str, port: int, timeout_s: float = 2.0):
        self._lock = threading.Lock()
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)

    def __call__(self, payload: bytes) -> bytes:
        with self._lock:
            self._sock.sendall(_LEN_PREFIX.pack(len(payload)) + payload)
            hdr = _read_exact(self._sock, _LEN_PREFIX.size)
            if hdr is None:
                raise FabricError("fabric connection closed")
            (length,) = _LEN_PREFIX.unpack(hdr)
            if length > MAX_FRAME_BYTES:
                raise FabricError(f"oversized fabric reply: {length}")
            reply = _read_exact(self._sock, length)
            if reply is None:
                raise FabricError("fabric connection closed mid-reply")
            return reply

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------- client


class FabricClient:
    """Per-replica fabric handle. ``transport`` is any callable mapping
    a request payload to a reply payload — ``hub.handle_payload`` for
    the in-process wiring, a :class:`SocketTransport` for cross-process.

    Tracks the last-observed hub epoch and stamps it on every PUT: a
    client that computed a row before an invalidation landed gets its
    publish rejected (and resyncs from the reply), never poisoning the
    shared store with pre-churn state. Every failure path degrades to a
    local-cache miss — the fabric can slow a cold replica down, never
    break an admission."""

    def __init__(self, transport, name: str = "replica"):
        self._send = transport
        self.name = name
        self.epoch = 0
        self._req_lock = threading.Lock()
        self._req = 0
        self.stats = {"gets": 0, "hits": 0, "misses": 0, "puts": 0,
                      "put_rejected": 0, "invalidations": 0,
                      "errors": 0}
        _CLIENTS.add(self)

    def _next_req(self) -> int:
        with self._req_lock:
            self._req += 1
            return self._req

    def _call(self, payload: bytes) -> tuple[int, bytes]:
        reply = self._send(payload)
        ftype, _, body = decode_payload(reply)
        if ftype == F_ERROR:
            raise FabricError(body.decode("utf-8", "replace"))
        return ftype, body

    def get(self, tier: str, key: bytes) -> bytes | None:
        reg = metrics_mod.registry()
        self.stats["gets"] += 1
        try:
            ftype, body = self._call(
                encode_get(self._next_req(), tier, key))
        except Exception:
            self.stats["errors"] += 1
            return None
        (self.epoch,) = _U64.unpack_from(body, 0)
        if ftype == F_CACHE_MISS:
            self.stats["misses"] += 1
            metrics_mod.record_fabric_lookup(reg, tier, hit=False)
            return None
        self.stats["hits"] += 1
        metrics_mod.record_fabric_lookup(reg, tier, hit=True)
        return bytes(body[_U64.size:])

    def put(self, tier: str, key: bytes, value: bytes) -> bool:
        self.stats["puts"] += 1
        try:
            _, body = self._call(encode_put(
                self._next_req(), self.epoch, tier, key, value))
        except Exception:
            self.stats["errors"] += 1
            return False
        (self.epoch,) = _U64.unpack_from(body, 0)
        stored = bool(body[_U64.size])
        if not stored:
            # stale epoch: the reply resynced us, the NEXT put lands
            self.stats["put_rejected"] += 1
        return stored

    def invalidate(self, tier: str = "", prefix: bytes = b"") -> int:
        self.stats["invalidations"] += 1
        try:
            _, body = self._call(encode_invalidate(
                self._next_req(), tier, prefix))
        except Exception:
            self.stats["errors"] += 1
            return 0
        (self.epoch,) = _U64.unpack_from(body, 0)
        (purged,) = _U32.unpack_from(body, _U64.size)
        return purged

    def sync(self) -> int:
        """Observe the current hub epoch (a miss-GET on a reserved key)
        so a fresh client's first publish isn't sacrificed to the
        stale-epoch guard."""
        self.get("decision", b"\x00sync")
        return self.epoch

    def close(self) -> None:
        close = getattr(self._send, "close", None)
        if close is not None:
            close()


# ----------------------------------------------- content-addressed keys


def policyset_digest(policies) -> str:
    """Replica-stable digest of a policy population: sorted per-policy
    raw-document digests (HostVerdictCache.policy_digest). Replaces the
    per-process generation counter in fabric decision keys."""
    from ..runtime.resourcecache import HostVerdictCache

    pols = list(policies)
    h = hashlib.blake2b(digest_size=16)
    for d in sorted(filter(None, (HostVerdictCache.policy_digest(p)
                                  for p in pols))):
        h.update(d)
    h.update(_U32.pack(len(pols)))
    return h.hexdigest()


_SET_DIGESTS: dict[tuple, str] = {}
_SET_DIGESTS_LOCK = threading.Lock()


def cache_set_digest(policy_cache) -> str:
    """policyset_digest of a PolicyCache, memoized per (cache instance,
    generation) so the admission hot path hashes each population once."""
    gen, pols = policy_cache.snapshot()
    key = (id(policy_cache), gen)
    with _SET_DIGESTS_LOCK:
        hit = _SET_DIGESTS.get(key)
    if hit is not None:
        return hit
    hit = policyset_digest(pols)
    with _SET_DIGESTS_LOCK:
        if len(_SET_DIGESTS) > 64:
            _SET_DIGESTS.clear()
        _SET_DIGESTS[key] = hit
    return hit


def decision_key(policy_cache, ptype, kind: str, namespace: str,
                 resource: dict, env: dict | None = None) -> bytes | None:
    """Fabric key for one admission decision; None when unkeyable
    (non-JSON body — the same skip rule the local caches apply).
    sort_keys canonicalization (unlike the local key's insertion-order
    dump) because replicas may have parsed the body independently."""
    try:
        digest = hashlib.blake2b(
            json.dumps([resource, env], sort_keys=True,
                       separators=(",", ":"),
                       allow_nan=False).encode("utf-8"),
            digest_size=16).hexdigest()
    except (TypeError, ValueError):
        return None
    return "|".join((cache_set_digest(policy_cache), str(int(ptype)),
                     kind, namespace, digest)).encode("utf-8")


def flatten_key(fingerprint: str, digest: bytes) -> bytes:
    return fingerprint.encode("ascii") + b"|" + digest.hex().encode()


def host_key(key: tuple) -> bytes | None:
    """HostVerdictCache key tuple → fabric key bytes."""
    policy_digest, rule_name, body_digest = key
    if policy_digest is None or body_digest is None:
        return None
    return b"|".join((policy_digest.hex().encode(),
                      rule_name.encode("utf-8"),
                      body_digest.hex().encode()))


# -------------------------------------------------------- value codecs


def encode_decision(status: str, row) -> bytes:
    """(status, [(policy, rule, Verdict, msg), ...]) → JSON bytes."""
    return json.dumps(
        {"s": status,
         "r": [[p, r, int(v), m] for (p, r, v, m) in row]},
        separators=(",", ":")).encode("utf-8")


def decode_decision(blob: bytes):
    from ..models import Verdict

    doc = json.loads(blob)
    return doc["s"], [(p, r, Verdict(v), m)
                      for (p, r, v, m) in doc["r"]]


def encode_flatten_row(row) -> bytes:
    from ..models.flatten import encode_packed_row

    return encode_packed_row(row)


def decode_flatten_row(blob: bytes):
    from ..models.flatten import decode_packed_row

    row, _ = decode_packed_row(blob)
    return row


def encode_host_verdict(verdict, message: str, ttl_s: float) -> bytes:
    """Host-tier value carries an absolute wall-clock expiry, not the
    raw TTL: a context-dependent verdict (2s window) published at T must
    read as expired on any replica at T+2 no matter when it was fetched.
    Wall clock because monotonic clocks don't compare across processes;
    replicas share a host (or NTP) and the skew is far under the pure
    TTL, while the short context TTL erring stale-side only costs a
    re-resolve."""
    import time as _time

    return json.dumps({"v": int(verdict), "m": message,
                       "exp": _time.time() + ttl_s},
                      separators=(",", ":")).encode("utf-8")


def decode_host_verdict(blob: bytes):
    """→ (verdict, message, remaining_ttl_s); remaining <= 0 = expired
    (treat as a miss)."""
    import time as _time

    from ..models import Verdict

    doc = json.loads(blob)
    return Verdict(doc["v"]), doc["m"], float(doc["exp"]) - _time.time()


# ------------------------------------------------- batcher integration


def decision_fabric_get(batcher, ptype, kind: str, namespace: str,
                        resource: dict, env: dict | None):
    """Read-through for the batcher's decision cache: (status, row) on
    a cross-replica hit, None otherwise. Callers hold no locks."""
    client = getattr(batcher, "_fabric", None)
    if client is None or not fabric_enabled():
        return None
    key = decision_key(batcher.policy_cache, ptype, kind, namespace,
                       resource, env)
    if key is None:
        return None
    blob = client.get("decision", key)
    if blob is None:
        return None
    try:
        return decode_decision(blob)
    except (ValueError, KeyError, TypeError):
        return None


def decision_fabric_put(batcher, ptype, kind: str, namespace: str,
                        resource: dict, env: dict | None, status,
                        row) -> None:
    client = getattr(batcher, "_fabric", None)
    if client is None or not fabric_enabled():
        return
    key = decision_key(batcher.policy_cache, ptype, kind, namespace,
                       resource, env)
    if key is None:
        return
    try:
        client.put("decision", key, encode_decision(status, row))
    except Exception:
        pass


def publish_policy_change(client, event: str, policy) -> None:
    """Policy churn on this replica purges the fabric everywhere: the
    decision tier wholesale (its keys embed the set digest — stale rows
    are unreachable anyway, but orphaned memory and the epoch bump both
    matter) and the host tier (an edited policy's old-digest rows)."""
    if client is None or not fabric_enabled():
        return
    client.invalidate("decision")
    client.invalidate("host")


def publish_refresh(client, refresh: dict | None) -> None:
    """IncrementalCompiler refresh receipt → fabric invalidation. A
    refresh that recompiled or dropped segments may have moved the
    dictionary (new flatten fingerprint) and retired policy content;
    purge all three tiers. A pure-reuse refresh purges nothing."""
    if client is None or not fabric_enabled():
        return
    refresh = refresh or {}
    if refresh.get("recompiled_keys") or refresh.get("dropped_keys"):
        client.invalidate("")


def attach_stack(stack: dict, client: FabricClient) -> None:
    """Wire one replica's serving stack (workload/replay.build_stack
    shape) onto a fabric client: the batcher's decision cache and row
    memo, the scanner, and the process host-verdict memo all gain
    read-through. With KTPU_FABRIC off every hook is dormant."""
    batcher = stack.get("batcher")
    if batcher is not None:
        batcher._fabric = client
        batcher._row_cache.attach_fabric(client)
    scanner = stack.get("scanner")
    if scanner is not None:
        scanner._fabric = client
    from ..runtime.hostlane import host_cache

    host_cache().attach_fabric(client)


# ------------------------------------------------------------ inventory

_HUBS: "weakref.WeakSet[FabricHub]" = weakref.WeakSet()
_CLIENTS: "weakref.WeakSet[FabricClient]" = weakref.WeakSet()


def health_snapshot() -> dict:
    """The /healthz ``fleet`` block: switch state plus per-hub and
    per-client counters for everything alive in this process."""
    out: dict = {"enabled": fabric_enabled(),
                 "transport": transport_preference()}
    hubs = [h.snapshot() for h in list(_HUBS)]
    clients = [{"name": c.name, "epoch": c.epoch, **dict(c.stats)}
               for c in list(_CLIENTS)]
    if hubs:
        out["hubs"] = hubs
    if clients:
        out["clients"] = clients
    try:
        from . import scanparts

        parts = scanparts.coordinator_snapshots()
        if parts:
            out["scan_partitions"] = parts
    except Exception:
        pass
    return out
