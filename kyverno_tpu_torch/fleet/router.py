"""Replica pool router: the streaming plane's multi-replica front door.

One :class:`ReplicaRouter` holds the replica pool and answers one
question per admission: *which replica serves this frame, and what
happens when it doesn't*. Routing is rendezvous (highest-random-weight)
hashing of the resource's content digest over the replica names — the
same digest the fabric keys on, so repeated bodies land on the replica
whose local caches are already warm (cache affinity), and a replica
join/leave moves only the ~1/N of digests that scored it highest
(partition-map stability, asserted in tests/test_torch_fleet.py).

Failure handling mirrors the host lane's protection plan
(``sloactions.PoolCircuit``): a per-replica circuit breaker opens after
``breaker_threshold`` consecutive failures, cools down, then admits one
half-open probe; while open (or while the replica's ``/healthz`` self
reports ``degraded``) the router fails over to the next replica in
rendezvous order with bounded retries and linear backoff. Exhausting
the candidate list raises :class:`RouterExhausted` — the caller's
admission fails closed exactly like a single replica being down.
"""

from __future__ import annotations

import hashlib
import threading
import time

from ..runtime import metrics as metrics_mod
from ..runtime.stream_server import F_ERROR, decode_payload


class RouterExhausted(RuntimeError):
    """Every candidate replica failed (or was breaker-rejected)."""


class ReplicaBreaker:
    """Per-replica circuit breaker: closed (flows) → open (rejected, a
    cooldown long) → half-open (exactly one probe; success closes,
    failure re-opens). Self-contained clone of the PoolCircuit state
    machine without its feature-plane gating — the router is only ever
    constructed by fleet-aware callers."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 0.25,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self.stats = {"opened": 0, "closed": 0, "probes": 0,
                      "rejected": 0, "failures": 0}

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    self.stats["probes"] += 1
                    return True
                self.stats["rejected"] += 1
                return False
            # half_open: one probe owns the lane
            self.stats["rejected"] += 1
            return False

    def record(self, ok: bool) -> None:
        with self._lock:
            if ok:
                if self.state != "closed":
                    self.stats["closed"] += 1
                self.state = "closed"
                self._failures = 0
                return
            self.stats["failures"] += 1
            self._failures += 1
            if (self.state == "half_open"
                    or self._failures >= self.threshold):
                self.state = "open"
                self._opened_at = self._clock()
                self._failures = 0
                self.stats["opened"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self._failures,
                    **dict(self.stats)}


class Replica:
    """One pool member: a name (the rendezvous identity), a ``submit``
    callable (request payload → reply payload; in-process this is
    ``StreamAdmissionPlane.handle_payload`` partial-applied with the
    peer tag, cross-process a StreamClient send), and an optional
    ``healthz`` callable returning the replica's /healthz dict."""

    def __init__(self, name: str, submit, healthz=None):
        self.name = name
        self.submit = submit
        self.healthz = healthz


def rendezvous_rank(names, digest: bytes) -> list[str]:
    """Replica names ordered by highest-random-weight score for one
    resource digest. Deterministic across processes (blake2b, no seed)."""
    def score(name: str) -> bytes:
        return hashlib.blake2b(name.encode("utf-8") + b"\x00" + digest,
                               digest_size=8).digest()

    return sorted(names, key=score, reverse=True)


class ReplicaRouter:
    def __init__(self, replicas=(), retries: int | None = None,
                 backoff_s: float = 0.005, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 0.25,
                 health_ttl_s: float = 0.25):
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._breakers: dict[str, ReplicaBreaker] = {}
        # name -> (stamp, healthy) memo so the health watch doesn't
        # pay a /healthz round-trip per admission
        self._health: dict[str, tuple[float, bool]] = {}
        self.retries = retries
        self.backoff_s = backoff_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.health_ttl_s = health_ttl_s
        self.stats = {"routed": 0, "failovers": 0, "rejected": 0,
                      "errors": 0, "exhausted": 0}
        for r in replicas:
            self.add(r)

    # ------------------------------------------------------- membership

    def add(self, replica: Replica) -> None:
        with self._lock:
            self._replicas[replica.name] = replica
            self._breakers[replica.name] = ReplicaBreaker(
                self.breaker_threshold, self.breaker_cooldown_s)
            self._health.pop(replica.name, None)

    def remove(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)
            self._breakers.pop(name, None)
            self._health.pop(name, None)

    def members(self) -> list[str]:
        with self._lock:
            return sorted(self._replicas)

    # ---------------------------------------------------------- routing

    def rank(self, digest: bytes) -> list[str]:
        return rendezvous_rank(self.members(), digest)

    def route(self, digest: bytes) -> str:
        """The replica this digest homes on, health/breaker-adjusted:
        first candidate in rendezvous order that is breaker-closed and
        not self-reporting degraded, else the raw rendezvous winner."""
        order = self.rank(digest)
        if not order:
            raise RouterExhausted("empty replica pool")
        for name in order:
            if self._admittable(name):
                return name
        return order[0]

    def _admittable(self, name: str) -> bool:
        with self._lock:
            breaker = self._breakers.get(name)
        if breaker is None or breaker.state == "open":
            return False
        return self._healthy(name)

    def _healthy(self, name: str) -> bool:
        """SLO health per the replica's own /healthz (memoized a TTL):
        a replica that answers ``status: degraded`` is deprioritized —
        still a last resort, never a first pick."""
        with self._lock:
            replica = self._replicas.get(name)
            memo = self._health.get(name)
        if replica is None:
            return False
        if replica.healthz is None:
            return True
        now = time.monotonic()
        if memo is not None and now - memo[0] < self.health_ttl_s:
            return memo[1]
        try:
            doc = replica.healthz() or {}
            healthy = doc.get("status", "ok") != "degraded"
        except Exception:
            healthy = False
        with self._lock:
            self._health[name] = (now, healthy)
        return healthy

    # ----------------------------------------------------------- submit

    def submit(self, digest: bytes, payload: bytes) -> bytes:
        """Send one admission frame to the pool: rendezvous-ordered
        candidates, breaker-gated, bounded retry with linear backoff on
        failure. An F_ERROR reply counts as a replica failure (the
        frame is replayable — admission requests are idempotent reads
        of policy state) and fails over like a transport error."""
        reg = metrics_mod.registry()
        order = self.rank(digest)
        if not order:
            raise RouterExhausted("empty replica pool")
        # degraded replicas sort after healthy ones instead of dropping
        # out: with every replica degraded the pool must still answer
        order.sort(key=lambda n: not self._admittable(n))
        attempts = (self.retries + 1 if self.retries is not None
                    else len(order))
        last_err: Exception | None = None
        tried = 0
        for name in order:
            if tried >= attempts:
                break
            with self._lock:
                replica = self._replicas.get(name)
                breaker = self._breakers.get(name)
            if replica is None or breaker is None:
                continue
            if not breaker.allow():
                with self._lock:
                    self.stats["rejected"] += 1
                continue
            if tried:
                time.sleep(self.backoff_s * tried)
            tried += 1
            try:
                reply = replica.submit(payload)
                ftype, _, body = decode_payload(reply)
                if ftype == F_ERROR:
                    raise RuntimeError(
                        body.decode("utf-8", "replace") or "F_ERROR")
                breaker.record(True)
                with self._lock:
                    self.stats["routed"] += 1
                return reply
            except Exception as e:
                last_err = e
                breaker.record(False)
                with self._lock:
                    self.stats["errors"] += 1
                    self.stats["failovers"] += 1
                metrics_mod.record_fabric_failover(reg, name)
        with self._lock:
            self.stats["exhausted"] += 1
        raise RouterExhausted(
            f"no replica served the frame (tried {tried}): {last_err!r}")

    def snapshot(self) -> dict:
        with self._lock:
            return {"members": sorted(self._replicas),
                    "breakers": {n: b.snapshot()
                                 for n, b in self._breakers.items()},
                    **dict(self.stats)}
