"""Leader election over a Lease object.

Mirrors kyverno/pkg/leaderelection/leaderelection.go (client-go
lease-based election; 15s lease / 10s renew deadline): replicas race to
acquire/renew a coordination.k8s.io Lease through the client; the holder
runs the leader-only controllers (background scan, generate controller,
webhook registration), everyone serves webhooks.

One elector can guard *multiple named leases* (the JAX package's
fleet plane uses this for per-partition scan-range ownership; the port
has no fleet plane yet): the constructor ``name``
is the primary lease — ``is_leader()``/``on_started_leading``/
``on_stopped_leading`` keep their historical single-lease semantics —
and :meth:`add_lease`/:meth:`drop_lease` enroll secondary names renewed
by the same acquire/renew loop. Secondary transitions are reported
through ``on_lease_acquired(name)``/``on_lease_lost(name)`` (which also
fire for the primary, after the legacy callbacks).
"""

from __future__ import annotations

import threading
import time
import uuid

LEASE_DURATION_S = 15.0
RENEW_DEADLINE_S = 10.0
RETRY_PERIOD_S = 2.0


class LeaderElector:
    def __init__(self, client, name: str = "kyverno", namespace: str = "kyverno",
                 identity: str | None = None,
                 on_started_leading=None, on_stopped_leading=None,
                 on_lease_acquired=None, on_lease_lost=None):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{name}-{uuid.uuid4().hex[:8]}"
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.on_lease_acquired = on_lease_acquired
        self.on_lease_lost = on_lease_lost
        self._leading = False
        self._names: set[str] = {name}
        self._held: set[str] = set()
        self._names_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------- lease roster

    def add_lease(self, name: str) -> None:
        """Enroll a secondary named lease; the next election round (and
        every one after) tries to acquire/renew it."""
        with self._names_lock:
            self._names.add(name)

    def drop_lease(self, name: str, release: bool = True) -> None:
        """Stop renewing a named lease. ``release`` clears our holder
        identity so another replica can take it immediately instead of
        waiting out the lease duration. The primary lease cannot be
        dropped — stop() the elector instead."""
        if name == self.name:
            raise ValueError("cannot drop the primary lease; use stop()")
        with self._names_lock:
            self._names.discard(name)
            held = name in self._held
            self._held.discard(name)
        if held:
            if release:
                self._release(name)
            if self.on_lease_lost:
                self.on_lease_lost(name)

    def held(self) -> frozenset:
        """Names of every lease this elector currently holds."""
        with self._names_lock:
            return frozenset(self._held)

    def is_leader(self, name: str | None = None) -> bool:
        if name is None:
            return self._leading
        with self._names_lock:
            return name in self._held

    # --------------------------------------------------------- one round

    def _lease(self, name: str | None = None) -> dict | None:
        return self.client.get_resource(
            "coordination.k8s.io/v1", "Lease", self.namespace,
            name or self.name)

    def try_acquire_or_renew(self) -> bool:
        """One election round over every enrolled lease; returns primary
        leadership (the historical contract)."""
        with self._names_lock:
            names = sorted(self._names)
        now = time.time()
        for name in names:
            try:
                self._try_one(name, now)
            except Exception:
                self._transition(name, False)
        return self._leading

    def _try_one(self, name: str, now: float) -> bool:
        """One acquire/renew attempt for one named lease.

        Updates are compare-and-swap: the observed resourceVersion rides
        along and a Conflict means another replica won the race — treat it
        as a lost election (client-go's resourceVersion-guarded lease
        update semantics), then confirm holdership by re-reading.
        """
        from .client import ConflictError

        lease = self._lease(name)
        if lease is None:
            try:
                self.client.create_resource({
                    "apiVersion": "coordination.k8s.io/v1",
                    "kind": "Lease",
                    "metadata": {"name": name, "namespace": self.namespace},
                    "spec": {
                        "holderIdentity": self.identity,
                        "leaseDurationSeconds": int(LEASE_DURATION_S),
                        "renewTime": now,
                    },
                })
            except ConflictError:
                # another replica created the lease first; re-read to
                # confirm holdership (it may still be us on a retry race)
                lease = self._lease(name)
                holder = ((lease or {}).get("spec") or {}).get(
                    "holderIdentity", "")
                return self._transition(name, holder == self.identity)
            return self._transition(name, True)

        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity", "")
        renew_time = float(spec.get("renewTime") or 0)
        expired = now - renew_time > LEASE_DURATION_S

        if holder == self.identity or expired or not holder:
            spec["holderIdentity"] = self.identity
            spec["renewTime"] = now
            lease["spec"] = spec
            try:
                # carries the observed metadata.resourceVersion -> CAS; a
                # successful guarded write proves holdership, no re-read
                self.client.update_resource(lease)
            except ConflictError:
                return self._transition(name, False)
            return self._transition(name, True)
        return self._transition(name, False)

    def _transition(self, name: str, leading: bool) -> bool:
        with self._names_lock:
            was = name in self._held
            if leading:
                self._held.add(name)
            else:
                self._held.discard(name)
        if leading and not was:
            if name == self.name:
                self._leading = True
                if self.on_started_leading:
                    self.on_started_leading()
            if self.on_lease_acquired:
                self.on_lease_acquired(name)
        elif not leading and was:
            if name == self.name:
                self._leading = False
                if self.on_stopped_leading:
                    self.on_stopped_leading()
            if self.on_lease_lost:
                self.on_lease_lost(name)
        return leading

    def _demote_all(self) -> None:
        for name in list(self.held()):
            self._transition(name, False)

    def run(self, retry_period_s: float = RETRY_PERIOD_S) -> None:
        def loop():
            while not self._stop.wait(retry_period_s):
                try:
                    self.try_acquire_or_renew()
                except Exception:
                    self._demote_all()

        self.try_acquire_or_renew()
        self._thread = threading.Thread(target=loop, name="leader-elector", daemon=True)
        self._thread.start()

    def _release(self, name: str) -> None:
        """Clear our holder identity from one lease (best-effort CAS)."""
        from .client import ConflictError

        lease = self._lease(name)
        if lease is not None and (lease.get("spec") or {}).get(
            "holderIdentity"
        ) == self.identity:
            lease["spec"]["holderIdentity"] = ""
            try:
                self.client.update_resource(lease)
            except ConflictError:
                pass  # someone else already took the lease

    def stop(self) -> None:
        self._stop.set()
        for name in list(self.held()):
            self._release(name)
            self._transition(name, False)
