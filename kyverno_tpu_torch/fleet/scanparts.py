"""Leader-partitioned background scanning.

A fleet of replicas splits the cluster snapshot into
``KTPU_SCAN_PARTITIONS`` namespace-hash shard ranges. Coordination is
pure named leases on the existing :class:`LeaderElector`:

* every member renews a heartbeat lease ``ktpu-scan-member-<id>`` —
  membership *is* the set of unexpired member leases, no separate
  registry;
* the replica holding ``ktpu-scan-leader`` computes the rendezvous
  assignment of partition → member from that roster and publishes it in
  the ConfigMap ``ktpu-scan-assignment``;
* each member enrolls a lease ``ktpu-scan-part-<i>`` for every
  partition assigned to it and releases the ones reassigned away.

Takeover needs no extra machinery: a dead replica stops renewing, its
member lease expires, the leader's next tick reassigns its partitions,
and the survivors' part-leases acquire because the orphaned ones have
expired (or were never contested). Followers scan only their owned
ranges (:func:`partition_resources`) and publish per-range
verdict-matrix digests (:func:`matrix_range_digests`); equality of the
merged range set against an unpartitioned scan's digest is the parity
gate of chip_smoke.py's ``[fleet]`` phase.
"""

from __future__ import annotations

import hashlib
import threading
import uuid
import weakref

from ..runtime import featureplane
from ..runtime import metrics as metrics_mod
from ..runtime.leaderelection import LeaderElector

LEADER_LEASE = "ktpu-scan-leader"
MEMBER_LEASE_PREFIX = "ktpu-scan-member-"
PART_LEASE_PREFIX = "ktpu-scan-part-"
ASSIGNMENT_CONFIGMAP = "ktpu-scan-assignment"

_COORDINATORS: "weakref.WeakSet[FleetScanCoordinator]" = weakref.WeakSet()


def scan_partition_count() -> int:
    """Declared partition count; 0 = unpartitioned scan (the default)."""
    if not featureplane.is_set("KTPU_SCAN_PARTITIONS"):
        return 0
    return max(0, featureplane.int_value("KTPU_SCAN_PARTITIONS"))


def partition_of(namespace: str, n_partitions: int) -> int:
    """Stable namespace → shard mapping (blake2b, replica-independent).
    Cluster-scoped resources (empty namespace) hash like any other
    value so they land in exactly one partition."""
    if n_partitions <= 1:
        return 0
    h = hashlib.blake2b(namespace.encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big") % n_partitions


def partition_resources(resources, owned, n_partitions: int) -> list:
    """The slice of a snapshot this replica scans: resources whose
    namespace partition is in ``owned``."""
    owned = set(owned)
    return [r for r in resources
            if partition_of((r.get("metadata") or {}).get("namespace", ""),
                            n_partitions) in owned]


def assign_partitions(members, n_partitions: int) -> dict[str, list[int]]:
    """Rendezvous assignment partition → member: each partition goes to
    the member with the highest blake2b(member, partition) score, so a
    join/leave only moves the partitions the changed member would have
    won — the stability property tests/test_torch_fleet.py pins."""
    members = sorted(set(members))
    out: dict[str, list[int]] = {m: [] for m in members}
    if not members:
        return out
    for part in range(n_partitions):
        tag = str(part).encode("utf-8")

        def score(member: str) -> bytes:
            return hashlib.blake2b(
                member.encode("utf-8") + b"\x00" + tag,
                digest_size=8).digest()

        out[max(members, key=score)].append(part)
    return out


# ------------------------------------------------------- range digests

def matrix_range_digests(scanner, n_partitions: int,
                         owned=None) -> dict[int, str]:
    """Per-partition digests of the scanner's persisted verdict matrix:
    sha256 over the sorted ``kind/ns/name:policy:rule=verdict`` lines of
    each range. Merged across replicas (each contributing its owned
    ranges) these must reproduce an unpartitioned scan's full range set
    bit-for-bit."""
    snap = scanner.verdict_matrix()
    if snap is None:
        return {}
    keys, ckeys, mat = snap
    lines: dict[int, list[bytes]] = {}
    for i, (kind, ns, name) in enumerate(keys):
        part = partition_of(ns, n_partitions)
        if owned is not None and part not in owned:
            continue
        for j, ck in enumerate(ckeys):
            lines.setdefault(part, []).append(
                f"{kind}/{ns}/{name}:{ck}={int(mat[i, j])}".encode())
        if not ckeys:
            lines.setdefault(part, []).append(
                f"{kind}/{ns}/{name}:".encode())
    out: dict[int, str] = {}
    for part, rows in lines.items():
        h = hashlib.sha256()
        for row in sorted(rows):
            h.update(row)
            h.update(b"\n")
        out[part] = h.hexdigest()[:16]
    return out


def merge_range_digests(*digest_maps) -> str:
    """Fleet-level digest over the union of per-range digests. Raises if
    two replicas publish different digests for the same range — split
    ownership means the partition protocol failed."""
    merged: dict[int, str] = {}
    for dm in digest_maps:
        for part, digest in dm.items():
            if part in merged and merged[part] != digest:
                raise ValueError(
                    f"range {part} has conflicting digests "
                    f"{merged[part]} != {digest}")
            merged[part] = digest
    h = hashlib.sha256()
    for part in sorted(merged):
        h.update(f"{part}={merged[part]}".encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


def scan_partitions(scanner, resources, owned, n_partitions: int):
    """Scan this replica's owned ranges only and publish the per-range
    row gauge. Returns (ScanResult, per-range digests)."""
    mine = partition_resources(resources, owned, n_partitions)
    result = scanner.scan(mine)
    reg = metrics_mod.registry()
    counts: dict[int, int] = {p: 0 for p in owned}
    for r in mine:
        counts[partition_of((r.get("metadata") or {}).get("namespace", ""),
                            n_partitions)] += 1
    for part, rows in counts.items():
        metrics_mod.record_scan_partition_rows(reg, part, rows)
    return result, matrix_range_digests(scanner, n_partitions, owned=owned)


# --------------------------------------------------------- coordinator

class FleetScanCoordinator:
    """One replica's view of the partition protocol. ``tick()`` is one
    deterministic round (election + assignment + lease reconciliation);
    production callers loop it on the elector's retry period, tests
    step it by hand."""

    def __init__(self, client, identity: str | None = None,
                 n_partitions: int | None = None,
                 namespace: str = "kyverno"):
        self.client = client
        self.identity = identity or f"replica-{uuid.uuid4().hex[:8]}"
        self.n_partitions = (n_partitions if n_partitions is not None
                             else scan_partition_count())
        self.namespace = namespace
        self._lock = threading.Lock()
        self._assignment: dict[str, list[int]] = {}
        self.stats = {"ticks": 0, "assignments_published": 0,
                      "parts_acquired": 0, "parts_released": 0}
        self.elector = LeaderElector(
            client, name=LEADER_LEASE, namespace=namespace,
            identity=self.identity,
            on_lease_acquired=self._on_lease_acquired,
            on_lease_lost=self._on_lease_lost)
        self.elector.add_lease(MEMBER_LEASE_PREFIX + self.identity)
        _COORDINATORS.add(self)

    # lease-event bookkeeping only; ownership truth stays in elector.held()
    def _on_lease_acquired(self, name: str) -> None:
        if name.startswith(PART_LEASE_PREFIX):
            with self._lock:
                self.stats["parts_acquired"] += 1

    def _on_lease_lost(self, name: str) -> None:
        if name.startswith(PART_LEASE_PREFIX):
            with self._lock:
                self.stats["parts_released"] += 1

    # ------------------------------------------------------------ roster

    def _live_members(self, now: float) -> list[str]:
        """Membership = unexpired ``ktpu-scan-member-*`` leases."""
        from ..runtime.leaderelection import LEASE_DURATION_S

        members = []
        for lease in self.client.list_resource(
                "coordination.k8s.io/v1", "Lease", self.namespace):
            name = (lease.get("metadata") or {}).get("name", "")
            if not name.startswith(MEMBER_LEASE_PREFIX):
                continue
            spec = lease.get("spec") or {}
            if not spec.get("holderIdentity"):
                continue
            if now - float(spec.get("renewTime") or 0) > LEASE_DURATION_S:
                continue
            members.append(name[len(MEMBER_LEASE_PREFIX):])
        return sorted(members)

    def _publish_assignment(self, assignment: dict[str, list[int]]) -> None:
        from ..runtime.client import ConflictError

        body = {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": ASSIGNMENT_CONFIGMAP,
                             "namespace": self.namespace},
                "data": {"assignment": "|".join(
                    f"{m}:{','.join(map(str, parts))}"
                    for m, parts in sorted(assignment.items()) if parts),
                    "partitions": str(self.n_partitions)}}
        existing = self.client.get_configmap(self.namespace,
                                             ASSIGNMENT_CONFIGMAP)
        try:
            if existing is None:
                self.client.create_resource(body)
            elif existing.get("data") != body["data"]:
                existing["data"] = body["data"]
                self.client.update_resource(existing)
            else:
                return
        except ConflictError:
            return  # another leader epoch won the write; next tick re-reads
        with self._lock:
            self.stats["assignments_published"] += 1

    def _read_assignment(self) -> dict[str, list[int]]:
        cm = self.client.get_configmap(self.namespace, ASSIGNMENT_CONFIGMAP)
        raw = ((cm or {}).get("data") or {}).get("assignment", "")
        out: dict[str, list[int]] = {}
        for chunk in filter(None, raw.split("|")):
            member, _, parts = chunk.partition(":")
            out[member] = [int(p) for p in parts.split(",") if p]
        return out

    # -------------------------------------------------------------- tick

    def tick(self) -> None:
        """One protocol round: renew leases, (leader) recompute and
        publish the assignment from the live-member roster, reconcile
        our enrolled part-leases with the published assignment."""
        import time as _time

        with self._lock:
            self.stats["ticks"] += 1
        self.elector.try_acquire_or_renew()
        now = _time.time()

        if self.elector.is_leader():
            members = self._live_members(now)
            if members:
                self._publish_assignment(
                    assign_partitions(members, self.n_partitions))

        assignment = self._read_assignment()
        with self._lock:
            self._assignment = assignment
        want = {PART_LEASE_PREFIX + str(p)
                for p in assignment.get(self.identity, ())}
        enrolled = {n for n in self.elector._names
                    if n.startswith(PART_LEASE_PREFIX)}
        for name in sorted(want - enrolled):
            self.elector.add_lease(name)
        for name in sorted(enrolled - want):
            # release so the reassigned owner acquires immediately
            self.elector.drop_lease(name, release=True)
        if want - enrolled:
            # acquire newly-enrolled part leases in the same round —
            # takeover completes in one tick after reassignment
            self.elector.try_acquire_or_renew()

    def owned_partitions(self) -> list[int]:
        """Partitions whose part-lease this replica currently holds —
        the ranges it is entitled to scan."""
        return sorted(int(n[len(PART_LEASE_PREFIX):])
                      for n in self.elector.held()
                      if n.startswith(PART_LEASE_PREFIX))

    def stop(self) -> None:
        self.elector.stop()

    def snapshot(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
            assignment = {m: list(p) for m, p in self._assignment.items()}
        return {"identity": self.identity,
                "n_partitions": self.n_partitions,
                "leader": self.elector.is_leader(),
                "owned": self.owned_partitions(),
                "assignment": assignment,
                **stats}


def coordinator_snapshots() -> list[dict]:
    """Live coordinator snapshots for /healthz's fleet block."""
    return [c.snapshot() for c in list(_COORDINATORS)]
