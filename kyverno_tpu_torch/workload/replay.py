"""Replay harness: feed a WorkloadTrace through the live admission legs.

One trace, five legs over the same compiled policy population:

``webhook``
    In-process ``WebhookServer.handle`` with a full AdmissionReview per
    event — the JSON parse + flatten + re-intern production path.
``stream_json`` / ``stream_row`` / ``stream_block``
    The streaming frame protocol through
    :class:`~..runtime.stream_server.StreamAdmissionPlane` — JSON frames
    route back through the webhook handler, ROW/BLOCK frames carry
    pre-tokenized columnar payloads into the continuous batcher.
``background``
    Trace events become a watch stream: a trace-backed client feeds
    ``runtime/watch.Reflector`` (list + watch, resourceVersion resume),
    events fan into ``BackgroundScanner.note_resource`` and delta scans
    run at every POLICY boundary and at end of trace.

Scheduling reuses bench config 9's open-loop shape: a dispatcher thread
releases events on the trace clock (``speed=1.0`` arrival-faithful,
``None`` max speed) into a ``runtime/workqueue.WorkerQueue`` whose
depth is sampled at every release, so server backlog shows up as
latency-from-scheduled-arrival and queue depth — never as a slower
arrival process. Per-leg capture: verdict per event (digested for
cross-leg parity), latency percentiles, queue depth, and the final
failing-resource set; :func:`run_manifest` persists the whole run for
A/B diffing across changes. Injection is gated on KTPU_REPLAY.

The stacks run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no CPU request :func:`build_stack` raises.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time

from ..runtime import featureplane
from ..runtime import metrics as metrics_mod
from ..runtime.policycache import PolicyType
from ..runtime.workqueue import WorkerQueue

# v2: manifests carry an "slo" block (degradation controller state,
# action log, shed set) and diff_manifests refuses to compare silently.
# v3: a "topology" block (replica count, fabric switch state, scan
# partition map) — a 3-replica fleet run and a single-replica run are
# different systems, and diff_manifests flags them incomparable.
MANIFEST_SCHEMA_VERSION = 3

LEGS = ("webhook", "stream_json", "stream_row", "stream_block",
        "background", "fleet_stream")

_ADMISSION_LEGS = ("webhook", "stream_json", "stream_row", "stream_block")


class ReplayDisabled(RuntimeError):
    """KTPU_REPLAY=0: the harness must not inject traffic."""


def build_stack(policies, continuous: bool = True,
                result_cache_ttl_s: float = 0.0, device=None):
    """The config-9 in-process serving stack, packaged for replay
    callers (chip_smoke.py, tests): PolicyCache + AdmissionBatcher
    + WebhookServer + StreamAdmissionPlane + BackgroundScanner, all
    over one compiled population on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``). Release it with :func:`stop_stack`."""
    from ..models.engine import resolve_device
    from ..runtime.batch import AdmissionBatcher
    from ..runtime.background import BackgroundScanner
    from ..runtime.client import FakeCluster
    from ..runtime.policycache import PolicyCache
    from ..runtime.stream_server import StreamAdmissionPlane
    from ..runtime.webhook import WebhookServer

    device = resolve_device(device)
    cache = PolicyCache(device=device)
    for p in policies:
        cache.add(p)
    batcher = AdmissionBatcher(cache, window_s=0.004, burst_threshold=1,
                               dispatch_cost_init_s=0.0,
                               oracle_cost_init_s=1.0,
                               cold_flush_fallback=False,
                               result_cache_ttl_s=result_cache_ttl_s,
                               continuous=continuous)
    webhook = WebhookServer(policy_cache=cache, client=FakeCluster(),
                            admission_batcher=batcher, device=device)
    plane = StreamAdmissionPlane(webhook, batcher, cache)
    scanner = BackgroundScanner(policies, device=device)
    return {"policy_cache": cache, "batcher": batcher, "webhook": webhook,
            "plane": plane, "scanner": scanner}


def stop_stack(stack: dict) -> None:
    """Release one :func:`build_stack` stack: its batcher, and its
    webhook with the oracle pool the webhook spawned. The pool is
    detached from the process-wide host lane if it is the one attached
    there, so later stacks never route to stopped workers."""
    from ..runtime import hostlane

    stack["batcher"].stop()
    webhook = stack["webhook"]
    webhook.stop()
    resolver = hostlane.resolver()
    if resolver._pool is webhook.oracle_pool:
        resolver.attach_pool(None, None)


def build_fleet_stacks(policies, replicas: int = 2,
                       result_cache_ttl_s: float = 60.0,
                       continuous: bool = True, device=None) -> dict:
    """N in-process serving stacks sharing one verdict fabric hub, plus
    a digest-affinity router over their streaming planes — the
    multi-replica replay leg's topology. Each replica is a full
    :func:`build_stack` (own PolicyCache/batcher/scanner) with a
    :class:`~..fleet.fabric.FabricClient` attached; the hub is the only
    shared state, exactly the deployment shape.

    Returns ``{"hub", "server", "stacks", "clients", "router",
    "replicas"}``. ``KTPU_FABRIC_TRANSPORT=socket`` runs the hub behind
    a loopback :class:`~..fleet.fabric.FabricSocketServer` with one
    framed connection per replica (the cross-process deployment shape);
    the default ``inproc`` wires clients straight to
    ``hub.handle_payload``. With KTPU_FABRIC off the clients are
    attached but dormant — the router still spreads load, the caches
    just never meet (the kill-switch parity leg in
    chip_smoke.py's ``[fleet]`` phase runs exactly that). Every replica
    runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    from ..fleet.fabric import (FabricClient, FabricHub,
                                FabricSocketServer, SocketTransport,
                                attach_stack, transport_preference)
    from ..fleet.router import Replica, ReplicaRouter

    hub = FabricHub()
    server = None
    if transport_preference() == "socket":
        server = FabricSocketServer(hub)
    stacks, clients, members = [], [], []
    for i in range(replicas):
        stack = build_stack(policies, continuous=continuous,
                            result_cache_ttl_s=result_cache_ttl_s,
                            device=device)
        transport = (SocketTransport(server.host, server.port)
                     if server is not None else hub.handle_payload)
        client = FabricClient(transport, name=f"replica-{i}")
        client.sync()
        attach_stack(stack, client)
        stacks.append(stack)
        clients.append(client)
        members.append(Replica(
            f"replica-{i}",
            lambda payload, plane=stack["plane"]: plane.handle_payload(
                payload, "fleet")))
    return {"hub": hub, "server": server, "stacks": stacks,
            "clients": clients, "router": ReplicaRouter(members),
            "replicas": replicas}


def stop_fleet_stacks(fleet: dict) -> None:
    """Release a :func:`build_fleet_stacks` fleet: every replica's stack,
    the clients (detached from the process-wide host-verdict memo, which
    ``attach_stack`` wired to the last of them) and the socket server."""
    from ..runtime.hostlane import host_cache

    for stack in fleet["stacks"]:
        stop_stack(stack)
    if host_cache().fabric in fleet["clients"]:
        host_cache().attach_fabric(None)
    for client in fleet["clients"]:
        client.close()
    if fleet.get("server") is not None:
        fleet["server"].stop()


def run_fleet(trace, fleet: dict, speed: float | None = None,
              workers: int = 8, affinity: bool = True) -> dict:
    """The multi-replica admission leg: every trace event becomes a
    stream JSON frame routed to its digest-affinity replica through the
    :class:`~..fleet.router.ReplicaRouter` (failover and breakers
    included), verdicts captured exactly like the single-replica
    ``stream_json`` leg so :func:`verdict_digest` compares across
    topologies. Policy-churn events apply to EVERY replica's policy
    cache — a fleet shares the policy plane, and the churn is what
    drives cross-replica fabric invalidation.

    ``affinity=False`` routes by event sequence instead of body digest
    — the no-affinity load-balancer shape, where repeated bodies land
    on different replicas and the shared fabric (not the local caches)
    is what serves the repeats. The verdict digest must not care."""
    from ..api.load import load_policy
    from ..runtime import stream_server as ss

    if not featureplane.enabled("KTPU_REPLAY"):
        raise ReplayDisabled("KTPU_REPLAY=0: replay injection disabled")
    router = fleet["router"]
    reg = metrics_mod.registry()
    lock = threading.Lock()
    verdicts: dict[int, dict] = {}
    lats: list[float] = []
    errors: list[str] = []

    def handle(item):
        arrival, seq, ev, body = item
        try:
            frame = ss.encode_json_frame(seq, admission_review(
                ev, body, seq))
            route_key = (str(ev.digest) if affinity
                         else f"seq-{seq}").encode("utf-8")
            reply = router.submit(route_key, frame)
            _, out = ss.decode_verdict_frame(reply)
            lat = time.perf_counter() - arrival
            with lock:
                verdicts[seq] = _verdict_summary("stream_json", out)
                lats.append(lat * 1e3)
            metrics_mod.record_replay_latency(reg, "fleet_stream", lat)
        except Exception as exc:
            with lock:
                errors.append(f"{seq}: {exc!r}")
            raise

    wq = WorkerQueue(handle, workers=workers, name="replay-fleet")
    wq.run()
    t0 = time.perf_counter()
    released = 0
    for seq, ev in enumerate(trace.events):
        if ev.op == "POLICY":
            # the policy plane is fleet-wide: drain in-flight admissions
            # (a frame racing the churn could land on either side on
            # different replicas), then land the update everywhere
            wq.drain(timeout=120.0)
            pol = load_policy(trace.body_of(ev))
            for stack in fleet["stacks"]:
                stack["policy_cache"].add(pol)
            continue
        if speed:
            delay = t0 + ev.ts / speed - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        wq.add((time.perf_counter(), seq, ev, trace.body_of(ev)))
        released += 1
    wq.drain(timeout=120.0)
    wq.stop()
    span = max(time.perf_counter() - t0, 1e-9)
    metrics_mod.record_replay_events(reg, "fleet_stream",
                                     n=wq.processed, dropped=wq.dropped)
    lats_sorted = sorted(lats) or [0.0]

    def pct(p: float) -> float:
        return round(lats_sorted[min(len(lats_sorted) - 1,
                                     int(p * len(lats_sorted)))], 3)

    fabric_hits = sum(c.stats["hits"] for c in fleet["clients"])
    fabric_gets = sum(c.stats["gets"] for c in fleet["clients"])
    return {
        "leg": "fleet_stream",
        "speed": speed,
        "replicas": fleet["replicas"],
        "events": released,
        "processed": wq.processed,
        "dropped": wq.dropped,
        "errors": errors[:8],
        "duration_s": round(span, 4),
        "achieved_per_s": round(wq.processed / span, 1),
        "latency_ms_p50": pct(0.50),
        "latency_ms_p99": pct(0.99),
        "router": router.snapshot(),
        "fabric_hits": fabric_hits,
        "fabric_hit_rate": round(fabric_hits / fabric_gets, 4)
        if fabric_gets else 0.0,
        "hub": fleet["hub"].snapshot(),
        "verdicts": verdicts,
        "verdict_digest": verdict_digest(verdicts),
        "denied": sum(1 for v in verdicts.values()
                      if not v["allowed"]),
    }


def admission_review(ev, body: dict, seq: int) -> dict:
    """AdmissionReview for one trace event (unique uid per event so
    decision caches key honestly)."""
    return {
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {"uid": f"replay-{seq}-{ev.digest}",
                    "kind": {"kind": ev.kind or "Pod"},
                    "namespace": ev.namespace,
                    "operation": ev.op if ev.op != "POLICY" else "CREATE",
                    "object": body},
    }


class _TraceWatchClient:
    """watch.Reflector client backed by a WorkloadTrace: ``list`` primes
    from the pre-trace state (empty), then ``watch_stream`` yields trace
    events as ADDED/MODIFIED/DELETED frames as the harness releases them
    — the churn-through-watch.py leg."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending: list = []
        self._closed = False
        self._rv = 0

    # -- harness side

    def push(self, op: str, obj: dict) -> None:
        ev_type = {"CREATE": "ADDED", "UPDATE": "MODIFIED",
                   "DELETE": "DELETED"}[op]
        with self._cond:
            self._rv += 1
            obj = dict(obj)
            meta = dict(obj.get("metadata") or {})
            meta["resourceVersion"] = str(self._rv)
            obj["metadata"] = meta
            self._pending.append((ev_type, obj))
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- Reflector client contract

    def list_response(self, api_version: str, kind: str,
                      namespace: str = "") -> dict:
        with self._cond:
            return {"items": [],
                    "metadata": {"resourceVersion": str(self._rv)}}

    def watch_stream(self, api_version: str, kind: str,
                     namespace: str = "", resource_version=None,
                     stop=None):
        while True:
            with self._cond:
                while (not self._pending and not self._closed
                       and not (stop is not None and stop.is_set())):
                    self._cond.wait(0.05)
                if self._pending:
                    batch, self._pending = self._pending, []
                else:
                    return
            for ev_type, obj in batch:
                if stop is not None and stop.is_set():
                    return
                yield ev_type, obj


def _verdict_summary(leg: str, out) -> dict:
    """Normalize one leg response to {allowed, detail} so parity digests
    compare across transports."""
    if leg in ("webhook", "stream_json"):
        resp = (out or {}).get("response") or {}
        msg = ((resp.get("status") or {}).get("message") or "")
        return {"allowed": bool(resp.get("allowed", True)),
                "detail": msg}
    # row/block responses: {"status", "allowed", "escalate", "verdicts"}
    return {"allowed": bool((out or {}).get("allowed", True)),
            "detail": (out or {}).get("status", "")}


def verdict_digest(verdicts: dict) -> str:
    """Digest of the per-event allowed stream (sorted by sequence) —
    the cross-leg parity check collapses to string equality."""
    h = hashlib.sha256()
    for seq in sorted(verdicts):
        h.update(f"{seq}:{int(verdicts[seq]['allowed'])};".encode())
    return h.hexdigest()[:16]


class ReplayDriver:
    """Plays one trace through one leg of a serving stack (see
    :func:`build_stack`); construct once per stack, ``run()`` per leg."""

    def __init__(self, webhook=None, batcher=None, policy_cache=None,
                 scanner=None, plane=None,
                 ptype: PolicyType = PolicyType.VALIDATE_ENFORCE):
        self.webhook = webhook
        self.batcher = batcher
        self.policy_cache = policy_cache
        self.scanner = scanner
        self.plane = plane
        self.ptype = ptype
        self.retries = 0
        self._retry_lock = threading.Lock()

    @classmethod
    def from_stack(cls, stack: dict) -> "ReplayDriver":
        return cls(webhook=stack.get("webhook"),
                   batcher=stack.get("batcher"),
                   policy_cache=stack.get("policy_cache"),
                   scanner=stack.get("scanner"),
                   plane=stack.get("plane"))

    # ------------------------------------------------------------- submit

    def _admission_submit(self, leg: str):
        """(submit(ev, body, seq) -> normalized verdict) for one
        admission leg."""
        from ..runtime import stream_server as ss
        from ..runtime.webhook import VALIDATING_WEBHOOK_PATH

        if leg == "webhook":
            def submit(ev, body, seq):
                review = admission_review(ev, body, seq)
                return _verdict_summary(
                    leg, self.webhook.handle(VALIDATING_WEBHOOK_PATH,
                                             review))
            return submit
        if leg == "stream_json":
            def submit(ev, body, seq):
                frame = ss.encode_json_frame(seq, admission_review(
                    ev, body, seq))
                reply = self.plane.handle_payload(frame, "replay")
                _, out = ss.decode_verdict_frame(reply)
                return _verdict_summary(leg, out)
            return submit
        if leg in ("stream_row", "stream_block"):
            # client-side tokenization is serialized: concurrent wire
            # flattens against one compiled set race the dictionary
            # intern (the streaming contract is one tokenizer per
            # client); only handle_payload runs concurrently
            flatten_lock = threading.Lock()

            def submit(ev, body, seq, _block=(leg == "stream_block")):
                kind = ev.kind or "Pod"
                with flatten_lock:
                    cps = self.policy_cache.compiled(self.ptype, kind,
                                                     ev.namespace)
                    if cps is None:
                        return {"allowed": True, "detail": "no-policies"}
                    if _block:
                        block = ss.flatten_block_for_wire(cps, [body])
                        frame = ss.encode_block_frame(seq, kind,
                                                      ev.namespace, block)
                    else:
                        row = ss.flatten_rows_for_wire(cps, [body])[0]
                        frame = ss.encode_row_frame(seq, kind,
                                                    ev.namespace, row)
                # empty-verdict escalation == the batcher's screen
                # deadline fired (or circuit/shape reject) before the
                # row's flush answered — no verdict was computed. The
                # streaming client contract is retry-after-timeout, so
                # the harness resubmits (same frame, no re-flatten) with
                # backoff instead of booking a spurious deny that a
                # parity check would misread as cross-leg verdict drift.
                for attempt in range(4):
                    reply = self.plane.handle_payload(frame, "replay")
                    _, out = ss.decode_verdict_frame(reply)
                    if _block:
                        out = (out.get("rows") or [{}])[0]
                    if not (out.get("escalate")
                            and not out.get("verdicts")):
                        break
                    with self._retry_lock:
                        self.retries += 1
                    time.sleep(0.05 * (attempt + 1))
                return _verdict_summary(leg, out)
            return submit
        raise ValueError(f"unknown replay leg {leg!r}")

    # ---------------------------------------------------------------- run

    def run(self, trace, leg: str, speed: float | None = None,
            workers: int = 8, max_queued: int = 0,
            warmup: bool | None = None) -> dict:
        """Replay ``trace`` through ``leg``. ``speed=None`` is max speed
        (events release as fast as the dispatcher loops); ``speed=1.0``
        honors trace arrival times; ``2.0`` plays twice as fast.

        ``warmup`` plays the trace once uncaptured before the measured
        pass — the config-9 "warm off the clock" idiom. It defaults on
        for the columnar legs: their flush buckets hit adaptive
        sub-100ms deadlines while first-seen batch shapes still owe a
        cold dispatch, so a cold concurrent run times rows out
        into spurious escalations (stream_timeout) that a parity check
        would misread as verdict drift."""
        if not featureplane.enabled("KTPU_REPLAY"):
            raise ReplayDisabled(
                "KTPU_REPLAY=0: replay injection disabled")
        if leg == "background":
            return self._run_background(trace, speed=speed)
        if leg not in _ADMISSION_LEGS:
            raise ValueError(f"unknown replay leg {leg!r}")

        submit = self._admission_submit(leg)
        if warmup is None:
            warmup = leg in ("stream_row", "stream_block")
        if warmup:
            wwq = WorkerQueue(
                lambda item: submit(item[0], item[1], item[2]),
                workers=workers, name=f"replay-warm-{leg}")
            wwq.run()
            for seq, ev in enumerate(trace.events):
                if ev.op != "POLICY":
                    wwq.add((ev, trace.body_of(ev), seq))
            wwq.drain(timeout=120.0)
            wwq.stop()
        reg = metrics_mod.registry()
        lock = threading.Lock()
        verdicts: dict[int, dict] = {}
        lats: list[float] = []
        errors: list[str] = []
        # (ns, kind, name) -> (seq, verdict|None); seq-ordered so
        # concurrent workers finishing out of order can't clobber a
        # later event's verdict (None = deleted)
        final: dict[tuple, tuple] = {}

        def handle(item):
            arrival, seq, ev, body = item
            try:
                out = submit(ev, body, seq)
                lat = time.perf_counter() - arrival
                with lock:
                    verdicts[seq] = out
                    lats.append(lat * 1e3)
                    key = (ev.namespace, ev.kind, ev.name)
                    prev = final.get(key)
                    if prev is None or seq > prev[0]:
                        final[key] = (seq,
                                      None if ev.op == "DELETE" else out)
                metrics_mod.record_replay_latency(reg, leg, lat)
            except Exception as exc:
                with lock:
                    errors.append(f"{seq}: {exc!r}")
                raise

        wq = WorkerQueue(handle, workers=workers,
                         name=f"replay-{leg}", max_queued=max_queued)
        retries_before = self.retries
        wq.run()
        depths: list[int] = []
        t0 = time.perf_counter()
        released = 0
        for seq, ev in enumerate(trace.events):
            if ev.op == "POLICY":
                continue    # admission legs skip policy-churn events
            if speed:
                delay = t0 + ev.ts / speed - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            wq.add((time.perf_counter(), seq, ev, trace.body_of(ev)))
            released += 1
            depth = wq.queue.qsize()
            depths.append(depth)
            metrics_mod.record_replay_queue_depth(reg, leg, depth)
        wq.drain(timeout=120.0)
        wq.stop()
        span = max(time.perf_counter() - t0, 1e-9)
        metrics_mod.record_replay_events(reg, leg, n=wq.processed,
                                         dropped=wq.dropped)

        lats_sorted = sorted(lats) or [0.0]

        def pct(p: float) -> float:
            return round(lats_sorted[min(len(lats_sorted) - 1,
                                         int(p * len(lats_sorted)))], 3)

        return {
            "leg": leg,
            "speed": speed,
            "events": released,
            "processed": wq.processed,
            "dropped": wq.dropped,
            "errors": errors[:8],
            "duration_s": round(span, 4),
            "achieved_per_s": round(wq.processed / span, 1),
            "latency_ms_p50": pct(0.50),
            "latency_ms_p99": pct(0.99),
            "queue_depth_max": max(depths, default=0),
            "timeout_retries": self.retries - retries_before,
            "verdicts": verdicts,
            "verdict_digest": verdict_digest(verdicts),
            "denied": sum(1 for v in verdicts.values()
                          if not v["allowed"]),
            "failing_resources": sorted(
                "/".join(k) for k, (_, v) in final.items()
                if v is not None and not v["allowed"]),
        }

    def _run_background(self, trace, speed: float | None = None) -> dict:
        """Background leg: trace events → watch client → Reflector →
        WatchHub fan-out → scanner.note_resource, delta scans at POLICY
        boundaries and end of trace. Verdict capture is the final
        failing-resource set from the persisted verdict matrix."""
        from ..api.load import load_policy
        from ..models import Verdict
        from ..runtime.watch import WatchHub

        scanner = self.scanner
        reg = metrics_mod.registry()
        if scanner._state is None:
            # seed the persisted delta state before any event lands, so
            # every pass below takes the incremental path (a late seed
            # would full-scan an empty snapshot and drop pending events)
            scanner.scan([])
        client = _TraceWatchClient()
        hub = WatchHub(client)
        seen = threading.Event()
        delivered = [0]

        def on_event(ev_type, obj):
            op = {"ADDED": "ADDED", "MODIFIED": "MODIFIED",
                  "DELETED": "DELETED"}[ev_type]
            scanner.note_resource(op, obj)
            delivered[0] += 1
            seen.set()

        kinds = sorted({ev.kind or "Pod" for ev in trace.events
                        if ev.op != "POLICY"}) or ["Pod"]
        refls = [hub.ensure("v1", kind, on_event=on_event)
                 for kind in kinds]
        for refl in refls:
            refl.wait_synced(5.0)

        t0 = time.perf_counter()
        scans = 0
        released = 0
        pols = list(scanner.policies)
        for ev in trace.events:
            if speed:
                delay = t0 + ev.ts / speed - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            if ev.op == "POLICY":
                # policy churn: splice the new object into the scanned
                # set and run the incremental (column) pass now
                doc = trace.body_of(ev)
                pol = load_policy(doc)
                pols = [p for p in pols if p.name != pol.name] + [pol]
                self._drain_watch(delivered, released)
                scanner.delta_scan(pols)
                scans += 1
                continue
            client.push(ev.op, trace.body_of(ev))
            released += 1
            metrics_mod.record_replay_queue_depth(
                reg, "background", released - delivered[0])
        self._drain_watch(delivered, released)
        client.close()
        hub.stop()
        result = scanner.delta_scan(pols)
        scans += 1
        span = max(time.perf_counter() - t0, 1e-9)
        metrics_mod.record_replay_events(reg, "background",
                                         n=delivered[0])

        failing: list[str] = []
        matrix = scanner.verdict_matrix()
        if matrix is not None:
            keys, cols, verdicts = matrix
            for i, key in enumerate(keys):
                if (verdicts[i] == int(Verdict.FAIL)).any():
                    kind, ns, name = key
                    failing.append(f"{ns}/{kind}/{name}")
        return {
            "leg": "background",
            "speed": speed,
            "events": released,
            "processed": delivered[0],
            "dropped": 0,
            "errors": [],
            "duration_s": round(span, 4),
            "achieved_per_s": round(delivered[0] / span, 1),
            "delta_scans": scans,
            "rows_evaluated": result.rows_evaluated,
            "cols_evaluated": result.cols_evaluated,
            "violations": result.violations,
            "reflector_syncs": sum(r.syncs for r in refls),
            "failing_resources": sorted(failing),
        }

    @staticmethod
    def _drain_watch(delivered, released, timeout_s: float = 30.0):
        deadline = time.monotonic() + timeout_s
        while delivered[0] < released and time.monotonic() < deadline:
            time.sleep(0.002)


# -------------------------------------------------------------- manifest


def current_topology(fleet: dict | None = None) -> dict:
    """The replica topology a run executed under. ``fleet`` (a
    :func:`build_fleet_stacks` result) stamps the real pool and router
    assignment; None is the single-replica process, stamped with the
    live switch state so a fabric-on single run still differs from a
    fabric-off one."""
    try:
        from ..fleet.fabric import fabric_enabled, transport_preference
        from ..fleet.scanparts import scan_partition_count

        fabric = fabric_enabled()
        transport = transport_preference()
        partitions = scan_partition_count()
    except Exception:
        fabric, transport, partitions = False, "inproc", 0
    topo = {"replicas": 1, "fabric": fabric, "transport": transport,
            "scan_partitions": partitions, "partition_map": {}}
    if fleet is not None:
        topo["replicas"] = int(fleet.get("replicas", 1))
        router = fleet.get("router")
        if router is not None:
            topo["members"] = router.members()
    return topo


def run_manifest(trace, leg_results: list[dict],
                 path: str | None = None, note: str = "",
                 slo: dict | None = None,
                 topology: dict | None = None) -> dict:
    """Persistable record of one replay run: trace identity + per-leg
    numbers + parity digests. Per-event verdict maps are dropped (the
    digest carries the comparison); everything kept is
    schema-versioned so cross-PR diffs fail loudly on layout drift.

    ``slo`` stamps the degradation controller's record (state,
    transitions, engaged actions with enter/exit timestamps, shed set);
    None captures the live controller, so a run that degraded mid-way
    carries that fact in its manifest by default. ``topology`` stamps
    the replica topology (:func:`current_topology`); None captures the
    single-replica default with live switch state."""
    legs = {}
    for r in leg_results:
        slim = {k: v for k, v in r.items() if k != "verdicts"}
        legs[r["leg"]] = slim
    if slo is None:
        try:
            from ..runtime.sloactions import controller

            slo = controller().manifest_record()
        except Exception:
            slo = {"enabled": False, "state": "unknown"}
    if topology is None:
        topology = current_topology()
    manifest = {
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "note": note,
        "trace": {"digest": trace.content_digest(),
                  "meta": trace.meta, **trace.stats()},
        "legs": legs,
        "slo": slo,
        "topology": topology,
    }
    if path:
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def diff_manifests(a: dict, b: dict) -> dict:
    """A/B diff of two run manifests (the cross-PR comparison): verdict
    parity per common leg plus numeric deltas on throughput/latency.
    The SLO block makes degradation state explicit — ``comparable`` is
    False when the runs disagree on state, engaged actions, or shed
    set, so a degraded run can't silently benchmark against a healthy
    one."""
    if (a.get("schema_version") != MANIFEST_SCHEMA_VERSION
            or b.get("schema_version") != MANIFEST_SCHEMA_VERSION):
        raise ValueError("manifest schema_version mismatch")
    ta, tb = a.get("topology") or {}, b.get("topology") or {}

    def _topo_key(t: dict) -> tuple:
        return (t.get("replicas", 1), bool(t.get("fabric")),
                t.get("scan_partitions", 0))

    topo_comparable = _topo_key(ta) == _topo_key(tb)
    out: dict = {
        "same_trace": a["trace"]["digest"] == b["trace"]["digest"],
        "legs": {},
    }
    for leg in sorted(set(a["legs"]) & set(b["legs"])):
        la, lb = a["legs"][leg], b["legs"][leg]
        entry: dict = {}
        if "verdict_digest" in la and "verdict_digest" in lb:
            # verdicts must agree across topologies (that's the fleet's
            # correctness contract) so parity always compares...
            entry["verdict_parity"] = (la["verdict_digest"]
                                       == lb["verdict_digest"])
        if topo_comparable:
            for k in ("achieved_per_s", "latency_ms_p50",
                      "latency_ms_p99", "queue_depth_max", "denied",
                      "violations"):
                if (k in la and k in lb
                        and isinstance(la[k], (int, float))):
                    entry[f"{k}_delta"] = round(lb[k] - la[k], 3)
        else:
            # ...but a 3-replica fleet benchmarked against one replica
            # is a topology change, not a regression: numeric deltas
            # are suppressed rather than misread
            entry["skipped"] = "topology mismatch"
        out["legs"][leg] = entry
    out["topology"] = {
        "a": {"replicas": ta.get("replicas", 1),
              "fabric": bool(ta.get("fabric")),
              "scan_partitions": ta.get("scan_partitions", 0)},
        "b": {"replicas": tb.get("replicas", 1),
              "fabric": bool(tb.get("fabric")),
              "scan_partitions": tb.get("scan_partitions", 0)},
        "comparable": topo_comparable,
    }
    sa, sb = a.get("slo") or {}, b.get("slo") or {}

    def _slo_key(s: dict) -> tuple:
        return (s.get("state", "unknown"),
                tuple(s.get("actions_active") or ()),
                tuple(s.get("shed") or ()))
    out["slo"] = {
        "a": {"state": sa.get("state", "unknown"),
              "actions_active": list(sa.get("actions_active") or ()),
              "shed": list(sa.get("shed") or ()),
              "degraded_entered": sum(
                  1 for t in (sa.get("transitions") or ())
                  if t.get("state") == "degraded")},
        "b": {"state": sb.get("state", "unknown"),
              "actions_active": list(sb.get("actions_active") or ()),
              "shed": list(sb.get("shed") or ()),
              "degraded_entered": sum(
                  1 for t in (sb.get("transitions") or ())
                  if t.get("state") == "degraded")},
        "comparable": _slo_key(sa) == _slo_key(sb),
    }
    return out
