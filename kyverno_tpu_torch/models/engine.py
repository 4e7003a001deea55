"""CompiledPolicySet: compile policies once, score resource batches on the
card, resolve what the card cannot score on the CPU.

``CompiledPolicySet(policies)`` compiles the policies to ``PolicyTensors``
and turns them into a device plan (``ops/plan.py``) once. ``flatten``
gives a ``FlatBatch`` whose ``packed_blob()`` is the one buffer copied to
the card; ``evaluate_device`` returns the int8 verdict matrix
[B, n_rules_live], in which host-lane cells read HOST (code 5), and
``scan_counts`` the per-rule counts of the background scan.
``evaluate`` is the whole path: flatten (the native flattener,
``models/native_flatten.py``), the device verdicts, then
``resolve_host_cells``, which turns every HOST cell into the CPU oracle's
verdict (``engine/validation.py``) through the host lane
(``runtime/hostlane.py``: a verdict memo and fan-out over threads), so
that no HOST cell is left. ``evaluate_pipelined`` does the same chunk by
chunk, flattening the next chunk on a thread and starting each chunk's
host prefetch while the card scores it.

``evaluate_device_async(batch, donate=True)`` is K6, the admission
batcher's stable-shape dispatch: each (B, P, E, V) shape bucket keeps a
small ring of slots (pinned host staging, a persistent device blob,
pinned host memory for the verdicts, a CUDA event), so a warm dispatch
copies the blob into pinned memory, starts the copy to the card, K1 ->
eval_rules and the copy back, and returns without waiting.
:class:`IncrementalCompiler` recompiles only the policies that changed
and splices their segments into the population's tensors (the policy
cache's route). :class:`ShardedPolicySet` cuts a population into policy
shards (:class:`PolicyPartitioner`: sticky, balanced by rule count), each
a set of its own over the shared dictionary with the column map back to
the full layout: the 2D mesh scan's rule axis (``parallel/mesh.py``).

The device is ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request the constructor raises.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch

from ..engine.context import Context
from ..engine.match import AdmissionUserInfo, RequestInfo
from ..engine.policy_context import PolicyContext
from ..engine.response import RuleStatus
from ..engine.validation import validate as oracle_validate
from ..ops import eval as ops_eval
from ..ops.plan import Plan
from ..runtime import featureplane
from .compiler import (
    PolicyTensors,
    TensorDictionary,
    assemble_tensors,
    compile_segment,
    compile_tensors,
)
from .flatten import FlatBatch
from .ir import compile_rule_ir

logger = logging.getLogger(__name__)


class Verdict(IntEnum):
    NOT_APPLICABLE = 0
    PASS = 1
    FAIL = 2
    SKIP = 3
    ERROR = 4
    HOST = 5


_STATUS_TO_VERDICT = {
    RuleStatus.PASS: Verdict.PASS,
    RuleStatus.FAIL: Verdict.FAIL,
    RuleStatus.WARN: Verdict.PASS,
    RuleStatus.ERROR: Verdict.ERROR,
    RuleStatus.SKIP: Verdict.SKIP,
}


def donation_enabled() -> bool:
    """KTPU_DONATE=0 kill switch for K6's slots on the stable-shape
    device call — dynamic, like every KTPU_* lane flag."""
    return featureplane.enabled("KTPU_DONATE")


# process-wide K6 accounting, with the JAX package's keys: ``dispatches``
# counts dispatches that took the donating route (on the CPU too, where
# the plain versions run, as a JAX CPU backend that cannot alias a buffer
# runs them); ``donated_buffers`` counts those that ran on a reused
# device blob of their shape bucket, with no allocation and no second
# device copy — the port's meaning of a consumed (donated) buffer.
# ``K6_ALLOC`` counts the slots allocated and the seconds spent on them
# (a cold shape bucket's first cost on the card).
DONATION_STATS = {"dispatches": 0, "donated_buffers": 0}
K6_ALLOC = {"slots": 0, "seconds": 0.0}
_STATS_LOCK = threading.Lock()
# slots a shape bucket keeps; with every one held, a dispatch takes the
# oldest and its holder's verdicts are copied out first
K6_SLOTS = 4
# a slot's holder between its pick and its handle
_DISPATCHING = object()
# the phase split of evaluate_device_async on the card: while true, each
# call keeps host clocks and CUDA events between its steps on its handle
# (AsyncVerdicts.phases); while false, a call only tests the flag
PHASE_TIMING = False


class _Phases:
    """One timed call's host clocks (``time.perf_counter`` seconds) and
    the CUDA events recorded between its steps on the card: on K6's
    route H2D start, H2D end (the launches' start), the launches' end
    and D2H end, all at dispatch; on the plain route the first three at
    dispatch, and D2H start and end in :meth:`AsyncVerdicts.get`."""

    __slots__ = ("device", "clocks", "events")

    def __init__(self, device):
        self.device = device
        self.clocks = {"start": time.perf_counter()}
        self.events: list = []

    def clock(self, name: str) -> None:
        self.clocks[name] = time.perf_counter()

    def event(self) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        self.events.append(e)

    def ms(self) -> dict:
        """Milliseconds of each step: ``staging`` (host copy into pinned
        memory; 0 on the plain route), ``h2d``, ``launches`` and ``d2h``
        on the card, ``read`` (host: the verdicts out of pinned memory,
        or the slice of the copied matrix) and ``dispatch`` (host: the
        call until it returned its handle)."""
        c, e = self.clocks, self.events
        k6 = "staged" in c
        return {"staging": (c["staged"] - c["staging"]) * 1e3 if k6 else 0.0,
                "h2d": e[0].elapsed_time(e[1]),
                "launches": e[1].elapsed_time(e[2]),
                "d2h": (e[2].elapsed_time(e[3]) if k6
                        else e[3].elapsed_time(e[4])),
                "read": (c["read"] - c["copied"]) * 1e3,
                "dispatch": (c["dispatched"] - c["start"]) * 1e3}


class _Slot:
    """One K6 slot of a shape bucket: pinned staging for the blob, the
    device blob it is copied into, pinned memory for the verdicts [B, R]
    and the event recorded after the copy back. ``handle`` is the
    :class:`AsyncVerdicts` holding the slot (None while free); a slot is
    free again only after its holder has read the verdicts, so its event
    has completed and every copy from and to it is done."""

    __slots__ = ("staged", "dblob", "out", "event", "handle", "seq")

    def __init__(self, words: int, B: int, R: int, device):
        self.staged = torch.empty(words, dtype=torch.int32, pin_memory=True)
        self.dblob = torch.empty(words, dtype=torch.int32, device=device)
        self.out = torch.empty((B, R), dtype=torch.int8, pin_memory=True)
        self.event = torch.cuda.Event()
        self.handle = None
        self.seq = 0


@dataclass
class RuleRef:
    policy: object          # ClusterPolicy
    rule: object            # Rule
    rule_index: int


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; a CPU run must be asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    def index(d):
        if d.index is None and d.type == "cuda":
            return torch.cuda.current_device()
        return d.index

    return a.type == b.type and index(a) == index(b)


class AsyncVerdicts:
    """Handle on an in-flight device evaluation (evaluate_device_async).
    The card computes while the dispatching thread does other host work;
    :meth:`get` waits for it, reads the verdicts to the host once, slices
    them to ``n_live`` columns and caches them. On the plain route ``out``
    is the verdict tensor (an event is recorded after its launches on the
    card); on K6's route it is None and ``slot`` holds the verdicts in
    pinned memory until :meth:`get` copies them out and frees the slot."""

    __slots__ = ("_out", "_event", "_slot", "_n_live", "_verdicts", "_lock",
                 "_phases")

    def __init__(self, out: torch.Tensor | None, n_live: int | None = None,
                 slot: _Slot | None = None, phases: _Phases | None = None):
        self._out = out
        self._n_live = n_live
        self._slot = slot
        self._phases = phases
        self._event = None
        self._lock = threading.Lock()
        if slot is not None:
            self._event = slot.event
        elif out.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(out.device))
        self._verdicts: np.ndarray | None = None

    def get(self) -> np.ndarray:
        if self._verdicts is None:
            with self._lock:
                if self._verdicts is None:
                    self._materialize()
        return self._verdicts

    def _materialize(self) -> None:
        """Wait for the card and read the verdicts (caller holds
        ``_lock``); a K6 slot is freed after its copy."""
        phases = self._phases
        if self._event is not None:
            self._event.synchronize()
        slot = self._slot
        if slot is not None:
            if phases is not None:
                phases.clock("copied")
            v = slot.out.numpy()
        else:
            if phases is not None:
                phases.event()
            v = self._out.cpu().numpy()
            if phases is not None:
                phases.event()
                phases.clock("copied")
        if self._n_live is not None and v.shape[1] != self._n_live:
            v = v[:, :self._n_live]
        if slot is not None:
            v = np.array(v)          # the slot's pinned memory is reused
            self._slot = None
            slot.handle = None
        if phases is not None:
            phases.clock("read")
        self._verdicts = v
        self._out = None

    def phases(self) -> dict | None:
        """The call's phase split in ms (:meth:`_Phases.ms`) after the
        verdicts are read; None unless it ran on the card with
        ``PHASE_TIMING`` on."""
        self.get()
        return None if self._phases is None else self._phases.ms()

    def done(self) -> bool:
        """Non-blocking completeness probe: the event's ``query()``."""
        if self._verdicts is not None:
            return True
        event = self._event
        return True if event is None else bool(event.query())


class CompiledPolicySet:
    def __init__(self, policies: list, device=None,
                 tensors: PolicyTensors | None = None,
                 _parts: tuple | None = None):
        """``tensors`` — an already compiled ``PolicyTensors`` (e.g. carried
        across with ``convert.tensors_from_numpy``); ``_parts`` —
        ``(rule_refs, rule_irs, tensors)`` from an incremental assembly
        (IncrementalCompiler.refresh); by default the policies compile
        here. ``plan_s`` is the seconds the device plan took to build."""
        self.device = resolve_device(device)
        self.policies = list(policies)
        if _parts is not None:
            self.rule_refs, self.rule_irs, self.tensors = _parts
        else:
            self.rule_refs: list[RuleRef] = []
            self.rule_irs = []
            idx = 0
            for policy in self.policies:
                for rule in policy.spec.rules:
                    if not rule.has_validate():
                        continue
                    self.rule_refs.append(RuleRef(policy, rule, idx))
                    if tensors is None:
                        self.rule_irs.append(
                            compile_rule_ir(policy, rule, idx))
                    idx += 1
            self.tensors: PolicyTensors = (
                tensors if tensors is not None
                else compile_tensors(self.rule_irs))
        t0 = time.perf_counter()
        self.plan = Plan(self.tensors, self.device)
        self.plan_s = time.perf_counter() - t0
        # plans on the other devices of a mesh row (plan_on)
        self._plans: dict[str, Plan] = {}
        self._plans_lock = threading.Lock()
        # K6: shape bucket (B, P, E, V) -> its slots
        self._k6: dict[tuple, list[_Slot]] = {}
        self._k6_lock = threading.Condition()
        self._k6_seq = 0
        self.donation_stats = {"dispatches": 0, "donated_buffers": 0}

    # ------------------------------------------------------------ host

    def flatten(self, resources: list[dict],
                requests: list[dict] | None = None) -> FlatBatch:
        from .native_flatten import flatten_batch_fast

        return flatten_batch_fast(resources, self.tensors, requests=requests)

    def flatten_packed(self, resources: list[dict] | None = None,
                       requests: list[dict] | None = None,
                       json_docs: bytes | None = None,
                       n_docs: int | None = None,
                       json_reqs: bytes | None = None):
        """PackedBatch — the transfer-thin flatten for device dispatch.
        Pass ``json_docs`` (JSON array bytes, e.g. an apiserver list
        response's items) to skip Python-side serialization entirely."""
        from .native_flatten import flatten_packed_fast

        return flatten_packed_fast(
            self.tensors, resources, requests=requests,
            json_docs=json_docs, n_docs=n_docs, json_reqs=json_reqs)

    def to_device(self, batch) -> tuple[torch.Tensor, tuple[int, int, int, int]]:
        """The batch's packed blob on the device (int32, the uint32 words'
        bits) and its (B, P, E, V) shape."""
        blob, shp = batch.packed_blob()
        host = torch.from_numpy(np.ascontiguousarray(blob).view(np.int32))
        return host.to(self.device, non_blocking=False), shp

    def plan_on(self, device) -> Plan:
        """The device plan on ``device``: the set's own plan on its own
        device, else one built there at first use and kept (a mesh row of
        other devices)."""
        dev = torch.device(device)
        if same_device(dev, self.device):
            return self.plan
        key = str(dev)
        with self._plans_lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = self._plans[key] = Plan(self.tensors, dev)
        return plan

    # ------------------------------------------------------------ device

    def _launch(self, batch, phases: _Phases | None = None) -> torch.Tensor:
        if phases is not None:
            phases.event()
        dblob, shp = self.to_device(batch)
        if phases is not None:
            phases.event()
        out = ops_eval.evaluate_blob(self.plan, dblob, *shp)
        if phases is not None:
            phases.event()
        return out

    def evaluate_device(self, batch) -> np.ndarray:
        """Device verdicts int8 [B, n_rules_live] (host-lane cells HOST)."""
        return self._launch(batch)[:, :self.tensors.n_rules_live].cpu().numpy()

    def evaluate_device_async(self, batch, donate: bool = False) -> AsyncVerdicts:
        """Dispatch the device evaluation without waiting for its result;
        the handle's :meth:`AsyncVerdicts.get` is the join. Callers (the
        admission flush, ``evaluate_pipelined``) do host work between
        dispatch and get.

        ``donate=True`` (gated by KTPU_DONATE) is K6: the batch's shape
        bucket keeps up to ``K6_SLOTS`` slots, and a dispatch copies the
        blob into a free slot's pinned staging, copies that to the slot's
        persistent device blob without blocking, launches K1 ->
        eval_rules on the current stream, copies the verdicts into the
        slot's pinned memory without blocking and records the slot's
        event. A warm bucket thus allocates nothing and makes no second
        device copy of the blob. The caller's numpy blob is only read.
        A failure (a pinned allocation, a copy, a launch) raises; it
        never falls back to the plain route. On the CPU the plain
        versions run and the dispatch is counted, as in the JAX package
        on a backend that cannot alias a buffer. Otherwise the blob is
        copied from pageable memory and the launches are queued, as in
        :meth:`evaluate_device`. With ``PHASE_TIMING`` on, a call on the
        card times its steps (:meth:`AsyncVerdicts.phases`)."""
        live = self.tensors.n_rules_live
        phases = (_Phases(self.device)
                  if PHASE_TIMING and self.device.type == "cuda" else None)
        if donate and donation_enabled():
            if self.device.type == "cuda":
                return self._dispatch_k6(batch, live, phases)
            self._count_donation(False)
        handle = AsyncVerdicts(self._launch(batch, phases), n_live=live,
                               phases=phases)
        if phases is not None:
            phases.clock("dispatched")
        return handle

    def _count_donation(self, reused: bool) -> None:
        """One donating dispatch, in DONATION_STATS and in the set's own
        ``donation_stats`` (the same keys, this set's dispatches only)."""
        with _STATS_LOCK:
            for stats in (DONATION_STATS, self.donation_stats):
                stats["dispatches"] += 1
                if reused:
                    stats["donated_buffers"] += 1

    def _k6_slot(self, shp: tuple, words: int) -> tuple[_Slot, bool]:
        """A slot of the shape bucket ``shp`` for one dispatch, and
        whether it was allocated before (a reused device blob)."""
        with self._k6_lock:
            ring = self._k6.setdefault(shp, [])
            while True:
                # a holder frees its slot from its own get(), under its
                # handle's lock and not this one, so each slot's handle is
                # read once here and the pick works on that snapshot
                handles = [(s, s.handle) for s in ring]
                slot = next((s for s, h in handles if h is None), None)
                if slot is not None:
                    reused = True
                    break
                if len(ring) < K6_SLOTS:
                    t0 = time.perf_counter()
                    slot = _Slot(words, shp[0], self.plan.R, self.device)
                    with _STATS_LOCK:
                        K6_ALLOC["slots"] += 1
                        K6_ALLOC["seconds"] += time.perf_counter() - t0
                    ring.append(slot)
                    reused = False
                    break
                held = [(s, h) for s, h in handles
                        if isinstance(h, AsyncVerdicts)]
                if held:
                    # every slot is held: the oldest holder's verdicts are
                    # copied out now (it waits on its event), which frees
                    # it; a holder that read them since the snapshot has
                    # freed it already
                    slot, holder = min(held, key=lambda sh: sh[0].seq)
                    with holder._lock:
                        if holder._verdicts is None:
                            holder._materialize()
                    reused = True
                    break
                # every slot is between its pick and its handle
                self._k6_lock.wait(0.001)
            self._k6_seq += 1
            slot.seq = self._k6_seq
            slot.handle = _DISPATCHING
        return slot, reused

    def _dispatch_k6(self, batch, live: int,
                     phases: _Phases | None = None) -> AsyncVerdicts:
        blob, shp = batch.packed_blob()
        host = np.ascontiguousarray(blob).view(np.int32)
        slot, reused = self._k6_slot(shp, host.size)
        try:
            if phases is not None:
                phases.clock("staging")
            np.copyto(slot.staged.numpy(), host)
            if phases is not None:
                phases.clock("staged")
                phases.event()
            slot.dblob.copy_(slot.staged, non_blocking=True)
            if phases is not None:
                phases.event()
            out = ops_eval.evaluate_blob(self.plan, slot.dblob, *shp)
            if phases is not None:
                phases.event()
            slot.out.copy_(out, non_blocking=True)
            if phases is not None:
                phases.event()
            slot.event.record(torch.cuda.current_stream(self.device))
        except BaseException:
            # a slot whose copies may still be queued is never reused
            with self._k6_lock:
                self._k6[shp].remove(slot)
            raise
        handle = AsyncVerdicts(None, n_live=live, slot=slot, phases=phases)
        slot.handle = handle
        self._count_donation(reused)
        if phases is not None:
            phases.clock("dispatched")
        return handle

    def scan_counts(self, batch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Background-scan counts: per-rule FAIL and PASS counts over rows
        with no HOST cell, and which rows hold a HOST cell."""
        dblob, shp = self.to_device(batch)
        fails, passes, host_rows = ops_eval.scan_blob(self.plan, dblob, *shp)
        return fails.cpu().numpy(), passes.cpu().numpy(), host_rows.cpu().numpy()


    # ------------------------------------------------------------ full

    def evaluate(self, resources: list[dict]) -> np.ndarray:
        """Verdict matrix [B, n_rules_live]: the device verdicts, then the
        CPU oracle for every HOST cell."""
        batch = self.flatten(resources)
        verdicts = self.evaluate_device(batch)
        return self.resolve_host_cells(resources, verdicts)

    def evaluate_pipelined(self, resources: list[dict],
                           chunk: int = 1024) -> np.ndarray:
        """Chunked :meth:`evaluate` with the scan pipeline: flatten chunk
        k+1 on a prefetch thread while chunk k's device eval is in flight,
        start chunk k's host-lane prefetch at its dispatch, and resolve
        chunk k-1's host cells in the same shadow. Falls back to the
        serial chunk loop when the KTPU_FLATTEN_PIPELINE kill-switch is
        off. Verdicts are identical to ``evaluate`` — rows flatten and
        score independently, so chunk boundaries and overlap order can't
        change them. Only the calling thread launches kernels and copies
        tensors: the flatten thread runs the flattener, the host lane's
        threads the oracle."""
        from concurrent.futures import ThreadPoolExecutor

        from .flatten import pipeline_enabled

        if not resources:
            return self.evaluate(resources)
        if not pipeline_enabled() or len(resources) <= chunk:
            if len(resources) <= chunk:
                return self.evaluate(resources)
            return np.concatenate([
                self.evaluate(resources[i:i + chunk])
                for i in range(0, len(resources), chunk)])

        from ..runtime import tracing
        from ..runtime.hostlane import resolver

        rec = tracing.recorder()
        spans = [(i, min(i + chunk, len(resources)))
                 for i in range(0, len(resources), chunk)]
        traces: list = [None] * len(spans)
        out: list[np.ndarray] = []

        def drain(entry):
            """Materialize one in-flight chunk: device join, host-lane
            resolve, trace seal."""
            (lo, hi), done, pf0, tr0, d00 = entry
            verdicts = done.get()
            rec.add_span(tr0, "device_dispatch", d00, time.perf_counter(),
                         lane="async", rows=hi - lo)
            h0 = time.perf_counter()
            with tracing.active(tr0):
                resolved = self.resolve_host_cells(
                    resources[lo:hi], verdicts, prefetch=pf0)
            out.append(resolved)
            rec.add_span(tr0, "host_resolve", h0, time.perf_counter(),
                         lane="prefetch" if pf0 is not None else "post_pass")
            try:
                from ..runtime import metrics as metrics_mod

                metrics_mod.record_policy_verdict_matrix(
                    metrics_mod.registry(), self.rule_refs, resolved,
                    lane="scan")
            except Exception:
                pass
            rec.finish(tr0)

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="ktpu-prefetch") as pool:
            def flatten_span(span, tr):
                lo, hi = span
                f0 = time.perf_counter()
                batch = self.flatten_packed(resources[lo:hi])
                rec.add_span(tr, "flatten", f0, time.perf_counter(),
                             rows=hi - lo, lane="prefetch_thread")
                return batch

            traces[0] = rec.start("scan_chunk", lo=spans[0][0],
                                  hi=spans[0][1])
            pending = pool.submit(flatten_span, spans[0], traces[0])
            # [(span, AsyncVerdicts, pf, trace, dispatch_t0)]
            in_flight: list[tuple] = []
            for k, span in enumerate(spans):
                tr = traces[k]
                batch = pending.result()
                if k + 1 < len(spans):
                    traces[k + 1] = rec.start(
                        "scan_chunk", lo=spans[k + 1][0],
                        hi=spans[k + 1][1])
                    pending = pool.submit(flatten_span, spans[k + 1],
                                          traces[k + 1])
                d0 = time.perf_counter()
                handle = self.evaluate_device_async(batch)
                # host-lane prefetch rides the same shadow: the chunk's
                # statically host-only cells start oracle-resolving now
                # and join when the chunk's verdicts materialize below
                with tracing.active(tr):
                    pf = resolver().prefetch(
                        self, resources[span[0]:span[1]])
                in_flight.append((span, handle, pf, tr, d0))
                if len(in_flight) > 1:
                    drain(in_flight.pop(0))
            for entry in in_flight:
                drain(entry)
        return np.concatenate(out)

    def resolve_host_cells(self, resources: list[dict],
                           verdicts: np.ndarray,
                           contexts: list | None = None,
                           rule_filter=None,
                           messages_out: dict | None = None,
                           copy: bool = False,
                           prefetch=None) -> np.ndarray:
        """Replace Verdict.HOST cells with CPU-oracle verdicts.

        By default ``verdicts`` is resolved in place and also returned;
        pass ``copy=True`` when the array is shared state something else
        may still read (an ``AsyncVerdicts`` handle's cached matrix): the
        oracle's verdicts then land in a private copy.

        ``contexts`` (optional, aligned with ``resources``) carries each
        resource's admission payload, ``{"request", "namespace_labels",
        "roles", "cluster_roles", "exclude_group_role"}``, so that rules
        reading ``request.*`` or the user's info resolve against it
        rather than a context of the resource alone. ``rule_filter`` (a
        container of rule indices) limits resolution to those rules:
        cells outside it stay HOST. ``messages_out`` (optional dict)
        receives the oracle's message per resolved cell, keyed
        ``(batch_row, rule_index)``.

        ``prefetch`` (a runtime/hostlane.HostPrefetch started at device
        dispatch time) joins here first: its verdicts scatter into cells
        the device actually reported HOST, and whatever it didn't cover
        resolves in the post-pass below. Resolution delegates to
        runtime/hostlane (memo + fan-out); with the KTPU_HOST_* switches
        off that is the serial per-resource loop, in row order, and an
        oracle exception propagates. Under fan-out an exception leaves
        that resource's cells HOST, as in the JAX package."""
        if copy:
            verdicts = verdicts.copy()
        if prefetch is not None:
            prefetch.apply(verdicts, messages_out)
        host_cells = np.argwhere(verdicts == Verdict.HOST)
        if host_cells.size:
            by_resource: dict[int, list[int]] = {}
            for b, r in host_cells:
                if rule_filter is not None and int(r) not in rule_filter:
                    continue
                by_resource.setdefault(int(b), []).append(int(r))
            if by_resource:
                from ..runtime.hostlane import resolver

                resolver().resolve_rows(self, resources, by_resource,
                                        verdicts, contexts, messages_out)
        return verdicts

    def _request_policy_context(self, resource: dict, payload: dict):
        """Request-aware PolicyContext for host-cell resolution: the
        admission request, the resource and its old version, the user's
        roles and service account, and the images of the resource."""
        request = payload.get("request") or {}
        jctx = Context()
        if request:
            jctx.add_request(request)
        if resource:
            jctx.add_resource(resource)
        old = request.get("oldObject") or {}
        if old:
            jctx.add_old_resource(old)
        user_info = request.get("userInfo") or {}
        roles = payload.get("roles") or []
        cluster_roles = payload.get("cluster_roles") or []
        jctx.add_user_info({"roles": roles, "clusterRoles": cluster_roles,
                            "userInfo": user_info})
        username = user_info.get("username", "")
        if username:
            jctx.add_service_account(username)
        try:
            jctx.add_image_info(resource)
        except Exception:
            pass
        return PolicyContext(
            new_resource=resource,
            old_resource=old,
            json_context=jctx,
            namespace_labels=payload.get("namespace_labels") or {},
            exclude_group_role=payload.get("exclude_group_role") or [],
            admission_info=RequestInfo(
                roles=roles, cluster_roles=cluster_roles,
                admission_user_info=AdmissionUserInfo(
                    username=username, uid=user_info.get("uid", ""),
                    groups=user_info.get("groups") or [])))

    def _oracle_verdicts(self, resource: dict, rule_rows: list[int],
                         context: dict | None = None) -> dict:
        """Run the CPU oracle for specific rules of one resource; returns
        ``{rule_index: (Verdict, message)}``: one ``validate`` per policy,
        its responses keyed by rule name, and NOT_APPLICABLE for a rule
        with no response.

        Namespaced Policy objects only apply inside their own namespace;
        ``oracle_validate`` applies that gate (``validation._matches``),
        as the device's match program does."""
        out: dict[int, tuple] = {}
        by_policy: dict[int, list[RuleRef]] = {}
        for r in rule_rows:
            ref = self.rule_refs[r]
            by_policy.setdefault(id(ref.policy), []).append(ref)
        pctx = None
        if context is not None:
            pctx = self._request_policy_context(resource, context)
        for refs in by_policy.values():
            policy = refs[0].policy
            if pctx is not None:
                pctx.policy = policy
                resp = oracle_validate(pctx)
            else:
                jctx = Context()
                jctx.add_resource(resource)
                resp = oracle_validate(
                    PolicyContext(policy=policy, new_resource=resource,
                                  json_context=jctx))
            rows = {rr.name: rr for rr in resp.policy_response.rules}
            for ref in refs:
                rr = rows.get(ref.rule.name)
                if rr is None:
                    out[ref.rule_index] = (Verdict.NOT_APPLICABLE, "")
                else:
                    out[ref.rule_index] = (_STATUS_TO_VERDICT[rr.status],
                                           rr.message)
        return out


def _validate_rules(policy) -> list:
    return [r for r in policy.spec.rules if r.has_validate()]


class IncrementalCompiler:
    """Per-population segmented compiler — the policy-update-storm path.

    Keeps one compiled :class:`~.compiler.PolicySegment` per policy plus
    the shared append-only :class:`~.compiler.TensorDictionary`; on
    churn, only segments whose policy *object* changed recompile, and
    ``assemble_tensors`` splices all segments (rebased offsets) into a
    fresh PolicyTensors. Because the dictionary only appends, unchanged
    segments keep their path/NFA/kind ids and flatten-row memos keyed on
    ``(dict_base, digest)`` revalidate by epoch instead of evicting.

    ``rule_bucket=True`` pads the rule axis to power-of-two buckets so
    repeated single-policy updates tend to land in an already-seen rule
    width (verdicts are sliced back to ``n_rules_logical``). Every set it
    returns is a :class:`CompiledPolicySet` on ``device`` (its plan built
    there); :meth:`refresh_sharded` also cuts the population into policy
    shards (:class:`ShardedPolicySet`). Each splice is certified
    (:meth:`_certify_spliced`, KT4xx, behind ``KTPU_CERTIFY``).

    Not thread-safe on its own; PolicyCache serializes access under its
    lock."""

    def __init__(self, rule_bucket: bool = True, device=None):
        self.device = resolve_device(device)
        self.dictionary = TensorDictionary(persistent=True)
        self.rule_bucket = rule_bucket
        # policy key -> (id(policy object), PolicySegment)
        self._segments: dict[str, tuple[int, object]] = {}
        self._last: CompiledPolicySet | None = None
        self._last_sig: tuple | None = None
        self.stats = {"refreshes": 0, "segments_reused": 0,
                      "segments_recompiled": 0, "segments_dropped": 0}
        self.last_refresh: dict = {}
        self.last_refresh_certify: dict = {}

    @staticmethod
    def _policy_key(policy) -> str:
        ns = getattr(policy, "namespace", "") or ""
        return f"{ns}/{policy.name}" if ns else policy.name

    def _segment(self, policy, key: str, name: str | None = None):
        rules = _validate_rules(policy)
        seg_irs = [compile_rule_ir(policy, rule, li)
                   for li, rule in enumerate(rules)]
        return compile_segment(seg_irs, self.dictionary, name=name or key)

    def refresh(self, policies: list) -> CompiledPolicySet:
        """Compiled set for ``policies`` (in order), recompiling only the
        segments whose policy object is new or replaced. When nothing at
        all changed, the previous CompiledPolicySet comes back as-is —
        its plan (and its K6 slots) survive churn in *other*
        populations."""
        policies = list(policies)
        sig = tuple(id(p) for p in policies)
        self.stats["refreshes"] += 1
        if self._last is not None and sig == self._last_sig:
            self.stats["segments_reused"] += len(policies)
            self.last_refresh = {"reused": len(policies), "recompiled": 0,
                                 "dropped": 0, "unchanged": True,
                                 "dict_epoch": self.dictionary.epoch,
                                 "recompiled_keys": [], "dropped_keys": []}
            return self._last

        segs = []
        rule_refs: list[RuleRef] = []
        rule_irs = []
        live_keys = set()
        idx = 0
        reused = 0
        recompiled_keys: list[str] = []
        for policy in policies:
            key = self._policy_key(policy)
            live_keys.add(key)
            cached = self._segments.get(key)
            if cached is not None and cached[0] == id(policy):
                seg = cached[1]
                reused += 1
            else:
                seg = self._segment(policy, key)
                self._segments[key] = (id(policy), seg)
                recompiled_keys.append(key)
            segs.append(seg)
            for rule in _validate_rules(policy):
                rule_refs.append(RuleRef(policy, rule, idx))
                idx += 1
            rule_irs.extend(seg.rule_irs)

        dropped = [k for k in self._segments if k not in live_keys]
        for k in dropped:
            del self._segments[k]

        tensors = assemble_tensors(segs, self.dictionary,
                                   rule_bucket=self.rule_bucket)
        cps = CompiledPolicySet(policies, device=self.device,
                                _parts=(rule_refs, rule_irs, tensors))
        self._certify_spliced(tensors)
        self.stats["segments_reused"] += reused
        self.stats["segments_recompiled"] += len(recompiled_keys)
        self.stats["segments_dropped"] += len(dropped)
        self.last_refresh = {"reused": reused,
                             "recompiled": len(recompiled_keys),
                             "dropped": len(dropped), "unchanged": False,
                             "dict_epoch": tensors.dict_epoch,
                             "recompiled_keys": recompiled_keys,
                             "dropped_keys": dropped}
        self._last = cps
        self._last_sig = sig
        return cps

    def _certify_spliced(self, tensors: PolicyTensors) -> None:
        """KT4xx certification of the freshly spliced tensors, gated on
        KTPU_CERTIFY. Only rules not yet stamped are certified (cached
        segments carry their stamp across refreshes), so a storm of
        single-policy updates pays one rule's worth of abstract
        enumeration per splice, not the population's. Never raises: a
        certifier failure must not take down admission; it surfaces as
        the ``kyverno_certified_rules{status="divergent"}`` gauge and an
        error log instead."""
        try:
            if not featureplane.enabled("KTPU_CERTIFY"):
                return
            from ..analysis.certify import certify_tensors

            result = certify_tensors(
                tensors, rule_filter=lambda ir: not ir.certified,
                probe_discharge=False)
            by_key = {(ir.policy_name, ir.rule_name): ir
                      for ir in tensors.rules}
            for key, status in result.statuses.items():
                ir = by_key.get(key)
                if ir is not None:
                    ir.certified = status
            for d in result.diagnostics:
                if d.code == "KT401":
                    logger.error("certify: %s", d.format())
            counts: dict[str, int] = {}
            for ir in tensors.rules:
                counts[ir.certified or "unchecked"] = (
                    counts.get(ir.certified or "unchecked", 0) + 1)
            self.last_refresh_certify = counts
            from ..runtime.metrics import record_certified_rules, registry

            record_certified_rules(registry(), counts)
        except Exception:
            logger.exception("certification of spliced segments failed "
                             "(admission unaffected)")

    def compile_candidate(self, policy) -> CompiledPolicySet:
        """Isolated single-policy compile for the dry-run service: the
        candidate's segment assembles over the *shared* append-only
        dictionary (so flatten rows memoized against the live population
        splice in unchanged), but — unlike :meth:`subset` — nothing is
        stored in the segment cache. A candidate that shares its key
        with a live policy therefore cannot evict that policy's cached
        segment or force a recompile at the next refresh; the dictionary
        only ever appends, which live consumers revalidate by epoch."""
        key = self._policy_key(policy)
        seg = self._segment(policy, key, name=f"candidate:{key}")
        rule_refs = [RuleRef(policy, rule, i)
                     for i, rule in enumerate(_validate_rules(policy))]
        tensors = assemble_tensors([seg], self.dictionary,
                                   rule_bucket=self.rule_bucket)
        return CompiledPolicySet([policy], device=self.device,
                                 _parts=(rule_refs, seg.rule_irs, tensors))

    def refresh_sharded(self, policies: list, n_shards: int,
                        sharded: "ShardedPolicySet | None" = None
                        ) -> "ShardedPolicySet":
        """Refresh the full set AND its policy-axis decomposition in one
        pass. Pass the previous :class:`ShardedPolicySet` back in so its
        sticky shard assignment and per-shard caches survive — that is
        what keeps churn local to the owning shard."""
        if sharded is None or sharded.n_shards != n_shards:
            sharded = ShardedPolicySet(n_shards, compiler=self)
        return sharded.refresh(policies)

    def subset(self, policies: list) -> CompiledPolicySet:
        """Compiled set over a *subset* of the population, assembled from
        the same dictionary and segment cache. Its tensor set snapshots
        the full path dictionary, so flatten rows memoized against the
        full population splice into this one unchanged — the delta
        scanner evaluates only the changed policies' rule columns against
        already-flattened resources this way. Does not disturb the cached
        full-set compile."""
        segs = []
        rule_refs: list[RuleRef] = []
        rule_irs = []
        idx = 0
        for policy in policies:
            key = self._policy_key(policy)
            cached = self._segments.get(key)
            if cached is not None and cached[0] == id(policy):
                seg = cached[1]
            else:
                seg = self._segment(policy, key)
                self._segments[key] = (id(policy), seg)
            segs.append(seg)
            for rule in _validate_rules(policy):
                rule_refs.append(RuleRef(policy, rule, idx))
                idx += 1
            rule_irs.extend(seg.rule_irs)
        tensors = assemble_tensors(segs, self.dictionary,
                                   rule_bucket=self.rule_bucket)
        return CompiledPolicySet(list(policies), device=self.device,
                                 _parts=(rule_refs, rule_irs, tensors))


class PolicyPartitioner:
    """Sticky, balance-aware assignment of policy segments to shards.

    The 2D mesh's ``policy`` axis partitions the rule space along the
    `IncrementalCompiler`'s natural unit — one segment per policy — so
    the assignment must satisfy two pulls at once: shards balanced by
    rule count (each shard's rule bucket pads to a power of two, so
    imbalance costs device memory), and stability across churn (a
    reassigned segment forces that shard's tensors to reassemble and its
    plan to rebuild). The resolution is *sticky greedy*: a key keeps its
    shard for as long as it lives, new keys land on the currently
    lightest shard in input order, and removed keys simply free their
    weight. Replacing a policy in place (same key) therefore touches
    exactly one shard; adds and removals touch one shard each; only a
    full repartition (``reset``) moves survivors."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self._assign: dict[str, int] = {}

    def reset(self) -> None:
        self._assign.clear()

    def plan(self, items: list[tuple[str, int]]) -> list[int]:
        """Shard index per item. ``items`` is ``(key, rule_count)`` in
        population order; dead keys are forgotten, live keys keep their
        shard, new keys go to the lightest shard by live rule count
        (ties -> lowest shard index)."""
        live = {k for k, _ in items}
        for k in [k for k in self._assign if k not in live]:
            del self._assign[k]
        load = [0] * self.n_shards
        for key, weight in items:
            s = self._assign.get(key)
            if s is not None:
                load[s] += weight
        for key, weight in items:
            if key not in self._assign:
                s = min(range(self.n_shards), key=lambda i: (load[i], i))
                self._assign[key] = s
                load[s] += weight
        return [self._assign[k] for k, _ in items]


class PolicyShard:
    """One policy-axis shard: the member policies' segments assembled
    into their own (pow2 rule-bucketed) PolicyTensors over the shared
    dictionary, plus the column map that scatters this shard's local
    verdict columns back into the full host rule layout."""

    __slots__ = ("index", "policies", "cps", "col_map", "reused",
                 "_mesh_fn_cache")

    def __init__(self, index: int, policies: list,
                 cps: CompiledPolicySet, col_map: np.ndarray,
                 reused: bool):
        self.index = index
        self.policies = policies
        self.cps = cps
        self.col_map = col_map
        self.reused = reused
        # per-mesh-row program cache, keyed by the row's devices
        # (parallel/mesh.py::shard_eval_fns): an unchanged shard keeps its
        # programs, and the plans behind them, across scans and refreshes
        self._mesh_fn_cache: dict = {}

    @property
    def n_rules_live(self) -> int:
        return self.cps.tensors.n_rules_live


class ShardedPolicySet:
    """Policy-axis decomposition of one compiled population.

    Holds the full :class:`CompiledPolicySet` (host layout: rule_refs,
    host-lane resolution, flattening — the shared dictionary means every
    shard consumes the same flattened batch) plus one
    :class:`PolicyShard` per non-empty partition bucket. Each shard's
    tensors assemble from the same segment cache via
    ``IncrementalCompiler.subset``, so a refresh recompiles only shards
    whose membership or member objects changed; untouched shards keep
    their CompiledPolicySet *instance* — tensors byte-identical, plan
    alive. Every set lives on the compiler's device."""

    def __init__(self, n_shards: int, rule_bucket: bool = True,
                 compiler: IncrementalCompiler | None = None, device=None):
        self.n_shards = int(n_shards)
        self._inc = (compiler if compiler is not None
                     else IncrementalCompiler(rule_bucket=rule_bucket,
                                              device=device))
        self.partitioner = PolicyPartitioner(self.n_shards)
        # bucket index -> (membership signature, PolicyShard)
        self._cache: dict[int, tuple[tuple, PolicyShard]] = {}
        self.full: CompiledPolicySet | None = None
        self.shards: list[PolicyShard] = []
        self.last_refresh: dict = {}

    @property
    def compiler(self) -> IncrementalCompiler:
        return self._inc

    def refresh(self, policies: list) -> "ShardedPolicySet":
        policies = list(policies)
        self.full = self._inc.refresh(policies)
        keys = [IncrementalCompiler._policy_key(p) for p in policies]
        weights = [len(_validate_rules(p)) for p in policies]
        assign = self.partitioner.plan(list(zip(keys, weights)))
        # global column base per segment, from the full assembly's
        # splice receipts (keyed by policy key == segment name)
        span = {s.name: s for s in self.full.tensors.segments}
        shards: list[PolicyShard] = []
        reassembled: list[int] = []
        for b in range(self.n_shards):
            members = [p for p, a in zip(policies, assign) if a == b]
            if not members:
                self._cache.pop(b, None)
                continue
            sig = tuple((IncrementalCompiler._policy_key(p), id(p))
                        for p in members)
            cached = self._cache.get(b)
            if cached is not None and cached[0] == sig:
                shard = cached[1]
                shard.reused = True
            else:
                cps = self._inc.subset(members)
                shard = PolicyShard(b, members, cps,
                                    np.zeros(0, np.int64), reused=False)
                self._cache[b] = (sig, shard)
                reassembled.append(b)
            # the column map depends on OTHER shards' rule counts (global
            # bases move under churn), so it refreshes even on reuse
            cols = []
            for p in members:
                sp = span[IncrementalCompiler._policy_key(p)]
                cols.append(np.arange(sp.rule_base,
                                      sp.rule_base + sp.n_rules,
                                      dtype=np.int64))
            shard.col_map = (np.concatenate(cols) if cols
                             else np.zeros(0, np.int64))
            shards.append(shard)
        self.shards = shards
        self.last_refresh = {
            "n_shards": self.n_shards,
            "shards_live": len(shards),
            "shards_reassembled": len(reassembled),
            "reassembled": reassembled,
            "shard_rules": {sh.index: sh.n_rules_live for sh in shards},
        }
        try:
            from ..runtime import metrics as metrics_mod

            metrics_mod.record_mesh_shard_rules(
                metrics_mod.registry(),
                {sh.index: sh.n_rules_live for sh in shards})
        except Exception:
            pass
        return self

    # -- convenience delegation to the full (host-layout) set ----------

    @property
    def policies(self) -> list:
        return self.full.policies

    @property
    def rule_refs(self) -> list:
        return self.full.rule_refs

    @property
    def tensors(self) -> PolicyTensors:
        return self.full.tensors

    def flatten(self, resources: list[dict]):
        return self.full.flatten(resources)

    def flatten_packed(self, *a, **kw):
        return self.full.flatten_packed(*a, **kw)

    def resolve_host_cells(self, *a, **kw):
        return self.full.resolve_host_cells(*a, **kw)

    def shard_rule_counts(self) -> dict[int, int]:
        return {sh.index: sh.n_rules_live for sh in self.shards}

    def shard_tensor_bytes(self) -> dict[int, int]:
        from .compiler import tensor_nbytes

        return {sh.index: tensor_nbytes(sh.cps.tensors)
                for sh in self.shards}

    def evaluate_device(self, batch) -> np.ndarray:
        """Full-layout device verdicts [B, R_live] assembled from the
        shards — bit-compatible with ``CompiledPolicySet.evaluate_device``
        on the same batch (each shard scores the same rows with the same
        kernels; columns scatter back through ``col_map``). Dispatches
        every shard before reading any back."""
        handles = [(sh, sh.cps.evaluate_device_async(batch))
                   for sh in self.shards]
        n_live = self.full.tensors.n_rules_live
        b = getattr(batch, "n", None)
        if b is None:
            b = int(batch.cells.shape[0])
        # int8 like the single-set device lane; uncovered columns cannot
        # exist — the partition's col_maps tile the live rule axis exactly
        out = np.full((b, n_live), int(Verdict.NOT_APPLICABLE),
                      dtype=np.int8)
        for sh, handle in handles:
            out[:, sh.col_map] = handle.get()
        return out

    def evaluate(self, resources: list[dict]) -> np.ndarray:
        """Verdict matrix [B, R]: the sharded device lane, then the full
        set's CPU oracle for HOST cells."""
        batch = self.full.flatten(resources)
        verdicts = self.evaluate_device(batch)
        return self.full.resolve_host_cells(resources, verdicts)


def shard_policies(policies: list, n_shards: int, rule_bucket: bool = True,
                   device=None) -> ShardedPolicySet:
    """One-shot policy-axis decomposition (fresh compiler). Long-lived
    callers (BackgroundScanner) should instead keep a ShardedPolicySet
    and ``refresh`` it so segment and shard caches survive churn."""
    return ShardedPolicySet(n_shards, rule_bucket=rule_bucket,
                            device=device).refresh(policies)
