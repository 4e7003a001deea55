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

The device is ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request the constructor raises.
"""

from __future__ import annotations

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
from .compiler import PolicyTensors, compile_tensors
from .flatten import FlatBatch
from .ir import compile_rule_ir


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


class AsyncVerdicts:
    """Handle on an in-flight device evaluation. :meth:`get` waits on the
    CUDA event recorded after the launches, copies the matrix to the host
    once and caches it."""

    __slots__ = ("_out", "_event", "_verdicts")

    def __init__(self, out: torch.Tensor):
        self._out = out
        self._event = None
        if out.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(out.device))
        self._verdicts: np.ndarray | None = None

    def get(self) -> np.ndarray:
        if self._verdicts is None:
            if self._event is not None:
                self._event.synchronize()
            self._verdicts = self._out.cpu().numpy()
            self._out = None
        return self._verdicts


class CompiledPolicySet:
    def __init__(self, policies: list, device=None,
                 tensors: PolicyTensors | None = None):
        """``tensors`` — an already compiled ``PolicyTensors`` (e.g. carried
        across with ``convert.tensors_from_numpy``); by default the
        policies compile here."""
        self.device = resolve_device(device)
        self.policies = list(policies)
        self.rule_refs: list[RuleRef] = []
        self.rule_irs = []
        idx = 0
        for policy in self.policies:
            for rule in policy.spec.rules:
                if not rule.has_validate():
                    continue
                self.rule_refs.append(RuleRef(policy, rule, idx))
                if tensors is None:
                    self.rule_irs.append(compile_rule_ir(policy, rule, idx))
                idx += 1
        self.tensors: PolicyTensors = (
            tensors if tensors is not None else compile_tensors(self.rule_irs))
        self.plan = Plan(self.tensors, self.device)

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

    # ------------------------------------------------------------ device

    def _launch(self, batch) -> torch.Tensor:
        dblob, shp = self.to_device(batch)
        return ops_eval.evaluate_blob(self.plan, dblob, *shp)[
            :, :self.tensors.n_rules_live]

    def evaluate_device(self, batch) -> np.ndarray:
        """Device verdicts int8 [B, n_rules_live] (host-lane cells HOST)."""
        return self._launch(batch).cpu().numpy()

    def evaluate_device_async(self, batch) -> AsyncVerdicts:
        """Launch the device evaluation without waiting for it."""
        return AsyncVerdicts(self._launch(batch))

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
