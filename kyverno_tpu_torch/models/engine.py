"""CompiledPolicySet: compile policies once, score resource batches on the
card, resolve what the card cannot score on the CPU.

``CompiledPolicySet(policies)`` compiles the policies to ``PolicyTensors``
and turns them into a device plan (``ops/plan.py``) once. ``flatten``
gives a ``FlatBatch`` whose ``packed_blob()`` is the one buffer copied to
the card; ``evaluate_device`` returns the int8 verdict matrix
[B, n_rules_live], in which host-lane cells read HOST (code 5), and
``scan_counts`` the per-rule counts of the background scan.
``evaluate`` is the whole path: flatten, the device verdicts, then
``resolve_host_cells``, which turns every HOST cell into the CPU oracle's
verdict (``engine/validation.py``), so that no HOST cell is left.

The device is ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request the constructor raises.
"""

from __future__ import annotations

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
from .flatten import FlatBatch, flatten_batch
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
        return flatten_batch(resources, self.tensors, requests=requests)

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

    def resolve_host_cells(self, resources: list[dict],
                           verdicts: np.ndarray,
                           contexts: list | None = None,
                           rule_filter=None,
                           messages_out: dict | None = None,
                           copy: bool = False) -> np.ndarray:
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

        One oracle pass per resource, in row order; an oracle exception
        propagates and leaves no cell quietly HOST."""
        if copy:
            verdicts = verdicts.copy()
        host_cells = np.argwhere(verdicts == Verdict.HOST)
        by_resource: dict[int, list[int]] = {}
        for b, r in host_cells:
            if rule_filter is not None and int(r) not in rule_filter:
                continue
            by_resource.setdefault(int(b), []).append(int(r))
        for b, rows in by_resource.items():
            context = contexts[b] if contexts is not None else None
            oracle = self._oracle_verdicts(resources[b], rows, context)
            for r, (v, msg) in oracle.items():
                verdicts[b, r] = v
                if messages_out is not None:
                    messages_out[(b, r)] = msg
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
