"""CompiledPolicySet: compile policies once, score resource batches on the card.

``CompiledPolicySet(policies)`` compiles the policies to ``PolicyTensors``
and turns them into a device plan (``ops/plan.py``) once. ``flatten``
gives a ``FlatBatch`` whose ``packed_blob()`` is the one buffer copied to
the card; ``evaluate_device`` returns the int8 verdict matrix
[B, n_rules_live], and ``scan_counts`` the per-rule counts of the
background scan. HOST cells (code 5) stay HOST: they belong to the CPU
oracle, which this package does not carry yet.

The device is ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request the constructor raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch

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

