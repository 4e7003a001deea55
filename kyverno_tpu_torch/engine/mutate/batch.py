"""Batched mutate tier: device-gated screening + single-pass merge/patch.

The anchor-condition gate is batched on the card, so that only matching
resources reach the CPU mutator. Each mutate rule's gate
(match/exclude/preconditions) compiles into the same device tensors a
validate rule's gate does — with an empty pattern, so a gate that passes
scores PASS and a non-matching resource scores NOT_APPLICABLE/SKIP. One
device evaluation (K1 -> eval_rules, then the host lane for its HOST
cells) screens the whole batch; documents no rule touches never reach the
CPU mutator.

For documents that do, a compiled fast path applies the strategic merge and
emits the RFC6902 ops in one walk (``merge_emit``), skipping the per-doc
context build, variable-substitution scan, and full-tree diff of the serial
engine — while producing byte-identical patches (parity suites in
tests/test_torch_batch_mutate.py). Rules the fast path cannot prove static
(variables, foreach, external context) fall back to the full engine per
document, so coverage is total.

Errors: a failure of any step of the device gate (the flatten, a kernel
build, a launch, a device copy, the host lane's resolve of the HOST
cells) propagates out of :meth:`BatchMutator.gate_verdicts` and
:meth:`BatchMutator.apply`; the batch is never re-gated on the host. The
one use of the host gate beside the device lane is a resolved gate cell
that holds an ERROR: that rule of that document is gated on the host,
counted in :data:`GATE_FALLBACKS` and logged.

Reference semantics: kyverno/pkg/engine/mutation.go:31 (Mutate,
rule chaining), mutate/strategicMergePatch.go:85 (preprocess + merge),
mutate/patchesUtils.go:12 (generatePatches).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ...api.types import ClusterPolicy, Rule, Spec, Validation
from ...utils.jsoncopy import json_copy
from ..context import Context
from ..match import matches_resource_description
from ..policy_context import PolicyContext
from .handlers import apply_mutation
from .json_patch import _diff, escape_token, filter_and_sort_patches
from .strategic_merge import (
    ConditionError,
    GlobalConditionError,
    _find_merge_key,
    _has_anchor,
    _has_anchors,
    merge,
    pre_process_pattern,
)

_log = logging.getLogger(__name__)

# uses of the host gate in place of the device gate's answer: ``cell`` — a
# resolved gate cell held neither PASS nor SKIP / NOT_APPLICABLE (an
# ERROR), and that one rule of that document was gated on the host. A
# failure of the device gate itself is never caught.
GATE_FALLBACKS = {"cell": 0}
_fallback_lock = threading.Lock()


def _count_fallback(cause: str) -> None:
    with _fallback_lock:
        GATE_FALLBACKS[cause] += 1


def reset_gate_fallbacks() -> None:
    with _fallback_lock:
        for k in GATE_FALLBACKS:
            GATE_FALLBACKS[k] = 0

# ------------------------------------------------------- fast merge + ops


def merge_emit(patch, base, path: str, ops: list) -> object:
    """``merge(patch, base)`` plus the RFC6902 ops that
    ``_diff(base, merge(patch, base))`` would emit — in one walk that never
    visits siblings the patch does not touch. Op order matches _diff
    exactly: base-key iteration order for removals/changes, then patch-key
    order for additions; keyed-list merges compare touched indices
    ascending and append new elements at the tail."""
    if isinstance(patch, dict) and isinstance(base, dict):
        out = dict(base)
        for key in base:
            if key not in patch:
                continue
            p = f"{path}/{escape_token(key)}"
            if patch[key] is None:
                del out[key]
                ops.append({"op": "remove", "path": p})
            else:
                out[key] = merge_emit(patch[key], base[key], p, ops)
        for key, value in patch.items():
            if key in base or value is None:
                continue
            value = json_copy(value)
            out[key] = value
            ops.append({"op": "add", "path": f"{path}/{escape_token(key)}",
                        "value": value})
        return out
    if isinstance(patch, list) and isinstance(base, list):
        if patch and base:
            key = _find_merge_key(patch)
            if key is not None and all(isinstance(e, dict) and key in e
                                       for e in base):
                out = list(base)
                index = {e[key]: i for i, e in enumerate(out)}
                touched = set()
                appended = []
                for el in patch:
                    i = index.get(el[key])
                    if i is not None:
                        touched.add(i)
                        out[i] = merge(el, out[i])
                    else:
                        appended.append(json_copy(el))
                for i in sorted(touched):
                    _diff(base[i], out[i], f"{path}/{i}", ops)
                for j, el in enumerate(appended):
                    out.append(el)
                    ops.append({"op": "add",
                                "path": f"{path}/{len(base) + j}",
                                "value": el})
                return out
        out = json_copy(patch)
        _diff(base, out, path, ops)
        return out
    out = json_copy(patch)
    _diff(base, out, path, ops)
    return out


def fast_strategic_merge(resource: dict, overlay, has_anchors: bool):
    """strategic_merge_patch + generate_patches in a single pass.
    Returns (patched_resource, ops); a condition failure returns the
    resource unchanged with no ops (the reference substitutes an empty
    patch, strategicMergePatch.go:29)."""
    if has_anchors:
        try:
            patch = pre_process_pattern(overlay, resource)
        except (ConditionError, GlobalConditionError):
            return resource, []
    else:
        patch = overlay
    ops: list = []
    patched = merge_emit(patch, resource, "", ops)
    return patched, filter_and_sort_patches(ops)


# ------------------------------------------------------------- batch tier


def _is_static_mutation(rule: Rule) -> bool:
    """A rule the fast path may apply: no external context, no foreach, and
    no variable/reference syntax anywhere in the mutation block (escaped
    forms included — the engine's substitution pass would rewrite them)."""
    if rule.context or rule.mutation.foreach:
        return False
    blob = json.dumps([
        rule.mutation.patch_strategic_merge,
        rule.mutation.overlay,
        rule.mutation.patches,
        rule.mutation.patches_json6902,
    ], default=str)
    return "{{" not in blob and "$(" not in blob


@dataclass
class _FastRule:
    rule: Rule
    overlay: object          # strategic-merge pattern or None (6902/raw)
    has_anchors: bool
    gate_index: int          # column in the gate verdict matrix


@dataclass
class DocMutation:
    patches: list = field(default_factory=list)
    patched_resource: dict | None = None


class BatchMutator:
    """Compile a policy set's mutate tier once; apply it to many documents.

    The serial-engine equivalent of ``apply([doc])`` is the webhook's
    per-policy chain (mutation.go:110: rule N's patched resource feeds rule
    N+1); parity is asserted patch-for-patch in the test suite."""

    def __init__(self, policies: list, min_gate_batch: int = 64,
                 device=None):
        """``device`` — where the gate policy set lives: ``cuda`` unless
        the caller passes ``device="cpu"`` (the plain versions)."""
        self.policies = [p for p in policies
                         if any(r.has_mutate() for r in p.spec.rules)]
        self.min_gate_batch = min_gate_batch
        self.plan: list[tuple] = []      # (policy, "fast"|"engine", rules)
        gate_policies: list[ClusterPolicy] = []
        n_gates = 0
        for policy in self.policies:
            fast_rules: list[_FastRule] = []
            ok = True
            for rule in policy.spec.rules:
                if not rule.has_mutate():
                    continue
                if not _is_static_mutation(rule):
                    ok = False
                    break
                overlay = (rule.mutation.patch_strategic_merge
                           if rule.mutation.patch_strategic_merge is not None
                           else rule.mutation.overlay)
                fast_rules.append(_FastRule(
                    rule=rule, overlay=overlay,
                    has_anchors=_has_anchors(overlay, _has_anchor),
                    gate_index=-1))
            if ok and fast_rules:
                # gate columns are assigned only for policies that stay
                # fast — a discarded policy must not shift later columns
                for fr in fast_rules:
                    fr.gate_index = n_gates
                    n_gates += 1
                self.plan.append((policy, "fast", fast_rules))
                # synthetic gate policy: the mutate rule's match/exclude/
                # preconditions with an empty validate pattern — PASS means
                # "this rule applies to this resource"
                gate_policies.append(ClusterPolicy(
                    api_version=policy.api_version, kind=policy.kind,
                    metadata=dict(policy.metadata),
                    spec=Spec(rules=[
                        Rule(name=fr.rule.name, match=fr.rule.match,
                             exclude=fr.rule.exclude,
                             preconditions=fr.rule.preconditions,
                             validation=Validation(pattern={}))
                        for fr in fast_rules])))
            else:
                self.plan.append((policy, "engine", None))
        self._gate_cps = None
        self._gate_trivial = True
        self._gate_choice: bool | None = None   # measured lane decision
        if gate_policies:
            from ...models import CompiledPolicySet

            self._gate_cps = CompiledPolicySet(gate_policies, device=device)
            t = self._gate_cps.tensors
            # a gate is "trivial" when it only checks resource kinds — the
            # host comparison is then cheaper than shipping the batch to
            # the device; selectors, name globs, preconditions or exclude
            # predicates make the device screen pay for itself
            self._gate_trivial = (
                len(t.chk_path) == 0
                and bool((np.asarray(t.ax_path) < 0).all())
                and bool((np.asarray(t.ax_nfa) < 0).all()))

    # ------------------------------------------------------------- gates

    def _host_gate(self, policy, rule: Rule, resource: dict) -> bool:
        ok, _ = matches_resource_description(
            resource, rule, policy_namespace=policy.namespace)
        if not ok:
            return False
        if rule.preconditions is None:
            return True
        from ..validation import check_preconditions

        jctx = Context()
        jctx.add_resource(resource)
        pctx = PolicyContext(policy=policy, new_resource=resource,
                             json_context=jctx)
        try:
            return check_preconditions(pctx, rule.preconditions)
        except Exception:
            return False

    def gate_verdicts(self, resources: list[dict],
                      chunk: int = 8192) -> np.ndarray | None:
        """Device-screen the gate matrix (HOST cells resolved by the host
        lane), chunked so a large scan never ships one giant transfer.
        Chunks pad to power-of-two shape buckets, so the card sees one
        shape a bucket, not one a chunk. A failure of any step raises;
        None means no gate policy."""
        from ...models.flatten import pad_to_buckets_packed

        if self._gate_cps is None:
            return None
        outs = []
        for i in range(0, len(resources), chunk):
            rs = resources[i:i + chunk]
            batch, n0 = pad_to_buckets_packed(
                self._gate_cps.flatten_packed(rs))
            v = self._gate_cps.evaluate_device(batch)[:n0]
            outs.append(self._gate_cps.resolve_host_cells(rs, v))
        return outs[0] if len(outs) == 1 else np.vstack(outs)

    def _auto_gate(self, resources: list[dict]) -> bool:
        """Measured routing, same philosophy as the admission router
        (runtime/batch.py): the device screen engages only when its
        measured per-doc cost beats the host gate's — behind a high-RTT
        link the host comparison wins, on a local chip the device does.
        The choice is calibrated once on a sample and cached. A failure
        of the device gate raises here too."""
        if (self._gate_cps is None or self._gate_trivial
                or len(resources) < self.min_gate_batch):
            return False
        if self._gate_choice is not None:
            return self._gate_choice
        sample = resources[:128]
        self.gate_verdicts(sample[:8])          # warm the shape buckets
        t0 = time.monotonic()
        self.gate_verdicts(sample)
        dev_per_doc = (time.monotonic() - t0) / len(sample)
        fast_pairs = [(p, fr.rule) for p, mode, frs in self.plan
                      if mode == "fast" for fr in frs]
        t0 = time.monotonic()
        for doc in sample:
            for policy, rule in fast_pairs:
                self._host_gate(policy, rule, doc)
        host_per_doc = (time.monotonic() - t0) / len(sample)
        self._gate_choice = dev_per_doc < host_per_doc
        return self._gate_choice

    # ------------------------------------------------------------- apply

    def apply(self, resources: list[dict],
              use_device_gate: bool | None = None) -> list[DocMutation]:
        from ...models import Verdict

        gate = None
        if use_device_gate is None:
            use_device_gate = self._auto_gate(resources)
        if use_device_gate:
            gate = self.gate_verdicts(resources)

        out: list[DocMutation] = []
        for b, doc in enumerate(resources):
            resource = doc
            patches: list = []
            dirty = False   # a patch landed: later gates must re-check on
            #                 the patched doc (mutation.go:110 chaining)
            for policy, mode, fast_rules in self.plan:
                if mode == "engine":
                    from ..mutation import mutate as engine_mutate

                    jctx = Context()
                    jctx.add_resource(resource)
                    resp = engine_mutate(PolicyContext(
                        policy=policy, new_resource=resource,
                        json_context=jctx))
                    if resp.patches:
                        patches.extend(resp.patches)
                        dirty = True
                    if resp.patched_resource is not None:
                        resource = resp.patched_resource
                    continue
                for fr in fast_rules:
                    applies = None
                    if gate is not None and not dirty:
                        v = int(gate[b, fr.gate_index])
                        if v == Verdict.PASS:
                            applies = True
                        elif v in (Verdict.SKIP, Verdict.NOT_APPLICABLE):
                            applies = False
                        else:
                            # ERROR/unexpected -> conservative host gate
                            _count_fallback("cell")
                            _log.warning(
                                "mutate gate: cell (%d, %s) holds verdict %d; "
                                "that rule is gated on the host", b,
                                fr.rule.name, v)
                    if applies is None:
                        applies = self._host_gate(policy, fr.rule, resource)
                    if not applies:
                        continue
                    if fr.overlay is not None:
                        patched, ops = fast_strategic_merge(
                            resource, fr.overlay, fr.has_anchors)
                    else:
                        result = apply_mutation(fr.rule.mutation, resource)
                        patched, ops = result.patched_resource, result.patches
                    if ops:
                        patches.extend(ops)
                        resource = patched
                        dirty = True
            out.append(DocMutation(patches=patches, patched_resource=resource))
        return out
