"""Analyzer orchestrator: policies -> AnalysisReport.

Compiles each policy's validate rules with ``compile_rule_ir`` (and the
full set with ``compile_tensors`` when ``include_tensors``) and runs the
three passes — escalation provenance, reachability/conflict, tensor
invariants. Deliberately engine-free: no ``CompiledPolicySet``, no torch,
so ``kyverno-tpu lint`` runs on a host with no accelerator stack warm.
"""

from __future__ import annotations

from ..models.compiler import compile_tensors
from ..models.ir import compile_rule_ir
from .diagnostics import (
    AnalysisReport,
    Diagnostic,
    parse_suppressions,
    policy_suppressions,
)
from .escalation import analyze_escalation
from .invariants import check_batch, check_padded, check_tensors
from .reachability import analyze_reachability


def _validate_rules(policy):
    return [r for r in policy.spec.rules if r.has_validate()]


def analyze_policies(policies, include_tensors: bool = True,
                     suppress=()) -> AnalysisReport:
    """Run all static passes over ``policies`` (parsed ClusterPolicy
    objects). ``suppress`` drops diagnostic codes globally; per-policy
    suppression comes from the ``kyverno-tpu.io/lint-suppress``
    annotation."""
    report = AnalysisReport()
    global_suppress = set(suppress)
    if isinstance(suppress, str):
        global_suppress = parse_suppressions(suppress)

    all_irs = []
    idx = 0
    for policy in policies:
        rules = _validate_rules(policy)
        irs = [compile_rule_ir(policy, rule, idx + i)
               for i, rule in enumerate(rules)]
        idx += len(rules)
        all_irs.extend(irs)

        diags, score = analyze_escalation(policy, rules, irs)
        diags += analyze_reachability(policy, rules, irs)
        skip = global_suppress | policy_suppressions(policy)
        report.diagnostics += [d for d in diags if d.code not in skip]
        report.device_decidability[policy.name] = score

    if include_tensors and all_irs:
        tensor_diags = check_tensors(compile_tensors(all_irs))
        tensor_diags += _check_incremental(policies)
        report.diagnostics += [d for d in tensor_diags
                               if d.code not in global_suppress]
    _export_findings(report.diagnostics)
    return report


def _export_findings(diagnostics) -> None:
    """Feed ``kyverno_lint_findings_total{code,severity}`` — every
    surviving diagnostic counts once, whether the caller is admission
    lint (policycache) or the CLI. Best-effort: the analyzer stays
    usable in contexts with no runtime package."""
    try:
        from ..runtime.metrics import record_lint_finding, registry

        reg = registry()
        for d in diagnostics:
            record_lint_finding(reg, d.code, d.severity.name)
    except Exception:
        pass


def _check_incremental(policies) -> list[Diagnostic]:
    """Lint the *segmented* assembly too: with KTPU_INCREMENTAL on the
    runtime serves tensors built by per-policy segment splice (rebased
    offsets, bucket-padded rule axis), not the monolithic compile — so
    ``kyverno-tpu lint`` must validate that set, including the KT304
    splice receipts. Still torch-free (pure compiler + numpy)."""
    from ..models.compiler import (
        TensorDictionary,
        assemble_tensors,
        compile_segment,
        incremental_enabled,
    )

    if not incremental_enabled():
        return []
    dictionary = TensorDictionary(persistent=True)
    segs = []
    for policy in policies:
        rules = _validate_rules(policy)
        seg_irs = [compile_rule_ir(policy, rule, li)
                   for li, rule in enumerate(rules)]
        segs.append(compile_segment(seg_irs, dictionary, name=policy.name))
    return check_tensors(assemble_tensors(segs, dictionary,
                                          rule_bucket=True))


def lint_batch(batch, orig_n: int | None = None,
               suppress=()) -> list[Diagnostic]:
    """Invariant-check one FlatBatch (padded when ``orig_n`` is given) —
    the runtime-side entry point used by tests and debugging hooks."""
    skip = set(suppress)
    diags = (check_padded(batch, orig_n) if orig_n is not None
             else check_batch(batch))
    return [d for d in diags if d.code not in skip]
