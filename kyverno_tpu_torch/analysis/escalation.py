"""Escalation-provenance pass (KT1xx).

Explains *why* a rule leaves the device lattice: every host-only
``RuleIR`` carries an ``EscalationReason`` code (models/ir.py), and this
pass re-probes the rule's components — match program, preconditions,
deny conditions, pattern — to pin the escalation to the component that
first raised ``HostOnly``. It also computes the per-policy
device-decidability score (fraction of validate rules that compile to
the device lattice) that feeds the KT110 diagnostic, the
``kyverno_policy_device_decidability`` gauge, and bench output.
"""

from __future__ import annotations

from ..models.ir import (
    AUX_DENY,
    AUX_PRECOND,
    EscalationReason,
    HostOnly,
    QuantityError,
    RuleIR,
    compile_conditions,
    compile_match_program,
)
from .diagnostics import Diagnostic, make


def probe_rule_components(policy, rule) -> tuple[str, str]:
    """Replay compile_rule_ir stage by stage; return (component, detail)
    for the first stage that escalates ("" if none does — e.g. the rule
    only went host at tensor lowering)."""
    v = rule.validation
    if v.foreach:
        return "validate.foreach", "foreach rules"
    if rule.context:
        return "context", "external context"

    scratch = RuleIR(policy_name=policy.name, rule_name=rule.name,
                     rule_index=0)
    try:
        compile_match_program(rule, getattr(policy, "namespace", ""), scratch)
    except (HostOnly, QuantityError) as e:
        return "match", str(e)
    if rule.preconditions is not None:
        try:
            compile_conditions(rule.preconditions, AUX_PRECOND, scratch)
        except (HostOnly, QuantityError) as e:
            return "preconditions", str(e)
    if v.deny is not None:
        conditions = (v.deny or {}).get("conditions")
        if conditions is None:
            return "deny", "deny without conditions"
        try:
            compile_conditions(conditions, AUX_DENY, scratch)
        except (HostOnly, QuantityError) as e:
            return "deny", str(e)
        return "", ""
    if v.pattern is not None:
        return "pattern", ""
    if v.any_pattern is not None:
        return "anyPattern", ""
    return "validate", "no pattern"


def _pattern_component(rule) -> str:
    v = rule.validation
    if v.pattern is not None:
        return "pattern"
    if v.any_pattern is not None:
        return "anyPattern"
    return "validate"


def analyze_escalation(policy, rules, rule_irs) -> tuple[list[Diagnostic], float]:
    """KT101 per host-only rule, KT102 for a fully host policy, KT110 with
    the decidability score. Returns (diagnostics, device_decidability)."""
    out: list[Diagnostic] = []
    n_device = 0
    for rule, ir in zip(rules, rule_irs):
        if not ir.host_only:
            n_device += 1
            continue
        component, detail = probe_rule_components(policy, rule)
        if not component:
            # escalation came from the validate body, not match/conditions
            component = _pattern_component(rule)
        reason = ir.host_reason_code or EscalationReason.UNSUPPORTED_CONSTRUCT.value
        out.append(make(
            "KT101",
            f"escalates to the CPU oracle: {ir.host_reason or detail}",
            policy=policy.name, rule=rule.name,
            component=component, reason=reason,
        ))

    score = (n_device / len(rule_irs)) if rule_irs else 1.0
    if rule_irs and n_device == 0:
        out.append(make(
            "KT102",
            "every validate rule is host-only; the policy gains nothing "
            "from the device lattice",
            policy=policy.name,
        ))
    out.append(make(
        "KT110",
        f"device decidability {score:.2f} "
        f"({n_device}/{len(rule_irs)} validate rules on device)",
        policy=policy.name,
    ))
    return out, score
