"""Mutation engine: iterate mutate rules, chain the patched resource through
rules, re-injecting it into the JSON context so later rules and variables
see earlier patches.

Mirrors kyverno/pkg/engine/mutation.go (Mutate:31,
mutateForEachResource:128, mutateResource:201).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field

from .json_context_loader import load_context
from .match import matches_resource_description
from .mutate.handlers import MutateResult, apply_mutation
from .policy_context import PolicyContext
from .response import (
    EngineResponse,
    PolicyResponse,
    PolicySpecSummary,
    ResourceSpec,
    RuleResponse,
    RuleStatus,
    RuleType,
)
from .validation import (
    _add_element_to_context,
    check_preconditions,
    evaluate_list,
    rule_error,
    rule_response,
)
from .variables import VariableResolutionError, substitute_all


@dataclass
class _MutateOutcome:
    skip: bool = False
    patched_resource: dict | None = None
    patches: list = field(default_factory=list)
    message: str = ""


def mutate(policy_ctx: PolicyContext) -> EngineResponse:
    """mutation.go:31 Mutate."""
    start = time.monotonic()
    resp = EngineResponse(policy_response=PolicyResponse())
    policy = policy_ctx.policy
    patched_resource = policy_ctx.new_resource
    ctx = policy_ctx.json_context

    _start_mutate_response(resp, policy, patched_resource)

    ctx.checkpoint()
    try:
        for rule in policy.spec.rules:
            if not rule.has_mutate():
                continue

            ok, _ = matches_resource_description(
                patched_resource,
                rule,
                policy_ctx.admission_info,
                policy_ctx.exclude_group_role,
                policy_ctx.namespace_labels,
                policy.namespace,
            )
            if not ok:
                continue

            # Reset() drops externally-loaded context but the patched
            # resource must survive for rule chaining (mutation.go:71-80)
            try:
                resource = ctx.query("request.object")
            except Exception:
                resource = None
            ctx.reset()
            if isinstance(resource, dict):
                ctx.add_resource(resource)

            try:
                load_context(rule.context, policy_ctx, rule.name)
            except Exception:
                continue  # mutation.go:82-89: context failure skips the rule

            if rule.mutation.foreach:
                rule_resp, patched_resource = _mutate_foreach(
                    rule, policy_ctx, patched_resource
                )
            else:
                rule_resp, patched_resource = _run_mutate_rule(
                    rule, policy_ctx, patched_resource, 0
                )

            if rule_resp is not None:
                resp.policy_response.rules.append(rule_resp)
                if rule_resp.status is RuleStatus.ERROR:
                    resp.policy_response.rules_error_count += 1
                else:
                    resp.policy_response.rules_applied_count += 1
    finally:
        ctx.restore()

    resp.patched_resource = patched_resource
    resp.policy_response.processing_time_s = time.monotonic() - start
    return resp


def _run_mutate_rule(rule, policy_ctx, resource, foreach_index):
    """The single-rule wrapper around mutateResource (mutation.go:96-113)."""
    outcome, err = _mutate_resource(rule, policy_ctx, resource, foreach_index)
    if err is not None:
        status = RuleStatus.SKIP if outcome.skip else RuleStatus.ERROR
        return rule_response(rule, RuleType.MUTATION, str(err), status), resource
    message = outcome.message or "mutated resource"
    rr = rule_response(rule, RuleType.MUTATION, message, RuleStatus.PASS)
    rr.patches = outcome.patches
    return rr, outcome.patched_resource


def _mutate_foreach(rule, policy_ctx: PolicyContext, resource: dict):
    """mutation.go:128 mutateForEachResource."""
    ctx = policy_ctx.json_context
    apply_count = 0
    patched_resource = resource
    all_patches: list = []

    for foreach_index, foreach in enumerate(rule.mutation.foreach):
        try:
            load_context(foreach.context, policy_ctx, rule.name)
        except Exception as e:
            return (
                rule_error(rule, RuleType.MUTATION, "failed to load context", e),
                resource,
            )

        try:
            preconditions_passed = check_preconditions(policy_ctx, foreach.preconditions)
        except Exception as e:
            return (
                rule_error(rule, RuleType.MUTATION, "failed to evaluate preconditions", e),
                resource,
            )
        if not preconditions_passed:
            return (
                rule_response(
                    rule, RuleType.MUTATION, "preconditions not met", RuleStatus.SKIP
                ),
                resource,
            )

        try:
            elements = evaluate_list(foreach.list_expr, ctx)
        except Exception as e:
            return (
                rule_error(
                    rule, RuleType.MUTATION, f"failed to evaluate list {foreach.list_expr}", e
                ),
                resource,
            )

        ctx.checkpoint()
        try:
            for element in elements:
                ctx.reset()
                element_ctx = policy_ctx.copy()
                try:
                    _add_element_to_context(element_ctx, element)
                except Exception as e:
                    return (
                        rule_error(rule, RuleType.MUTATION, "failed to process foreach", e),
                        resource,
                    )
                outcome, err = _mutate_resource(
                    rule, element_ctx, patched_resource, foreach_index
                )
                if err is not None:
                    if outcome.skip:
                        continue  # element not matched / preconditions miss
                    return (
                        rule_response(rule, RuleType.MUTATION, str(err), RuleStatus.ERROR),
                        resource,
                    )
                if outcome.patched_resource is not None:
                    patched_resource = outcome.patched_resource
                all_patches.extend(outcome.patches)
                apply_count += 1
        finally:
            ctx.restore()

    if apply_count == 0:
        return (
            rule_response(rule, RuleType.MUTATION, "0 elements processed", RuleStatus.SKIP),
            resource,
        )
    rr = rule_response(
        rule, RuleType.MUTATION, f"{apply_count} elements processed", RuleStatus.PASS
    )
    rr.patches = all_patches
    return rr, patched_resource


def _mutate_resource(rule, policy_ctx: PolicyContext, resource: dict, foreach_index: int):
    """mutation.go:201 mutateResource -> (outcome, error-or-None)."""
    ctx = policy_ctx.json_context
    outcome = _MutateOutcome()

    try:
        preconditions_passed = check_preconditions(policy_ctx, rule.preconditions)
    except Exception as e:
        return outcome, e
    if not preconditions_passed:
        outcome.skip = True
        return outcome, Exception("preconditions mismatch")

    try:
        mutation = _substitute_mutation(ctx, rule.mutation, foreach_index)
    except VariableResolutionError as e:
        return outcome, Exception(f"variable substitution failed: {e}")

    result: MutateResult = apply_mutation(mutation, resource, foreach_index)

    if result.status is RuleStatus.PASS:
        # an anchor-gated patch that matched nothing produces no patches:
        # the rule is reported as skipped (mutation.go:231-236)
        if not result.patches:
            outcome.skip = True
            if result.patched_resource is not None:
                ctx.add_resource(result.patched_resource)
            return outcome, Exception("resource does not match pattern")
        outcome.patched_resource = result.patched_resource
        outcome.patches = result.patches
        outcome.message = result.message
    elif result.status is RuleStatus.FAIL:
        return outcome, Exception(result.message)

    if result.patched_resource is not None:
        ctx.add_resource(result.patched_resource)
    return outcome, None


def _substitute_mutation(ctx, mutation, foreach_index: int = 0):
    """variables.SubstituteAllInRule scoped to the mutation block. Only the
    foreach entry selected by ``foreach_index`` is substituted — it is the
    only one apply_mutation will use for this element."""
    substituted = copy.copy(mutation)
    if mutation.patch_strategic_merge is not None:
        substituted.patch_strategic_merge = substitute_all(
            ctx, mutation.patch_strategic_merge
        )
    if mutation.overlay is not None:
        substituted.overlay = substitute_all(ctx, mutation.overlay)
    if mutation.patches:
        substituted.patches = substitute_all(ctx, mutation.patches)
    if mutation.patches_json6902:
        substituted.patches_json6902 = substitute_all(ctx, mutation.patches_json6902)
    if mutation.foreach:
        substituted.foreach = list(mutation.foreach)
        fe = mutation.foreach[foreach_index]
        fe_copy = copy.copy(fe)
        if fe.patch_strategic_merge is not None:
            fe_copy.patch_strategic_merge = substitute_all(ctx, fe.patch_strategic_merge)
        substituted.foreach[foreach_index] = fe_copy
    return substituted


def _start_mutate_response(resp: EngineResponse, policy, resource: dict) -> None:
    meta = (resource or {}).get("metadata") or {}
    resp.policy_response.policy = PolicySpecSummary(
        name=policy.name,
        validation_failure_action=policy.spec.validation_failure_action,
    )
    resp.policy_response.resource = ResourceSpec(
        kind=(resource or {}).get("kind", ""),
        api_version=(resource or {}).get("apiVersion", ""),
        namespace=meta.get("namespace", ""),
        name=meta.get("name", ""),
    )
