"""Shared CLI engine driver (mirrors kyverno/pkg/kyverno/common/
common.go:447 ApplyPolicyOnResource): Mutate -> Validate -> Generate filter
against one (policy, resource), offline, exactly like the server path."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..engine.context import Context
from ..engine.generation import generate
from ..engine.mutation import mutate
from ..engine.policy_context import PolicyContext
from ..engine.response import EngineResponse, RuleStatus
from ..engine.validation import validate
from ..engine.json_context_loader import variable_to_json


@dataclass
class ResultCounts:
    """common.go ResultCounts: pass/fail/warn/error/skip tallies."""

    pass_: int = 0
    fail: int = 0
    warn: int = 0
    error: int = 0
    skip: int = 0

    def count(self, status: RuleStatus) -> None:
        if status is RuleStatus.PASS:
            self.pass_ += 1
        elif status is RuleStatus.FAIL:
            self.fail += 1
        elif status is RuleStatus.WARN:
            self.warn += 1
        elif status is RuleStatus.ERROR:
            self.error += 1
        elif status is RuleStatus.SKIP:
            self.skip += 1


@dataclass
class ApplyResult:
    mutate_response: EngineResponse | None = None
    validate_response: EngineResponse | None = None
    generate_response: EngineResponse | None = None

    @property
    def responses(self) -> list[EngineResponse]:
        return [
            r
            for r in (self.mutate_response, self.validate_response, self.generate_response)
            if r is not None
        ]


def apply_policy_on_resource(
    policy,
    resource: dict,
    variables: dict[str, str] | None = None,
    namespace_labels_map: dict[str, dict[str, str]] | None = None,
    rc: ResultCounts | None = None,
) -> ApplyResult:
    """common.go:447 ApplyPolicyOnResource."""
    variables = variables or {}
    namespace_labels_map = namespace_labels_map or {}
    result = ApplyResult()

    namespace = (resource.get("metadata") or {}).get("namespace", "")
    namespace_labels = namespace_labels_map.get(namespace, {})

    ctx = Context()
    if variables.get("request.operation") == "DELETE":
        ctx.add_old_resource(resource)
    else:
        ctx.add_resource(resource)
    for key, value in variables.items():
        ctx.add_json(variable_to_json(key, value))
    try:
        ctx.add_image_info(resource)
    except Exception:
        pass

    has_mutate = any(r.has_mutate() for r in policy.spec.rules)
    has_validate = any(r.has_validate() for r in policy.spec.rules)
    has_generate = any(r.has_generate() for r in policy.spec.rules)

    patched = resource
    if has_mutate:
        mutate_ctx = PolicyContext(
            policy=policy, new_resource=resource, json_context=ctx,
            namespace_labels=namespace_labels,
        )
        result.mutate_response = mutate(mutate_ctx)
        patched = result.mutate_response.patched_resource or resource
        if rc is not None:
            for r in result.mutate_response.policy_response.rules:
                rc.count(r.status)

    if has_validate:
        validate_ctx = PolicyContext(
            policy=policy, new_resource=patched, json_context=ctx,
            namespace_labels=namespace_labels,
        )
        result.validate_response = validate(validate_ctx)
        if rc is not None:
            for r in result.validate_response.policy_response.rules:
                rc.count(r.status)

    if has_generate:
        generate_ctx = PolicyContext(
            policy=policy, new_resource=resource, json_context=ctx,
            namespace_labels=namespace_labels,
        )
        result.generate_response = generate(generate_ctx)
        if rc is not None:
            for r in result.generate_response.policy_response.rules:
                rc.count(r.status)

    return result
