"""Validation driver: iterate rules, match -> context -> preconditions ->
pattern / anyPattern / deny / foreach.

Mirrors kyverno/pkg/engine/validation.go (Validate:26,
validateResource:78, validator.validate:175, validateForEach:204,
validatePatterns:421). Pure function of PolicyContext -> EngineResponse; the
device path (kyverno_tpu_torch.models / kyverno_tpu_torch.ops) compiles the
same semantics into batched kernels and is cross-checked against this
implementation.
"""

from __future__ import annotations

import time

from .json_context_loader import load_context
from .match import matches_resource_description
from .operators import evaluate_conditions
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
from .validate_pattern import match_pattern
from .variables import (
    VariableResolutionError,
    substitute_all,
    substitute_all_in_preconditions,
)


def validate(policy_ctx: PolicyContext) -> EngineResponse:
    """validation.go:26 Validate."""
    start = time.monotonic()
    resp = _validate_resource(policy_ctx)
    _build_response(policy_ctx, resp, start)
    return resp


def _build_response(ctx: PolicyContext, resp: EngineResponse, start: float) -> None:
    """validation.go:53 buildResponse."""
    if resp.patched_resource is None:
        # for DELETE the patched resource is the old resource
        resp.patched_resource = ctx.new_resource or ctx.old_resource

    resource = resp.patched_resource or {}
    meta = resource.get("metadata") or {}
    resp.policy_response.policy = PolicySpecSummary(
        name=ctx.policy.name,
        validation_failure_action=ctx.policy.spec.validation_failure_action,
    )
    resp.policy_response.resource = ResourceSpec(
        kind=resource.get("kind", ""),
        api_version=resource.get("apiVersion", ""),
        namespace=meta.get("namespace", ""),
        name=meta.get("name", ""),
        uid=meta.get("uid", ""),
    )
    resp.policy_response.processing_time_s = time.monotonic() - start


def _validate_resource(ctx: PolicyContext) -> EngineResponse:
    """validation.go:78 validateResource."""
    resp = EngineResponse(policy_response=PolicyResponse())

    ctx.json_context.checkpoint()
    try:
        for rule in ctx.policy.spec.rules:
            if not rule.has_validate():
                continue
            if not _matches(rule, ctx):
                continue
            ctx.json_context.reset()
            start = time.monotonic()
            rule_resp = _process_validation_rule(ctx, rule)
            if rule_resp is not None:
                _add_rule_response(resp, rule_resp, start)
    finally:
        ctx.json_context.restore()

    return resp


def _matches(rule, ctx: PolicyContext) -> bool:
    """validation.go:383 matches: new OR old resource satisfies match/exclude.

    The reference passes "" for policyNamespace here (validation.go:384)
    because its webhook always pre-filters namespaced policies through the
    policy cache (policycache/cache.go:89). This engine is also entered with
    unfiltered policy sets (CompiledPolicySet, CLI), so the namespace gate of
    utils.go:272 is applied here, as the reference's mutation path does
    (mutation.go:63)."""
    ns = ctx.policy.namespace if ctx.policy is not None else ""
    ok, _ = matches_resource_description(
        ctx.new_resource,
        rule,
        ctx.admission_info,
        ctx.exclude_group_role,
        ctx.namespace_labels,
        ns,
    )
    if ok:
        return True
    if ctx.old_resource:
        ok, _ = matches_resource_description(
            ctx.old_resource,
            rule,
            ctx.admission_info,
            ctx.exclude_group_role,
            ctx.namespace_labels,
            ns,
        )
        if ok:
            return True
    return False


def _process_validation_rule(ctx: PolicyContext, rule) -> RuleResponse | None:
    if rule.validation.foreach:
        return _Validator.for_rule(ctx, rule).validate_foreach()
    return _Validator.for_rule(ctx, rule).validate()


def _add_rule_response(resp: EngineResponse, rule_resp: RuleResponse, start: float) -> None:
    """validation.go:118 addRuleResponse."""
    rule_resp.processing_time_s = time.monotonic() - start
    if rule_resp.status in (RuleStatus.PASS, RuleStatus.FAIL):
        resp.policy_response.rules_applied_count += 1
    elif rule_resp.status is RuleStatus.ERROR:
        resp.policy_response.rules_error_count += 1
    resp.policy_response.rules.append(rule_resp)


def check_preconditions(ctx: PolicyContext, any_all_conditions) -> bool:
    """utils.go:445 checkPreconditions. Raises on substitution failure."""
    if any_all_conditions is None:
        return True
    substituted = substitute_all_in_preconditions(ctx.json_context, any_all_conditions)
    conditions = transform_conditions(substituted)
    return evaluate_conditions(conditions)


def transform_conditions(original):
    """utils.go:392 transformConditions: accept {any/all} dict or bare list."""
    if isinstance(original, dict):
        if set(original) <= {"any", "all"}:
            return original
        raise ValueError("invalid preconditions")
    if isinstance(original, list):
        return original
    raise ValueError("invalid preconditions")


def evaluate_list(jmespath_expr: str, json_ctx):
    """utils.go:460 evaluateList: non-list results wrap into a single-element
    list."""
    result = json_ctx.query(jmespath_expr)
    if isinstance(result, list):
        return result
    return [result]


def rule_response(rule, rule_type: RuleType, msg: str, status: RuleStatus) -> RuleResponse:
    return RuleResponse(name=rule.name, type=rule_type, message=msg, status=status)


def rule_error(rule, rule_type: RuleType, msg: str, err: Exception) -> RuleResponse:
    return RuleResponse(
        name=rule.name,
        type=rule_type,
        message=f"{msg}: {err}",
        status=RuleStatus.ERROR,
    )


class _Validator:
    """validation.go:132 validator struct."""

    def __init__(self, ctx, rule, context_entries, conditions, pattern, any_pattern, deny):
        self.ctx = ctx
        self.rule = rule
        self.context_entries = context_entries
        self.any_all_conditions = conditions
        self.pattern = pattern
        self.any_pattern = any_pattern
        self.deny = deny

    @classmethod
    def for_rule(cls, ctx: PolicyContext, rule) -> "_Validator":
        return cls(
            ctx,
            rule,
            rule.context,
            rule.preconditions,
            rule.validation.pattern,
            rule.validation.any_pattern,
            rule.validation.deny,
        )

    @classmethod
    def for_foreach(cls, ctx: PolicyContext, rule, foreach) -> "_Validator":
        """validation.go:156 newForeachValidator."""
        return cls(
            ctx,
            rule,
            foreach.context,
            foreach.preconditions,
            foreach.pattern,
            foreach.any_pattern,
            foreach.deny,
        )

    # ------------------------------------------------------------ driver

    def validate(self) -> RuleResponse | None:
        """validation.go:175 validator.validate."""
        try:
            load_context(self.context_entries, self.ctx, self.rule.name)
        except Exception as e:
            return rule_error(self.rule, RuleType.VALIDATION, "failed to load context", e)

        try:
            preconditions_passed = check_preconditions(self.ctx, self.any_all_conditions)
        except Exception as e:
            return rule_error(
                self.rule, RuleType.VALIDATION, "failed to evaluate preconditions", e
            )
        if not preconditions_passed:
            return rule_response(
                self.rule, RuleType.VALIDATION, "preconditions not met", RuleStatus.SKIP
            )

        if self.pattern is not None or self.any_pattern is not None:
            try:
                self._substitute_patterns()
            except VariableResolutionError as e:
                return rule_error(
                    self.rule, RuleType.VALIDATION, "variable substitution failed", e
                )
            return self._validate_resource_with_rule()

        if self.deny is not None:
            return self._validate_deny()

        return None  # invalid rule: neither patterns nor deny

    def validate_foreach(self) -> RuleResponse | None:
        """validation.go:204 validateForEach."""
        try:
            load_context(self.context_entries, self.ctx, self.rule.name)
        except Exception as e:
            return rule_error(self.rule, RuleType.VALIDATION, "failed to load context", e)

        try:
            preconditions_passed = check_preconditions(self.ctx, self.any_all_conditions)
        except Exception as e:
            return rule_error(
                self.rule, RuleType.VALIDATION, "failed to evaluate preconditions", e
            )
        if not preconditions_passed:
            return rule_response(
                self.rule, RuleType.VALIDATION, "preconditions not met", RuleStatus.SKIP
            )

        apply_count = 0
        for foreach in self.rule.validation.foreach:
            try:
                elements = evaluate_list(foreach.list_expr, self.ctx.json_context)
            except Exception:
                continue

            self.ctx.json_context.checkpoint()
            try:
                for element in elements:
                    self.ctx.json_context.reset()
                    ctx = self.ctx.copy()
                    try:
                        _add_element_to_context(ctx, element)
                    except Exception as e:
                        return rule_error(
                            self.rule, RuleType.VALIDATION, "failed to process foreach", e
                        )
                    r = _Validator.for_foreach(ctx, self.rule, foreach).validate()
                    if r is None or r.status is RuleStatus.SKIP:
                        continue
                    if r.status is not RuleStatus.PASS:
                        return rule_response(
                            self.rule,
                            RuleType.VALIDATION,
                            f"validation failed in foreach rule for {r.message}",
                            r.status,
                        )
                    apply_count += 1
            finally:
                self.ctx.json_context.restore()

        if apply_count == 0:
            return rule_response(
                self.rule, RuleType.VALIDATION, "rule skipped", RuleStatus.SKIP
            )
        return rule_response(self.rule, RuleType.VALIDATION, "rule passed", RuleStatus.PASS)

    # ------------------------------------------------------------ checks

    def _validate_resource_with_rule(self) -> RuleResponse | None:
        """validation.go:341 validateResourceWithRule: CREATE/DELETE/MODIFY
        dispatch; foreach elements validate directly."""
        if self.ctx.element is not None:
            return self._validate_patterns(self.ctx.element)
        if not self.ctx.old_resource:
            return self._validate_patterns(self.ctx.new_resource)
        if not self.ctx.new_resource:
            return None  # DELETE: skip validation on deleted resource
        old_resp = self._validate_patterns(self.ctx.old_resource)
        new_resp = self._validate_patterns(self.ctx.new_resource)
        if _is_same_rule_response(old_resp, new_resp):
            return None  # MODIFY with unchanged verdict
        return new_resp

    def _validate_patterns(self, resource: dict) -> RuleResponse:
        """validation.go:421 validatePatterns."""
        if self.pattern is not None:
            result = match_pattern(resource, self.pattern)
            if not result.matched:
                if result.skip:
                    return rule_response(
                        self.rule, RuleType.VALIDATION, result.message, RuleStatus.SKIP
                    )
                if result.path == "":
                    return rule_response(
                        self.rule,
                        RuleType.VALIDATION,
                        self._build_error_message(result.message, ""),
                        RuleStatus.ERROR,
                    )
                return rule_response(
                    self.rule,
                    RuleType.VALIDATION,
                    self._build_error_message(result.message, result.path),
                    RuleStatus.FAIL,
                )
            return rule_response(
                self.rule,
                RuleType.VALIDATION,
                f"validation rule '{self.rule.name}' passed.",
                RuleStatus.PASS,
            )

        if self.any_pattern is not None:
            if not isinstance(self.any_pattern, list):
                return rule_response(
                    self.rule,
                    RuleType.VALIDATION,
                    "failed to deserialize anyPattern, expected type array",
                    RuleStatus.ERROR,
                )
            failures: list[str] = []
            for idx, pattern in enumerate(self.any_pattern):
                result = match_pattern(resource, pattern)
                if result.matched:
                    return rule_response(
                        self.rule,
                        RuleType.VALIDATION,
                        f"validation rule '{self.rule.name}' anyPattern[{idx}] passed.",
                        RuleStatus.PASS,
                    )
                if result.path == "":
                    failures.append(
                        f"Rule {self.rule.name}[{idx}] failed: {result.message}."
                    )
                else:
                    failures.append(
                        f"Rule {self.rule.name}[{idx}] failed at path {result.path}."
                    )
            if failures:
                return rule_response(
                    self.rule,
                    RuleType.VALIDATION,
                    _build_any_pattern_error_message(self.rule, failures),
                    RuleStatus.FAIL,
                )

        return rule_response(
            self.rule,
            RuleType.VALIDATION,
            self.rule.validation.message,
            RuleStatus.PASS,
        )

    def _validate_deny(self) -> RuleResponse:
        """validation.go:299 validateDeny."""
        try:
            deny = substitute_all(self.ctx.json_context, self.deny)
        except VariableResolutionError as e:
            return rule_error(
                self.rule,
                RuleType.VALIDATION,
                "failed to substitute variables in deny conditions",
                e,
            )
        try:
            conditions = transform_conditions(deny.get("conditions"))
        except ValueError as e:
            return rule_error(self.rule, RuleType.VALIDATION, "invalid deny conditions", e)

        denied = evaluate_conditions(conditions)
        if denied:
            return rule_response(
                self.rule,
                RuleType.VALIDATION,
                self._deny_message(denied),
                RuleStatus.FAIL,
            )
        return rule_response(
            self.rule, RuleType.VALIDATION, self._deny_message(denied), RuleStatus.PASS
        )

    # ------------------------------------------------------------ helpers

    def _deny_message(self, denied: bool) -> str:
        """validation.go:323 getDenyMessage."""
        if not denied:
            return f"validation rule '{self.rule.name}' passed."
        msg = self.rule.validation.message
        if not msg:
            return f"validation error: rule {self.rule.name} failed"
        try:
            return substitute_all(self.ctx.json_context, msg)
        except VariableResolutionError:
            return msg

    def _build_error_message(self, err_msg: str, path: str) -> str:
        """validation.go:507 buildErrorMessage."""
        if not self.rule.validation.message:
            if path:
                return f"validation error: rule {self.rule.name} failed at path {path}"
            return (
                f"validation error: rule {self.rule.name} execution error: {err_msg}"
            )
        try:
            msg = substitute_all(self.ctx.json_context, self.rule.validation.message)
        except VariableResolutionError:
            msg = self.rule.validation.message
        if not msg.endswith("."):
            msg += "."
        if path:
            return f"validation error: {msg} Rule {self.rule.name} failed at path {path}"
        return f"validation error: {msg} Rule {self.rule.name} execution error: {err_msg}"

    def _substitute_patterns(self) -> None:
        """validation.go:545 substitutePatterns."""
        if self.pattern is not None:
            self.pattern = substitute_all(self.ctx.json_context, self.pattern)
        elif self.any_pattern is not None:
            self.any_pattern = substitute_all(self.ctx.json_context, self.any_pattern)


def _build_any_pattern_error_message(rule, errors: list[str]) -> str:
    """validation.go:531 buildAnyPatternErrorMessage."""
    err_str = " ".join(errors)
    msg = rule.validation.message
    if not msg:
        return f"validation error: {err_str}"
    if msg.endswith("."):
        return f"validation error: {msg} {err_str}"
    return f"validation error: {msg}. {err_str}"


def _add_element_to_context(ctx: PolicyContext, element) -> None:
    """validation.go:268 addElementToContext."""
    if not isinstance(element, dict):
        raise ValueError(f"failed to convert foreach element to map: {element!r}")
    ctx.json_context.add_json({"element": element})
    ctx.element = element


def _is_same_rule_response(r1: RuleResponse | None, r2: RuleResponse | None) -> bool:
    """validation.go:401 isSameRuleResponse."""
    if r1 is None or r2 is None:
        return r1 is r2
    return (
        r1.name == r2.name
        and r1.type == r2.type
        and r1.message == r2.message
        and r1.status == r2.status
    )
