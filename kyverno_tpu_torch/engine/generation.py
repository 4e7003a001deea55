"""Generate engine: admission-time filtering + resource materialization.

Mirrors kyverno/pkg/engine/generation.go (the filter run inline at
admission, producing GenerateRequest work items) and the materialization
half of the async generate controller
(kyverno/pkg/generate/generate.go:482-560 manageData/manageClone),
exposed as library functions so the CLI and the controller share them.
"""

from __future__ import annotations

import copy
import time

from .json_context_loader import load_context
from .match import matches_resource_description
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
from .validation import check_preconditions, rule_response
from .variables import VariableResolutionError, substitute_all


def generate(policy_ctx: PolicyContext) -> EngineResponse:
    """generation.go:16 Generate: returns the generate rules applicable to
    this (policy, resource) — PASS rows become GenerateRequests."""
    start = time.monotonic()
    resp = EngineResponse(policy_response=PolicyResponse())
    resource = policy_ctx.new_resource or {}
    meta = resource.get("metadata") or {}
    resp.policy_response.policy = PolicySpecSummary(name=policy_ctx.policy.name)
    resp.policy_response.resource = ResourceSpec(
        kind=resource.get("kind", ""),
        api_version=resource.get("apiVersion", ""),
        namespace=meta.get("namespace", ""),
        name=meta.get("name", ""),
    )

    if policy_ctx.excluded_by_func(
        resource.get("kind", ""), meta.get("namespace", ""), meta.get("name", "")
    ):
        return resp

    for rule in policy_ctx.policy.spec.rules:
        rule_resp = _filter_rule(rule, policy_ctx)
        if rule_resp is not None:
            resp.policy_response.rules.append(rule_resp)

    resp.policy_response.processing_time_s = time.monotonic() - start
    return resp


def _filter_rule(rule, policy_ctx: PolicyContext) -> RuleResponse | None:
    """generation.go:58 filterRule."""
    if not rule.has_generate():
        return None

    # policy-namespace gate applied engine-side (see validation._matches)
    ns = policy_ctx.policy.namespace if policy_ctx.policy is not None else ""
    ok, _ = matches_resource_description(
        policy_ctx.new_resource,
        rule,
        policy_ctx.admission_info,
        policy_ctx.exclude_group_role,
        policy_ctx.namespace_labels,
        ns,
    )
    if not ok:
        # old resource matching means the GR must be cleaned up -> FAIL row
        old_ok, _ = matches_resource_description(
            policy_ctx.old_resource,
            rule,
            policy_ctx.admission_info,
            policy_ctx.exclude_group_role,
            policy_ctx.namespace_labels,
            ns,
        )
        if policy_ctx.old_resource and old_ok:
            return rule_response(rule, RuleType.GENERATION, "", RuleStatus.FAIL)
        return None

    policy_ctx.json_context.checkpoint()
    try:
        try:
            load_context(rule.context, policy_ctx, rule.name)
        except Exception:
            return None
        try:
            if not check_preconditions(policy_ctx, rule.preconditions):
                return None
        except Exception:
            return None
    finally:
        policy_ctx.json_context.restore()

    return rule_response(rule, RuleType.GENERATION, "", RuleStatus.PASS)


# ------------------------------------------------------------ materialization

MODE_SKIP = "SKIP"
MODE_CREATE = "CREATE"
MODE_UPDATE = "UPDATE"

GENERATED_BY_LABELS = {
    "policy": "kyverno.io/generated-by-policy",
    "rule": "kyverno.io/generated-by-rule",
    "kind": "kyverno.io/generated-by-kind",
    "namespace": "kyverno.io/generated-by-namespace",
    "name": "kyverno.io/generated-by-name",
}


class GenerateError(Exception):
    pass


def apply_generate_rule(rule, policy_ctx: PolicyContext, trigger: dict,
                        client=None) -> tuple[dict | None, str]:
    """generate.go:332 applyRule: substitute variables in the generate spec,
    materialize from data: or clone:, and label the result for tracking.

    Returns (resource-or-None, mode). ``client`` provides get_resource for
    clone sources and existing-target lookups; None means offline (CLI),
    where clones are skipped and data always creates.
    """
    gen = rule.generation
    ctx = policy_ctx.json_context

    try:
        api_version = substitute_all(ctx, gen.api_version) or gen.api_version
        kind = substitute_all(ctx, gen.kind) or gen.kind
        namespace = substitute_all(ctx, gen.namespace)
        name = substitute_all(ctx, gen.name)
        data = substitute_all(ctx, gen.data) if gen.data is not None else None
        clone = substitute_all(ctx, gen.clone) if gen.clone else None
    except VariableResolutionError as e:
        raise GenerateError(f"variable substitution failed: {e}") from e

    if clone:
        resource, mode = _manage_clone(
            api_version, kind, namespace, name, clone, client
        )
    else:
        resource, mode = _manage_data(
            api_version, kind, namespace, name, data, client
        )
    if mode == MODE_SKIP or resource is None:
        return None, MODE_SKIP

    resource = copy.deepcopy(resource)
    resource.setdefault("apiVersion", api_version)
    resource.setdefault("kind", kind)
    meta = resource.setdefault("metadata", {})
    meta["name"] = name
    if namespace:
        meta["namespace"] = namespace

    # generate.go labels.go: track provenance of the generated resource
    trigger_meta = (trigger.get("metadata") or {})
    labels = meta.setdefault("labels", {})
    labels[GENERATED_BY_LABELS["policy"]] = policy_ctx.policy.name
    labels[GENERATED_BY_LABELS["rule"]] = rule.name
    labels[GENERATED_BY_LABELS["kind"]] = trigger.get("kind", "")
    labels[GENERATED_BY_LABELS["namespace"]] = trigger_meta.get("namespace", "")
    labels[GENERATED_BY_LABELS["name"]] = trigger_meta.get("name", "")
    return resource, mode


def _manage_data(api_version, kind, namespace, name, data, client):
    """generate.go:482 manageData."""
    existing = None
    if client is not None:
        existing = client.get_resource(api_version, kind, namespace, name)
    if existing is None:
        return data, MODE_CREATE if data is not None else MODE_SKIP
    if data is None:
        return None, MODE_SKIP
    updated = copy.deepcopy(data)
    rv = ((existing.get("metadata") or {}).get("resourceVersion"))
    if rv is not None:
        updated.setdefault("metadata", {})["resourceVersion"] = rv
    return updated, MODE_UPDATE


def _manage_clone(api_version, kind, namespace, name, clone, client):
    """generate.go:504 manageClone."""
    src_namespace = clone.get("namespace", "")
    src_name = clone.get("name", "")
    if src_namespace == namespace and src_name == name:
        return None, MODE_SKIP  # self-clone
    if client is None:
        return None, MODE_SKIP  # offline: no clone source available
    source = client.get_resource(api_version, kind, src_namespace, src_name)
    if source is None:
        raise GenerateError(
            f"source resource {api_version}/{kind}/{src_namespace}/{src_name} not found"
        )
    obj = copy.deepcopy(source)
    meta = obj.setdefault("metadata", {})
    if src_namespace != namespace:
        meta.pop("ownerReferences", None)
    # scrub source-instance fields
    for field in ("uid", "selfLink", "creationTimestamp", "managedFields",
                  "resourceVersion"):
        meta.pop(field, None)

    target = client.get_resource(api_version, kind, namespace, name)
    if target is not None:
        tmeta = target.get("metadata") or {}
        for field in ("uid", "selfLink", "creationTimestamp", "managedFields",
                      "resourceVersion"):
            if field in tmeta:
                meta[field] = tmeta[field]
        if obj == target:
            return None, MODE_SKIP
        return obj, MODE_UPDATE
    return obj, MODE_CREATE
