"""Structural validation of policies (policy admission / CLI validate).

Mirrors the core checks of kyverno/pkg/policy/validate.go:73
policy.Validate: variable allow-list, name limits, unique rule names,
rule-type exclusivity, match/exclude sanity, context entry shape, and the
per-action spot checks the webhook performs before a policy is admitted.
"""

from __future__ import annotations

import re

from ..api.types import ClusterPolicy, Rule

# validate.go / vars allow-list (allowed_vars_test.go): variables must root
# in one of these or in a context entry name defined by the rule
ALLOWED_VARIABLE_ROOTS = (
    "request.", "serviceAccountName", "serviceAccountNamespace",
    "element", "elementIndex", "@", "images.", "image",
)

_VARIABLE_RE = re.compile(r"\{\{(?:\\\})?([^{}]*)\}\}")


def validate_policy(policy: ClusterPolicy) -> list[str]:
    """Returns a list of human-readable problems; empty = valid."""
    errors: list[str] = []

    if len(policy.name) > 63:
        errors.append(
            f"invalid policy name {policy.name!r}: must be no more than 63 characters"
        )

    names = [r.name for r in policy.spec.rules]
    seen = set()
    for name in names:
        if not name:
            errors.append("rule name must not be empty")
        elif name in seen:
            errors.append(f"duplicate rule name: {name!r}")
        seen.add(name)

    background = policy.spec.background
    for i, rule in enumerate(policy.spec.rules):
        prefix = f"spec.rules[{i}] ({rule.name!r})"
        errors.extend(f"{prefix}: {e}" for e in _validate_rule(rule, background))

    return errors


def _validate_rule(rule: Rule, background: bool) -> list[str]:
    errors: list[str] = []

    # rule-type exclusivity (validate.go:1056 validateRuleType)
    actions = [
        name
        for name, present in (
            ("mutate", rule.has_mutate()),
            ("validate", rule.has_validate()),
            ("generate", rule.has_generate()),
            ("verifyImages", rule.has_verify_images()),
        )
        if present
    ]
    if len(actions) == 0:
        errors.append(
            "no operation defined; exactly one of mutate / validate / generate / "
            "verifyImages is required"
        )
    elif len(actions) > 1:
        errors.append(f"multiple operations defined: {', '.join(actions)}")

    # match/exclude sanity (validate.go:1171 validateResources)
    for label, block in (("match", rule.match), ("exclude", rule.exclude)):
        if block.any and block.all:
            errors.append(f"{label}: 'any' and 'all' cannot be used together")
        if block.any or block.all:
            if not block.resources.is_empty():
                errors.append(
                    f"{label}: 'resources' cannot be used with 'any'/'all'"
                )
    if rule.match.is_empty():
        errors.append("match is required")
    else:
        kinds = list(rule.match.resources.kinds) + [
            k for rf in rule.match.any + rule.match.all for k in rf.resources.kinds
        ]
        if not kinds and rule.match.user_info.is_empty():
            errors.append("match must specify at least one kind or userInfo filter")

    # context entries (validate.go:1077 validateRuleContext)
    context_names = set()
    for entry in rule.context:
        if not entry.name:
            errors.append("context entry requires a name")
        context_names.add(entry.name)
        sources = [
            s for s, present in (
                ("configMap", entry.config_map is not None),
                ("apiCall", entry.api_call is not None),
                ("variable", entry.variable is not None),
            ) if present
        ]
        if len(sources) != 1:
            errors.append(
                f"context entry {entry.name!r} requires exactly one of "
                f"configMap / apiCall / variable (got {sources or 'none'})"
            )
        if entry.config_map is not None and not entry.config_map.get("name"):
            errors.append(f"context entry {entry.name!r}: configMap.name is required")
        if entry.api_call is not None and not entry.api_call.get("urlPath"):
            errors.append(f"context entry {entry.name!r}: apiCall.urlPath is required")

    # validate action shape
    v = rule.validation
    if rule.has_validate():
        forms = [
            name for name, present in (
                ("pattern", v.pattern is not None),
                ("anyPattern", v.any_pattern is not None),
                ("deny", v.deny is not None),
                ("foreach", bool(v.foreach)),
            ) if present
        ]
        if len(forms) != 1:
            errors.append(
                f"validate requires exactly one of pattern / anyPattern / deny / "
                f"foreach (got {forms or 'none'})"
            )
        if v.any_pattern is not None and not isinstance(v.any_pattern, list):
            errors.append("validate.anyPattern must be a list of patterns")

    # mutate action shape
    m = rule.mutation
    if rule.has_mutate():
        if m.patches_json6902 and not _json6902_paths_ok(m.patches_json6902):
            errors.append("mutate.patchesJson6902 paths must begin with a forward slash")

    # generate action shape
    g = rule.generation
    if rule.has_generate():
        if not g.kind or not g.name:
            errors.append("generate requires kind and name")
        if (g.data is None) == (not g.clone):
            errors.append("generate requires exactly one of data or clone")

    # variable allow-list (ValidateVariables, validate.go:78): background
    # policies cannot reference admission-time user info
    variables = _collect_variables(rule)
    for var in variables:
        root_ok = var.startswith(ALLOWED_VARIABLE_ROOTS) or any(
            var == n or var.startswith(n + ".") or var.startswith(n + "[")
            for n in context_names
        ) or _is_expression(var)
        if not root_ok:
            errors.append(f"variable {{{{{var}}}}} is not defined in the rule context")
        if background and var.startswith("request.userInfo"):
            errors.append(
                f"background policies cannot reference admission request data: "
                f"{{{{{var}}}}}"
            )

    return errors


def _is_expression(var: str) -> bool:
    """JMESPath expressions over allowed roots (functions, pipes) pass."""
    return any(tok in var for tok in ("(", "|", "[?")) or var == ""


def _json6902_paths_ok(patches: str) -> bool:
    import yaml

    try:
        ops = yaml.safe_load(patches)
    except yaml.YAMLError:
        return False
    if not isinstance(ops, list):
        return False
    return all(
        isinstance(op, dict) and str(op.get("path", "")).startswith("/")
        for op in ops
    )


def _collect_variables(rule: Rule) -> list[str]:
    import json

    def foreach_doc(fe):
        return {
            "list": fe.list_expr,
            "preconditions": fe.preconditions,
            "pattern": fe.pattern,
            "anyPattern": fe.any_pattern,
            "deny": fe.deny,
            "patchStrategicMerge": fe.patch_strategic_merge,
            "context": [
                {"name": c.name, "configMap": c.config_map, "apiCall": c.api_call,
                 "variable": c.variable}
                for c in fe.context
            ],
        }

    raw = json.dumps({
        "context": [
            {"name": c.name, "configMap": c.config_map, "apiCall": c.api_call,
             "variable": c.variable}
            for c in rule.context
        ],
        "preconditions": rule.preconditions,
        "validate": {
            "pattern": rule.validation.pattern,
            "anyPattern": rule.validation.any_pattern,
            "deny": rule.validation.deny,
            "message": rule.validation.message,
            "foreach": [foreach_doc(fe) for fe in rule.validation.foreach],
        },
        "mutate": {
            "patchStrategicMerge": rule.mutation.patch_strategic_merge,
            "overlay": rule.mutation.overlay,
            "patchesJson6902": rule.mutation.patches_json6902,
            "foreach": [foreach_doc(fe) for fe in rule.mutation.foreach],
        },
        "generate": {
            "name": rule.generation.name,
            "namespace": rule.generation.namespace,
            "data": rule.generation.data,
            "clone": rule.generation.clone,
        },
    })
    out = []
    for m in _VARIABLE_RE.finditer(raw):
        var = m.group(1).strip()
        if var:
            out.append(var)
    return out
