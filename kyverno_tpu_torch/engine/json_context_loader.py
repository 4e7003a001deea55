"""External-data context loading (rule ``context:`` entries).

Mirrors kyverno/pkg/engine/jsonContext.go: ConfigMap entries come
from the cluster client's configmap store, APICall entries GET/LIST against
the API, and in mock mode (CLI / tests) every entry resolves from the
declared values in :mod:`kyverno_tpu_torch.store`.
"""

from __future__ import annotations

import json

from .. import store
from .api_path import parse_api_path
from .context import Context
from .policy_context import PolicyContext
from .variables import substitute_all


class ContextLoadError(Exception):
    pass


def load_context(context_entries: list, policy_ctx: PolicyContext, rule_name: str) -> None:
    """jsonContext.go:21 LoadContext."""
    if not context_entries:
        return

    policy_name = policy_ctx.policy.name
    if store.get_mock():
        _load_mock_context(policy_name, rule_name, policy_ctx.json_context)
        return

    for entry in context_entries:
        if entry.config_map is not None:
            _load_config_map(entry, policy_ctx)
        elif entry.api_call is not None:
            _load_api_data(entry, policy_ctx)


def _load_mock_context(policy_name: str, rule_name: str, ctx: Context) -> None:
    """jsonContext.go:27-48 mock branch: declared values become context
    entries; multiline strings split into lists unless PEM."""
    rule = store.get_policy_rule_from_context(policy_name, rule_name)
    if rule is None or not rule.values:
        raise ContextLoadError(
            f"No values found for policy {policy_name} rule {rule_name}"
        )

    for key, value in rule.values.items():
        if isinstance(value, str):
            trimmed = value.strip("\n")
            if "\n" in trimmed:
                value = parse_multiline_block_body({key: value})[key]
        ctx.add_json(variable_to_json(key, value))


def variable_to_json(key: str, value) -> dict:
    """pkg/common VariableToJSON: dotted keys nest ("a.b.c" -> {a:{b:{c:v}}});
    JSON-looking string values parse structurally."""
    if isinstance(value, str):
        stripped = value.strip()
        if stripped[:1] in ("{", "["):
            try:
                value = json.loads(stripped)
            except json.JSONDecodeError:
                pass
    path = key.split(".")
    doc = value
    for segment in reversed(path):
        doc = {segment: doc}
    return doc


def _load_config_map(entry, policy_ctx: PolicyContext) -> None:
    """jsonContext.go:189 loadConfigMap + fetchConfigMap."""
    ctx = policy_ctx.json_context
    name = substitute_all(ctx, entry.config_map.get("name", ""))
    namespace = substitute_all(ctx, entry.config_map.get("namespace", "")) or "default"

    source = policy_ctx.resource_cache or policy_ctx.client
    if source is None:
        raise ContextLoadError("configmap client is not available")
    obj = source.get_configmap(namespace, name)
    if obj is None:
        raise ContextLoadError(
            f"failed to read configmap {namespace}/{name} from cache"
        )

    data = parse_multiline_block_body(dict(obj.get("data") or {}))
    ctx.add_json(
        {entry.name: {"data": data, "metadata": obj.get("metadata") or {}}}
    )


def _load_api_data(entry, policy_ctx: PolicyContext) -> None:
    """jsonContext.go:74 loadAPIData: fetch, optional JMESPath reduction."""
    ctx = policy_ctx.json_context
    data = _fetch_api_data(entry, policy_ctx)

    jmespath_expr = (entry.api_call or {}).get("jmesPath", "")
    if not jmespath_expr:
        if not isinstance(data, dict):
            raise ContextLoadError(
                f"failed to add resource data to context: contextEntry {entry.name}"
            )
        ctx.add_json(data)
        return

    path = substitute_all(ctx, jmespath_expr)
    from .jmespath import search as jp_search

    try:
        results = jp_search(path, data)
    except Exception as e:
        raise ContextLoadError(f"failed to apply JMESPath {path}: {e}") from e
    ctx.add_json({entry.name: results})


def _fetch_api_data(entry, policy_ctx: PolicyContext):
    """jsonContext.go:130 fetchAPIData."""
    url_path = (entry.api_call or {}).get("urlPath", "")
    path_str = substitute_all(policy_ctx.json_context, url_path)
    p = parse_api_path(path_str)

    if policy_ctx.client is None:
        raise ContextLoadError("API client is not available")
    if p.name:
        r = policy_ctx.client.get_resource(
            p.api_version, p.resource_type, p.namespace, p.name
        )
        if r is None:
            raise ContextLoadError(f"failed to get resource with urlPath {p}")
        return r
    items = policy_ctx.client.list_resource(p.api_version, p.resource_type, p.namespace)
    return {"items": list(items or []), "kind": "List"}


def parse_multiline_block_body(m: dict) -> dict:
    """jsonContext.go:248 parseMultilineBlockBody: string values containing
    newlines split into lists, except PEM blocks; single-line strings get
    trailing newlines trimmed."""
    out = {}
    for k, v in m.items():
        if isinstance(v, str):
            trimmed = v.strip("\n")
            if "-----BEGIN" not in trimmed and "\n" in trimmed:
                out[k] = trimmed.split("\n")
            else:
                out[k] = trimmed
        else:
            out[k] = v
    return out
