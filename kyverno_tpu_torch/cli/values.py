"""--set / --values-file handling (mirrors kyverno/pkg/kyverno/common
Values types at common.go:48-75 and GetVariable)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import store


@dataclass
class Values:
    global_values: dict[str, str] = field(default_factory=dict)
    # policy -> resource -> values
    resource_values: dict[str, dict[str, dict[str, str]]] = field(default_factory=dict)
    # policy -> rule -> values (feeds the mock context store)
    rule_values: dict[str, dict[str, dict[str, str]]] = field(default_factory=dict)
    # namespace -> labels (for namespaceSelector matching)
    namespace_selectors: dict[str, dict[str, str]] = field(default_factory=dict)
    set_values: dict[str, str] = field(default_factory=dict)

    def for_resource(self, policy_name: str, resource_name: str) -> dict[str, str]:
        out = dict(self.global_values)
        out.update(
            self.resource_values.get(policy_name, {}).get(resource_name, {})
        )
        out.update(self.set_values)
        return out

    def install_mock_store(self) -> None:
        """Wire rule-level values into the mock context store
        (store.GetPolicyRuleFromContext consumed by LoadContext)."""
        policies = []
        for policy_name, rules in self.rule_values.items():
            policies.append(
                store.Policy(
                    name=policy_name,
                    rules=[
                        store.Rule(name=rule_name, values=values)
                        for rule_name, values in rules.items()
                    ],
                )
            )
        store.set_context(store.Context(policies=policies))


def parse_set(expr: str) -> dict[str, str]:
    """-s a=b,c=d"""
    out: dict[str, str] = {}
    if not expr:
        return out
    for pair in expr.split(","):
        if not pair.strip():
            continue
        if "=" not in pair:
            raise ValueError(f"invalid --set variable: {pair!r} (want key=value)")
        key, value = pair.split("=", 1)
        out[key.strip()] = value.strip()
    return out


def load_values_file(path: str) -> Values:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    values = Values(global_values={
        k: str(v) for k, v in (doc.get("globalValues") or {}).items()
    })
    for policy in doc.get("policies") or []:
        name = policy.get("name", "")
        for resource in policy.get("resources") or []:
            values.resource_values.setdefault(name, {})[resource.get("name", "")] = {
                k: str(v) for k, v in (resource.get("values") or {}).items()
            }
        for rule in policy.get("rules") or []:
            values.rule_values.setdefault(name, {})[rule.get("name", "")] = {
                k: str(v) for k, v in (rule.get("values") or {}).items()
            }
    for selector in doc.get("namespaceSelector") or []:
        values.namespace_selectors[selector.get("name", "")] = dict(
            selector.get("labels") or {}
        )
    return values
