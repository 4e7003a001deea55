"""Mock context store for offline (CLI / test) engine runs.

Mirrors kyverno/pkg/kyverno/store/store.go: when mock mode is on,
``load_context`` (engine/json_context_loader.py) resolves a rule's external
``context:`` entries from values declared here instead of hitting a live
cluster — the branch at kyverno/pkg/engine/jsonContext.go:27-48.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_mock: bool = False
_context: "Context | None" = None


@dataclass
class Rule:
    """store.go Rule: per-rule declared variable values."""

    name: str = ""
    values: dict[str, str] = field(default_factory=dict)


@dataclass
class Policy:
    name: str = ""
    rules: list[Rule] = field(default_factory=list)


@dataclass
class Context:
    policies: list[Policy] = field(default_factory=list)


def set_mock(mock: bool) -> None:
    global _mock
    _mock = mock


def get_mock() -> bool:
    return _mock


def set_context(ctx: Context) -> None:
    global _context
    _context = ctx


def get_policy_rule_from_context(policy_name: str, rule_name: str) -> Rule | None:
    """store.go GetPolicyRuleFromContext."""
    if _context is None:
        return None
    for policy in _context.policies:
        if policy.name != policy_name:
            continue
        for rule in policy.rules:
            if rule.name == rule_name:
                return rule
    return None
