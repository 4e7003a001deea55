"""Kubernetes LabelSelector evaluation (metav1.LabelSelectorAsSelector).

matchLabels is ANDed with matchExpressions; supported operators are
In, NotIn, Exists, DoesNotExist. Used by the match/exclude filters
(kyverno/pkg/engine/utils.go:100 checkSelector).
"""

from __future__ import annotations


class SelectorError(ValueError):
    pass


def selector_matches(selector: dict, labels: dict) -> bool:
    """Evaluate a LabelSelector JSON object against a label map."""
    if selector is None:
        return False
    labels = labels or {}
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key", "")
        op = expr.get("operator", "")
        values = expr.get("values") or []
        if op == "In":
            if not values:
                raise SelectorError("In operator requires values")
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if not values:
                raise SelectorError("NotIn operator requires values")
            if key in labels and labels[key] in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            raise SelectorError(f"unknown selector operator: {op!r}")
    return True
