"""Pattern-key anchors: modifiers that change match semantics for a map key.

Kinds (cf. kyverno/pkg/engine/anchor/common/common.go):
  - condition  ``(key)``   : if key matches, rest of map must match; if the
                             key's own pattern mismatches -> SKIP the rule
  - global     ``<(key)``  : like condition, but mismatch skips the whole rule
                             from anywhere in the tree
  - existence  ``^(key)``  : at least one element of the resource list matches
  - equality   ``=(key)``  : if key present in resource, value must match
  - negation   ``X(key)``  : key must NOT be present in resource
  - addition   ``+(key)``  : mutate-only; add if not present
"""

from __future__ import annotations

from enum import Enum
from functools import lru_cache


class Anchor(Enum):
    NONE = ""
    CONDITION = "("
    GLOBAL = "<("
    EXISTENCE = "^("
    EQUALITY = "=("
    NEGATION = "X("
    ADD_IF_NOT_PRESENT = "+("


def is_condition_anchor(key: str) -> bool:
    return len(key) >= 2 and key[0] == "(" and key[-1] == ")"


def _is_prefixed(key: str, prefix: str) -> bool:
    return len(key) >= len(prefix) + 1 and key.startswith(prefix) and key.endswith(")")


def is_global_anchor(key: str) -> bool:
    return _is_prefixed(key, "<(")


def is_existence_anchor(key: str) -> bool:
    return _is_prefixed(key, "^(")


def is_equality_anchor(key: str) -> bool:
    return _is_prefixed(key, "=(")


def is_negation_anchor(key: str) -> bool:
    return _is_prefixed(key, "X(")


def is_addition_anchor(key: str) -> bool:
    return _is_prefixed(key, "+(")


def is_non_anchor(key: str) -> bool:
    return anchor_kind(key) is Anchor.NONE


@lru_cache(maxsize=4096)
def anchor_kind(key: str) -> Anchor:
    # two-char prefixes take precedence over the bare "(...)" form; a pure
    # function of the key string, and the oracle asks it ~56k times per
    # library-corpus admission over a small recurring key set — memoized
    if is_global_anchor(key):
        return Anchor.GLOBAL
    if is_existence_anchor(key):
        return Anchor.EXISTENCE
    if is_equality_anchor(key):
        return Anchor.EQUALITY
    if is_negation_anchor(key):
        return Anchor.NEGATION
    if is_addition_anchor(key):
        return Anchor.ADD_IF_NOT_PRESENT
    if is_condition_anchor(key):
        return Anchor.CONDITION
    return Anchor.NONE


def remove_anchor(key: str) -> tuple[str, str]:
    """Strip the anchor decoration: returns (bare key, anchor prefix)."""
    kind = anchor_kind(key)
    if kind is Anchor.NONE:
        return key, ""
    return key[len(kind.value):-1], kind.value


def add_anchor(key: str, prefix: str) -> str:
    return f"{prefix}{key})"


def remove_anchors_from_path(path: str) -> str:
    parts = [p for p in path.split("/") if p != ""]
    cleaned = "/".join(remove_anchor(p)[0] for p in parts)
    return ("/" + cleaned) if path.startswith("/") else cleaned


def split_anchors(pattern_map: dict) -> tuple[dict, dict]:
    """Two-phase split used by the map matcher (anchor/anchor.go:265):
    condition/existence/equality/negation anchors evaluate first, the rest
    after. Global anchors intentionally stay in the 'rest' bucket, matching
    the reference (they are still handled by their own handler)."""
    anchors, rest = {}, {}
    for key, value in pattern_map.items():
        kind = anchor_kind(key)
        if kind in (Anchor.CONDITION, Anchor.EXISTENCE, Anchor.EQUALITY, Anchor.NEGATION):
            anchors[key] = value
        else:
            rest[key] = value
    return anchors, rest


def has_nested_anchors(pattern) -> bool:
    """True if any key anywhere under ``pattern`` carries an anchor."""
    if isinstance(pattern, dict):
        for k, v in pattern.items():
            if anchor_kind(k) is not Anchor.NONE or has_nested_anchors(v):
                return True
        return False
    if isinstance(pattern, list):
        return any(has_nested_anchors(v) for v in pattern)
    return False
