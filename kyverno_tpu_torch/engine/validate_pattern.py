"""Recursive JSON-tree pattern matcher with anchor semantics.

The executable specification for the device pattern checks: semantics mirror
kyverno/pkg/engine/validate/validate.go element-for-element.
Outcome is a tri-state: matched / failed(path) / skip (a conditional or
global anchor did not apply, so the rule does not apply to the resource).
"""

from __future__ import annotations

from dataclasses import dataclass

from .anchors import (
    Anchor,
    anchor_kind,
    remove_anchor,
    split_anchors,
    has_nested_anchors,
)
from .pattern import validate_value_with_pattern
from .wildcards import expand_in_metadata

_SCALAR = (str, int, float, bool)


@dataclass
class PatternResult:
    matched: bool
    skip: bool = False
    path: str = ""
    message: str = ""


class _Mismatch(Exception):
    def __init__(self, path: str, message: str):
        super().__init__(message)
        self.path = path
        self.message = message


class _ConditionalAnchorMismatch(_Mismatch):
    pass


class _GlobalAnchorMismatch(_Mismatch):
    pass


class _AnchorTracker:
    """Tracks whether condition/existence/negation anchor keys from the
    pattern ever exist in the resource (common/anchor_key.go). If a tracked
    anchor key never appears, a failure reports as 'missing anchor' with an
    empty path — outcome is still FAIL, not SKIP."""

    def __init__(self):
        self.anchor_map: dict[str, bool] = {}

    def check(self, pattern_map: dict, resource) -> None:
        for key in pattern_map:
            kind = anchor_kind(key)
            if kind in (Anchor.CONDITION, Anchor.EXISTENCE, Anchor.NEGATION):
                if self.anchor_map.get(key):
                    continue
                self.anchor_map.setdefault(key, False)
                if self._key_in(key, resource):
                    self.anchor_map[key] = True

    @staticmethod
    def _key_in(key: str, resource) -> bool:
        bare, _ = remove_anchor(key)
        if isinstance(resource, dict):
            return bare in resource
        if isinstance(resource, list):
            return any(
                isinstance(el, dict) and bare in el for el in resource
            )
        return False

    def is_anchor_error(self) -> bool:
        return any(not v for v in self.anchor_map.values())


def match_pattern(resource, pattern) -> PatternResult:
    """validate.go:29 MatchPattern. Root entry; path starts at "/"."""
    ac = _AnchorTracker()
    try:
        _validate_element(resource, pattern, pattern, "/", ac)
    except (_ConditionalAnchorMismatch, _GlobalAnchorMismatch) as e:
        return PatternResult(False, skip=True, path="", message=e.message)
    except _Mismatch as e:
        if ac.is_anchor_error():
            return PatternResult(False, skip=False, path="", message=e.message)
        return PatternResult(False, skip=False, path=e.path, message=e.message)
    return PatternResult(True)


def _validate_element(resource, pattern, origin, path: str, ac: _AnchorTracker) -> None:
    """validate.go:55 validateResourceElement."""
    if isinstance(pattern, dict):
        if not isinstance(resource, dict):
            raise _Mismatch(
                path,
                f"pattern and resource have different structures at path {path}: "
                f"expected object, found {type(resource).__name__}",
            )
        ac.check(pattern, resource)
        _validate_map(resource, pattern, origin, path, ac)
    elif isinstance(pattern, list):
        if not isinstance(resource, list):
            raise _Mismatch(
                path,
                f"validation rule failed at path {path}: resource does not "
                "satisfy the expected overlay pattern",
            )
        _validate_array(resource, pattern, origin, path, ac)
    elif pattern is None or isinstance(pattern, _SCALAR):
        if isinstance(resource, list):
            for el in resource:
                if not validate_value_with_pattern(el, pattern):
                    raise _Mismatch(
                        path,
                        f"resource value {resource!r} does not match "
                        f"{pattern!r} at path {path}",
                    )
        elif not validate_value_with_pattern(resource, pattern):
            raise _Mismatch(
                path,
                f"resource value {resource!r} does not match {pattern!r} "
                f"at path {path}",
            )
    else:
        raise _Mismatch(path, f"failed at {path}: pattern contains unknown type")


def _validate_map(resource_map: dict, pattern_map: dict, origin, path: str, ac: _AnchorTracker) -> None:
    """validate.go:102 validateMap: anchors evaluate first, then the rest
    (nested-anchor-bearing values ahead of plain ones)."""
    pattern_map = expand_in_metadata(pattern_map, resource_map)
    anchors, rest = split_anchors(pattern_map)

    for key, pattern_el in anchors.items():
        _handle_anchor(key, pattern_el, resource_map, origin, path, ac)

    rest_keys = sorted(rest, key=lambda k: not has_nested_anchors(rest[k]))
    for key in rest_keys:
        _handle_anchor(key, rest[key], resource_map, origin, path, ac)


def _handle_anchor(key: str, pattern_el, resource_map: dict, origin, path: str, ac: _AnchorTracker) -> None:
    """anchor/anchor.go:21 CreateElementHandler dispatch."""
    kind = anchor_kind(key)
    bare, _ = remove_anchor(key)
    current = f"{path}{bare}/"

    if kind is Anchor.CONDITION:
        if bare in resource_map:
            try:
                _validate_element(resource_map[bare], pattern_el, origin, current, ac)
            except _Mismatch as e:
                raise _ConditionalAnchorMismatch(e.path, f"conditional anchor mismatch: {e.message}")
        return

    if kind is Anchor.GLOBAL:
        if bare in resource_map:
            try:
                _validate_element(resource_map[bare], pattern_el, origin, current, ac)
            except _Mismatch as e:
                raise _GlobalAnchorMismatch(e.path, f"global anchor mismatch: {e.message}")
        return

    if kind is Anchor.EQUALITY:
        if bare in resource_map:
            _validate_element(resource_map[bare], pattern_el, origin, current, ac)
        return

    if kind is Anchor.NEGATION:
        if bare in resource_map:
            raise _Mismatch(current, f"{current}{bare} is not allowed")
        return

    if kind is Anchor.EXISTENCE:
        if bare in resource_map:
            value = resource_map[bare]
            if not isinstance(value, list):
                raise _Mismatch(
                    current,
                    "existence anchor ^() can be used only on list-type resources",
                )
            if not isinstance(pattern_el, list):
                raise _Mismatch(current, "existence anchor pattern must be a list")
            for pat in pattern_el:
                if not isinstance(pat, dict):
                    raise _Mismatch(
                        current, "existence anchor pattern elements must be maps"
                    )
                _validate_existence(value, pat, origin, current, ac)
        return

    # default handler (anchor.go:105): "*" means key must exist and be non-null
    if pattern_el == "*" and resource_map.get(bare) is not None:
        return
    if pattern_el == "*" and resource_map.get(bare) is None:
        raise _Mismatch(path, f"{path}{bare} not found")
    _validate_element(resource_map.get(bare), pattern_el, origin, current, ac)


def _validate_existence(resource_list: list, pattern_map: dict, origin, path: str, ac: _AnchorTracker) -> None:
    """At least one list element matches the pattern map (anchor.go:262)."""
    for i, el in enumerate(resource_list):
        try:
            _validate_element(el, pattern_map, origin, f"{path}{i}/", ac)
            return
        except _Mismatch:
            continue
    raise _Mismatch(path, f"existence anchor validation failed at path {path}")


def _validate_array(resource_array: list, pattern_array: list, origin, path: str, ac: _AnchorTracker) -> None:
    """validate.go:140 validateArray."""
    if not pattern_array:
        raise _Mismatch(path, "pattern array is empty")

    head = pattern_array[0]
    if isinstance(head, dict):
        # every resource element must match the (single) pattern map, except
        # elements a conditional anchor excludes (validate.go:180)
        for i, el in enumerate(resource_array):
            try:
                _validate_element(el, head, origin, f"{path}{i}/", ac)
            except _ConditionalAnchorMismatch:
                continue
    elif head is None or isinstance(head, _SCALAR):
        _validate_element(resource_array, head, origin, path, ac)
    else:
        if len(resource_array) < len(pattern_array):
            raise _Mismatch(
                path,
                f"validate array failed: resource has {len(resource_array)} "
                f"elements, pattern expects {len(pattern_array)}",
            )
        for i, pattern_el in enumerate(pattern_array):
            try:
                _validate_element(resource_array[i], pattern_el, origin, f"{path}{i}/", ac)
            except _ConditionalAnchorMismatch:
                continue
