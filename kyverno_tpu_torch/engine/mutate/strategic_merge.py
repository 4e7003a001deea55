"""Strategic-merge patch: anchor preprocessing + schema-keyed list merge.

Mirrors kyverno/pkg/engine/mutate/strategicPreprocessing.go (the
anchor-resolving walk run *before* the merge) and the kustomize kyaml
``patchstrategicmerge`` filter used at strategicMergePatch.go:100-107. The
reference leans on kyaml + the Kubernetes OpenAPI schema for merge keys;
here the merge is implemented directly on JSON trees with the well-known
k8s merge-key table, which covers the same policy corpus without dragging a
YAML object model onto the hot path.
"""

from __future__ import annotations

from ...utils.jsoncopy import json_copy

from ..anchors import (
    is_addition_anchor,
    is_condition_anchor,
    is_global_anchor,
    remove_anchor,
)
from ..validate_pattern import match_pattern


class ConditionError(Exception):
    """strategicPreprocessing.go:13: a condition anchor failed -> skip
    element (in lists) or the whole rule (in maps)."""


class GlobalConditionError(Exception):
    """strategicPreprocessing.go:25: a global anchor failed -> skip rule."""


def _contains_condition(key: str) -> bool:
    """anchor/common ContainsCondition: condition or global anchor."""
    return is_condition_anchor(key) or is_global_anchor(key)


def _has_anchor(key: str) -> bool:
    """strategicPreprocessing.go:262 hasAnchor."""
    return _contains_condition(key) or is_addition_anchor(key)


# ------------------------------------------------------------ preprocessing


def pre_process_pattern(pattern, resource):
    """strategicPreprocessing.go:47 preProcessPattern. Returns the
    anchor-resolved patch (a new tree); raises ConditionError /
    GlobalConditionError when the rule must be skipped."""
    pattern = json_copy(pattern)
    _pre_process_recursive(pattern, resource)
    if isinstance(pattern, dict):
        _delete_condition_elements(pattern)
    return pattern


def _pre_process_recursive(pattern, resource) -> None:
    if isinstance(pattern, dict):
        _walk_map(pattern, resource)
    elif isinstance(pattern, list):
        _walk_list(pattern, resource)


def _walk_map(pattern: dict, resource) -> None:
    """strategicPreprocessing.go:67 walkMap."""
    _validate_conditions(pattern, resource)
    _handle_addings(pattern, resource)

    for field in [k for k in pattern if not _has_anchor(k)]:
        resource_value = None
        if isinstance(resource, dict) and field in resource:
            resource_value = resource[field]
        _pre_process_recursive(pattern[field], resource_value)


def _walk_list(pattern: list, resource) -> None:
    """strategicPreprocessing.go:104 walkList."""
    if not pattern:
        return
    if isinstance(pattern[0], dict):
        _process_list_of_maps(pattern, resource)


def _process_list_of_maps(pattern: list, resource) -> None:
    """strategicPreprocessing.go:124 processListOfMaps: anchored pattern
    elements expand into per-resource-element patches keyed by "name"."""
    resource_elements = resource if isinstance(resource, list) else []
    new_elements = []

    for pattern_element in list(pattern):
        if not isinstance(pattern_element, dict):
            continue
        has_any_anchor = _has_anchors(pattern_element, _has_anchor)
        if not has_any_anchor:
            continue
        has_global = _has_anchors(pattern_element, is_global_anchor)

        any_global_passed = False
        last_global_error: GlobalConditionError | None = None

        for resource_element in resource_elements:
            candidate = json_copy(pattern_element)
            try:
                _pre_process_recursive(candidate, resource_element)
            except ConditionError:
                continue
            except GlobalConditionError as e:
                last_global_error = e
                continue

            if has_global:
                any_global_passed = True

            # kustomize matches list elements by name; elements without a
            # name can't be addressed, skip them (strategicPreprocessing.go:165)
            if not isinstance(resource_element, dict):
                continue
            name = resource_element.get("name")
            if not name:
                continue

            new_node = json_copy(candidate)
            if _delete_conditions_from_nested_maps(new_node):
                continue  # nothing left to patch
            new_node["name"] = name
            new_elements.append(new_node)

        if not any_global_passed and last_global_error is not None:
            raise last_global_error

    pattern.extend(new_elements)


def _has_anchors(pattern, is_anchor) -> bool:
    """strategicPreprocessing.go:264 hasAnchors (maps only, recursive)."""
    if isinstance(pattern, dict):
        for key, value in pattern.items():
            if is_anchor(key):
                return True
            if value is not None and _has_anchors(value, is_anchor):
                return True
    return False


def _validate_conditions(pattern: dict, resource) -> None:
    """strategicPreprocessing.go:211 validateConditions."""
    try:
        _validate_conditions_internal(pattern, resource, is_global_anchor)
    except ConditionError as e:
        raise GlobalConditionError(str(e)) from e
    _validate_conditions_internal(pattern, resource, is_condition_anchor)


def _validate_conditions_internal(pattern: dict, resource, key_filter) -> None:
    for key in [k for k in pattern if key_filter(k)]:
        bare, _ = remove_anchor(key)
        if not isinstance(resource, dict) or bare not in resource:
            raise ConditionError(f'could not find "{bare}" key in the resource')
        result = match_pattern(resource[bare], pattern[key])
        if not result.matched:
            raise ConditionError(result.message or f"condition failed for {bare}")


def _handle_addings(pattern: dict, resource) -> None:
    """strategicPreprocessing.go:231 handleAddings: +(key) is dropped when
    the resource already has the field, unwrapped otherwise."""
    for key in [k for k in pattern if is_addition_anchor(k)]:
        bare, _ = remove_anchor(key)
        value = pattern.pop(key)
        if isinstance(resource, dict) and bare in resource:
            continue  # resource already has this field
        pattern[bare] = value


def _delete_conditions_from_nested_maps(pattern) -> bool:
    """strategicPreprocessing.go:337: strip condition keys everywhere;
    returns True when the map became empty."""
    if not isinstance(pattern, dict):
        return False
    for key in list(pattern):
        if _contains_condition(key):
            del pattern[key]
        else:
            child = pattern[key]
            if child is not None and _delete_conditions_from_nested_maps(child):
                del pattern[key]
    return len(pattern) == 0


def _delete_condition_elements(pattern: dict) -> None:
    """strategicPreprocessing.go:380 deleteConditionElements."""
    for field in list(pattern):
        if _delete_anchors(pattern[field]):
            del pattern[field]


def _delete_anchors(node) -> bool:
    """strategicPreprocessing.go:398 deleteAnchors: remove anchors; return
    True when the node consisted only of anchors and must be dropped."""
    if isinstance(node, dict):
        return _delete_anchors_in_map(node)
    if isinstance(node, list):
        return _delete_anchors_in_list(node)
    return False


def _delete_anchors_in_map(node: dict) -> bool:
    for key in [k for k in node if _contains_condition(k)]:
        del node[key]
    need_to_delete = True
    for field in list(node):
        if _delete_anchors(node[field]):
            del node[field]
        else:
            need_to_delete = False
    return need_to_delete


def _delete_anchors_in_list(node: list) -> bool:
    was_empty = len(node) == 0
    for element in list(node):
        if _has_anchors(element, _has_anchor):
            node.remove(element)
        elif _delete_anchors(element):
            node.remove(element)
    return len(node) == 0 and not was_empty


# ------------------------------------------------------------ merge

# Well-known Kubernetes strategic-merge keys (a static slice of the OpenAPI
# x-kubernetes-patch-merge-key metadata kyaml consults).
_MERGE_KEY_CANDIDATES = ("name", "containerPort", "mountPath", "devicePath", "ip", "topologyKey")


def _find_merge_key(elements: list) -> str | None:
    for key in _MERGE_KEY_CANDIDATES:
        if all(isinstance(e, dict) and key in e for e in elements):
            return key
    return None


def merge(patch, base):
    """kyaml merge2 semantics on JSON trees: maps merge recursively (null
    deletes), keyed lists merge by merge key, everything else replaces."""
    if isinstance(patch, dict) and isinstance(base, dict):
        out = dict(base)
        for key, value in patch.items():
            if value is None:
                out.pop(key, None)
            elif key in out:
                out[key] = merge(value, out[key])
            else:
                out[key] = json_copy(value)
        return out
    if isinstance(patch, list) and isinstance(base, list):
        if patch and base:
            key = _find_merge_key(patch)
            if key is not None and all(isinstance(e, dict) and key in e for e in base):
                out = [json_copy(e) for e in base]
                index = {e[key]: i for i, e in enumerate(out)}
                for el in patch:
                    if el[key] in index:
                        out[index[el[key]]] = merge(el, out[index[el[key]]])
                    else:
                        out.append(json_copy(el))
                return out
        return json_copy(patch)
    return json_copy(patch)


def strategic_merge_patch(base: dict, overlay):
    """strategicMergePatch.go:85: preprocess anchors then merge. Returns the
    patched resource; a condition failure returns ``base`` unchanged (the
    reference substitutes an empty patch)."""
    try:
        patch = pre_process_pattern(overlay, base)
    except (ConditionError, GlobalConditionError):
        return json_copy(base)
    return merge(patch, base)
