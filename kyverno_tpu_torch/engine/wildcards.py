"""Wildcard expansion helpers for metadata maps and label selectors.

Mirrors kyverno/pkg/engine/wildcards/wildcards.go: validation
patterns may use globs in metadata.labels / metadata.annotations *keys*;
before matching, such keys are replaced by the first matching concrete key
from the resource (values are matched later by the normal leaf comparator).
"""

from __future__ import annotations

from .anchors import add_anchor, remove_anchor
from ..utils.wildcard import has_wildcards, wildcard_match


def replace_in_selector(match_labels: dict, resource_labels: dict) -> dict:
    """Expand wildcard keys AND values in a labelSelector.matchLabels map
    against the resource's labels (wildcards.go:14)."""
    result = {}
    for k, v in match_labels.items():
        if has_wildcards(k) or has_wildcards(str(v)):
            nk, nv = _expand(k, str(v), resource_labels, match_value=True, replace=True)
            result[nk] = nv
        else:
            result[k] = v
    return result


def _expand(k: str, v: str, resource_map: dict, match_value: bool, replace: bool):
    for rk, rv in resource_map.items():
        if wildcard_match(k, rk):
            if not match_value:
                return rk, rv
            if wildcard_match(v, str(rv)):
                return rk, rv
    if replace:
        k = k.replace("*", "0").replace("?", "0")
        v = v.replace("*", "0").replace("?", "0")
    return k, v


def expand_in_metadata(pattern_map: dict, resource_map: dict) -> dict:
    """Expand wildcard keys under pattern metadata.labels/annotations using
    the resource's concrete keys (wildcards.go:69). Anchors on the keys are
    preserved. Returns a (possibly new) pattern map; never mutates input."""
    meta_key, pattern_meta = _get_anchored(pattern_map, "metadata")
    if not isinstance(pattern_meta, dict):
        return pattern_map
    resource_meta = resource_map.get("metadata")
    if not isinstance(resource_meta, dict):
        return pattern_map

    new_meta = dict(pattern_meta)
    changed = False
    for tag in ("labels", "annotations"):
        pkey, pdata = _get_anchored(pattern_meta, tag)
        if not isinstance(pdata, dict):
            continue
        _, rdata = _get_anchored(resource_meta, tag)
        if not isinstance(rdata, dict):
            continue
        expanded = {}
        for k, v in pdata.items():
            if has_wildcards(k):
                bare, prefix = remove_anchor(k)
                nk, _ = _expand(bare, str(v), rdata, match_value=False, replace=False)
                if prefix:
                    nk = add_anchor(nk, prefix)
                expanded[nk] = v
            else:
                expanded[k] = v
        new_meta[pkey] = expanded
        changed = True

    if not changed:
        return pattern_map
    out = dict(pattern_map)
    out[meta_key] = new_meta
    return out


def _get_anchored(m: dict, tag: str):
    """Find key equal to ``tag`` modulo anchor decoration."""
    for k, v in m.items():
        if remove_anchor(k)[0] == tag:
            return k, v
    return "", None
