"""Fast deep copy for JSON trees.

``copy.deepcopy`` pays for memoization and type dispatch that pure JSON
documents (dict/list/scalars, no cycles) never need; profiling shows it
dominating the mutation hot path (Context.add_resource / merge_patch /
checkpoint). ``json_copy`` is the 3-5x cheaper specialization, falling
back to ``copy.deepcopy`` for any non-JSON node it encounters.
"""

from __future__ import annotations

import copy

_SCALARS = (str, int, float, bool, type(None))


def json_copy(x, _memo: dict | None = None):
    """Deep copy preserving shared subtrees (YAML anchors/aliases load as
    shared objects; copying each occurrence separately would blow up
    billion-laughs-style documents and recurse forever on self-references,
    so containers are memoized by id like copy.deepcopy does)."""
    tx = type(x)
    if tx is dict:
        if _memo is None:
            _memo = {}
        got = _memo.get(id(x))
        if got is not None:
            return got
        out: dict = {}
        _memo[id(x)] = out
        for k, v in x.items():
            out[k] = json_copy(v, _memo)
        return out
    if tx is list:
        if _memo is None:
            _memo = {}
        got = _memo.get(id(x))
        if got is not None:
            return got
        out_l: list = []
        _memo[id(x)] = out_l
        for v in x:
            out_l.append(json_copy(v, _memo))
        return out_l
    if tx in _SCALARS or isinstance(x, _SCALARS):
        return x
    return copy.deepcopy(x, _memo)
