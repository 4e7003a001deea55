"""JMESPath tree-walking evaluator."""

from __future__ import annotations

from .errors import JMESPathError, NotFoundError
from .functions import FUNCTIONS, Expref
from .parser import compile as compile_expr


def is_false(value) -> bool:
    """JMESPath truthiness: null, empty string/array/object, and False are
    false-like."""
    return (
        value is None
        or value is False
        or (isinstance(value, (str, list, dict)) and len(value) == 0)
    )


def search(expression: str, data):
    return evaluate(compile_expr(expression), data)


def evaluate(node, value):
    tag = node[0]
    return _HANDLERS[tag](node, value)


def _soft(node, value):
    """Evaluate treating the fork's missing-key NotFoundError as null.

    The hard error is only wanted on the *spine* of a path expression (so
    unresolved {{variables}} are detected); inside projections, filters,
    logical operators, comparators, and function arguments a missing key
    behaves like standard-JMESPath null."""
    try:
        return evaluate(node, value)
    except NotFoundError:
        return None


def _identity(node, value):
    return value


def _current(node, value):
    return value


def _literal(node, value):
    return node[1]


def _field(node, value):
    # The reference pins the kyverno/go-jmespath fork (go.mod:64), which
    # turns a missing map key into a NotFoundError instead of null — the
    # variable system depends on this to detect unresolved variables.
    if isinstance(value, dict):
        if node[1] not in value:
            raise NotFoundError(f'Unknown key "{node[1]}" in path')
        return value[node[1]]
    return None


def _subexpression(node, value):
    left = evaluate(node[1], value)
    if left is None:
        return None
    return evaluate(node[2], left)


def _index_expression(node, value):
    left = evaluate(node[1], value)
    return evaluate(node[2], left)


def _index(node, value):
    if not isinstance(value, list):
        return None
    i = node[1]
    if -len(value) <= i < len(value):
        return value[i]
    return None


def _slice(node, value):
    if not isinstance(value, list):
        return None
    start, stop, step = node[1], node[2], node[3]
    if step == 0:
        raise JMESPathError("slice step cannot be 0")
    return value[slice(start, stop, step)]


def _projection(node, value):
    base = evaluate(node[1], value)
    if not isinstance(base, list):
        return None
    out = []
    for el in base:
        r = _soft(node[2], el)
        if r is not None:
            out.append(r)
    return out


def _value_projection(node, value):
    base = evaluate(node[1], value)
    if not isinstance(base, dict):
        return None
    out = []
    for el in base.values():
        r = _soft(node[2], el)
        if r is not None:
            out.append(r)
    return out


def _flatten_projection(node, value):
    base = evaluate(node[1], value)
    if not isinstance(base, list):
        return None
    merged = []
    for el in base:
        if isinstance(el, list):
            merged.extend(el)
        else:
            merged.append(el)
    right = node[2] or ("identity",)
    out = []
    for el in merged:
        r = _soft(right, el)
        if r is not None:
            out.append(r)
    return out


def _filter_projection(node, value):
    base = evaluate(node[1], value)
    if not isinstance(base, list):
        return None
    cond = node[3]
    right = node[2] or ("identity",)
    out = []
    for el in base:
        if not is_false(_soft(cond, el)):
            r = _soft(right, el)
            if r is not None:
                out.append(r)
    return out


def _comparator(node, value):
    op = node[1]
    left = _soft(node[2], value)
    right = _soft(node[3], value)
    if op == "==":
        return _deep_eq(left, right)
    if op == "!=":
        return not _deep_eq(left, right)
    if not _is_number(left) or not _is_number(right):
        return None  # ordering comparators only apply to numbers
    if op == "<":
        return left < right
    if op == "<=":
        return left <= right
    if op == ">":
        return left > right
    if op == ">=":
        return left >= right
    raise JMESPathError(f"unknown comparator {op}")


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _deep_eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b if isinstance(a, bool) and isinstance(b, bool) else False
    if _is_number(a) and _is_number(b):
        return a == b
    if type(a) is not type(b):
        return False
    return a == b


def _or(node, value):
    left = _soft(node[1], value)
    if is_false(left):
        return _soft(node[2], value)
    return left


def _and(node, value):
    left = _soft(node[1], value)
    if is_false(left):
        return left
    return _soft(node[2], value)


def _not(node, value):
    return is_false(_soft(node[1], value))


def _pipe(node, value):
    return evaluate(node[2], evaluate(node[1], value))


def _multiselect_list(node, value):
    if value is None:
        return None
    return [_soft(e, value) for e in node[1]]


def _multiselect_dict(node, value):
    if value is None:
        return None
    return {k: _soft(e, value) for k, e in node[1]}


def _function(node, value):
    name = node[1]
    fn = FUNCTIONS.get(name)
    if fn is None:
        raise JMESPathError(f"unknown function: {name}()")
    args = [_soft(a, value) for a in node[2]]
    return fn(args)


def _expref(node, value):
    return Expref(node[1], _soft)


_HANDLERS = {
    "identity": _identity,
    "current": _current,
    "literal": _literal,
    "field": _field,
    "subexpression": _subexpression,
    "index_expression": _index_expression,
    "index": _index,
    "slice": _slice,
    "projection": _projection,
    "value_projection": _value_projection,
    "flatten_projection": _flatten_projection,
    "filter_projection": _filter_projection,
    "comparator": _comparator,
    "or": _or,
    "and": _and,
    "not": _not,
    "pipe": _pipe,
    "multiselect_list": _multiselect_list,
    "multiselect_dict": _multiselect_dict,
    "function": _function,
    "expref": _expref,
}
