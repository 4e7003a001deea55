"""JMESPath builtin functions + the kyverno dialect extensions.

Builtins follow the JMESPath spec. Extensions mirror
kyverno/pkg/engine/jmespath/functions.go (19 functions).
"""

from __future__ import annotations

import base64
import json
import math
import re

from .errors import FunctionError


class Expref:
    """An &expression argument (passed to sort_by/max_by/map/...)."""

    def __init__(self, node, evaluate):
        self.node = node
        self._evaluate = evaluate

    def __call__(self, value):
        return self._evaluate(self.node, value)


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _typeof(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if _is_number(v):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    if isinstance(v, Expref):
        return "expref"
    raise FunctionError(f"unknown type: {type(v)}")


def _require(args, n, name):
    if len(args) != n:
        raise FunctionError(f"{name}() takes {n} arguments, got {len(args)}")


def _require_type(v, types, name, argn):
    if _typeof(v) not in types:
        raise FunctionError(
            f"{name}() argument {argn} must be {'/'.join(types)}, got {_typeof(v)}"
        )
    return v


def _as_str(v, name, argn):
    """Kyverno's regex helpers accept strings or numbers (functions.go)."""
    if isinstance(v, str):
        return v
    if _is_number(v):
        if isinstance(v, float) and v == math.trunc(v):
            return str(int(v))
        return str(v)
    raise FunctionError(f"{name}() argument {argn} must be string or number")


# ------------------------------------------------------------------ builtins


def _fn_abs(args):
    _require(args, 1, "abs")
    _require_type(args[0], ["number"], "abs", 1)
    return abs(args[0])


def _fn_avg(args):
    _require(args, 1, "avg")
    arr = _require_type(args[0], ["array"], "avg", 1)
    if not arr:
        return None
    for v in arr:
        if not _is_number(v):
            raise FunctionError("avg() requires an array of numbers")
    return sum(arr) / len(arr)


def _fn_ceil(args):
    _require(args, 1, "ceil")
    _require_type(args[0], ["number"], "ceil", 1)
    return math.ceil(args[0])


def _fn_contains(args):
    _require(args, 2, "contains")
    subject = _require_type(args[0], ["array", "string"], "contains", 1)
    if isinstance(subject, str):
        if not isinstance(args[1], str):
            return False
        return args[1] in subject
    return args[1] in subject


def _fn_ends_with(args):
    _require(args, 2, "ends_with")
    s = _require_type(args[0], ["string"], "ends_with", 1)
    suffix = _require_type(args[1], ["string"], "ends_with", 2)
    return s.endswith(suffix)


def _fn_floor(args):
    _require(args, 1, "floor")
    _require_type(args[0], ["number"], "floor", 1)
    return math.floor(args[0])


def _fn_join(args):
    _require(args, 2, "join")
    sep = _require_type(args[0], ["string"], "join", 1)
    arr = _require_type(args[1], ["array"], "join", 2)
    for v in arr:
        if not isinstance(v, str):
            raise FunctionError("join() requires an array of strings")
    return sep.join(arr)


def _fn_keys(args):
    _require(args, 1, "keys")
    obj = _require_type(args[0], ["object"], "keys", 1)
    return list(obj.keys())


def _fn_length(args):
    _require(args, 1, "length")
    v = _require_type(args[0], ["string", "array", "object"], "length", 1)
    return len(v)


def _fn_map(args):
    _require(args, 2, "map")
    expref = _require_type(args[0], ["expref"], "map", 1)
    arr = _require_type(args[1], ["array"], "map", 2)
    return [expref(v) for v in arr]


def _fn_max(args):
    _require(args, 1, "max")
    arr = _require_type(args[0], ["array"], "max", 1)
    if not arr:
        return None
    if all(_is_number(v) for v in arr) or all(isinstance(v, str) for v in arr):
        return max(arr)
    raise FunctionError("max() requires a homogeneous array of numbers or strings")


def _fn_max_by(args):
    _require(args, 2, "max_by")
    arr = _require_type(args[0], ["array"], "max_by", 1)
    expref = _require_type(args[1], ["expref"], "max_by", 2)
    if not arr:
        return None
    keyed = [(expref(v), v) for v in arr]
    _check_by_keys(keyed, "max_by")
    return max(keyed, key=lambda kv: kv[0])[1]


def _fn_merge(args):
    if not args:
        raise FunctionError("merge() requires at least one argument")
    out = {}
    for a in args:
        _require_type(a, ["object"], "merge", 1)
        out.update(a)
    return out


def _fn_min(args):
    _require(args, 1, "min")
    arr = _require_type(args[0], ["array"], "min", 1)
    if not arr:
        return None
    if all(_is_number(v) for v in arr) or all(isinstance(v, str) for v in arr):
        return min(arr)
    raise FunctionError("min() requires a homogeneous array of numbers or strings")


def _fn_min_by(args):
    _require(args, 2, "min_by")
    arr = _require_type(args[0], ["array"], "min_by", 1)
    expref = _require_type(args[1], ["expref"], "min_by", 2)
    if not arr:
        return None
    keyed = [(expref(v), v) for v in arr]
    _check_by_keys(keyed, "min_by")
    return min(keyed, key=lambda kv: kv[0])[1]


def _check_by_keys(keyed, name):
    keys = [k for k, _ in keyed]
    if not (all(_is_number(k) for k in keys) or all(isinstance(k, str) for k in keys)):
        raise FunctionError(f"{name}() expression must produce numbers or strings")


def _fn_not_null(args):
    if not args:
        raise FunctionError("not_null() requires at least one argument")
    for a in args:
        if a is not None:
            return a
    return None


def _fn_reverse(args):
    _require(args, 1, "reverse")
    v = _require_type(args[0], ["array", "string"], "reverse", 1)
    if isinstance(v, str):
        return v[::-1]
    return list(reversed(v))


def _fn_sort(args):
    _require(args, 1, "sort")
    arr = _require_type(args[0], ["array"], "sort", 1)
    if not arr:
        return []
    if all(_is_number(v) for v in arr) or all(isinstance(v, str) for v in arr):
        return sorted(arr)
    raise FunctionError("sort() requires a homogeneous array of numbers or strings")


def _fn_sort_by(args):
    _require(args, 2, "sort_by")
    arr = _require_type(args[0], ["array"], "sort_by", 1)
    expref = _require_type(args[1], ["expref"], "sort_by", 2)
    if not arr:
        return []
    keyed = [(expref(v), v) for v in arr]
    _check_by_keys(keyed, "sort_by")
    return [v for _, v in sorted(keyed, key=lambda kv: kv[0])]


def _fn_starts_with(args):
    _require(args, 2, "starts_with")
    s = _require_type(args[0], ["string"], "starts_with", 1)
    prefix = _require_type(args[1], ["string"], "starts_with", 2)
    return s.startswith(prefix)


def _fn_sum(args):
    _require(args, 1, "sum")
    arr = _require_type(args[0], ["array"], "sum", 1)
    for v in arr:
        if not _is_number(v):
            raise FunctionError("sum() requires an array of numbers")
    return sum(arr)


def _fn_to_array(args):
    _require(args, 1, "to_array")
    if isinstance(args[0], list):
        return args[0]
    return [args[0]]  # spec: any non-array (incl. null) wraps to [value]


def _fn_to_number(args):
    _require(args, 1, "to_number")
    v = args[0]
    if _is_number(v):
        return v
    if isinstance(v, str):
        try:
            f = float(v)
            return int(f) if f == math.trunc(f) and ("e" not in v.lower() and "." not in v) else f
        except ValueError:
            return None
    return None


def _fn_to_string(args):
    _require(args, 1, "to_string")
    if isinstance(args[0], str):
        return args[0]
    return json.dumps(args[0], separators=(",", ":"))


def _fn_type(args):
    _require(args, 1, "type")
    return _typeof(args[0])


def _fn_values(args):
    _require(args, 1, "values")
    obj = _require_type(args[0], ["object"], "values", 1)
    return list(obj.values())


# ---------------------------------------------------------- kyverno dialect


def _kf_compare(args):
    _require(args, 2, "compare")
    a = _require_type(args[0], ["string"], "compare", 1)
    b = _require_type(args[1], ["string"], "compare", 2)
    return -1 if a < b else (1 if a > b else 0)


def _kf_equal_fold(args):
    _require(args, 2, "equal_fold")
    a = _require_type(args[0], ["string"], "equal_fold", 1)
    b = _require_type(args[1], ["string"], "equal_fold", 2)
    return a.casefold() == b.casefold()


def _kf_replace(args):
    _require(args, 4, "replace")
    s = _require_type(args[0], ["string"], "replace", 1)
    old = _require_type(args[1], ["string"], "replace", 2)
    new = _require_type(args[2], ["string"], "replace", 3)
    n = _require_type(args[3], ["number"], "replace", 4)
    n = int(n)
    if n < 0:
        return s.replace(old, new)
    return s.replace(old, new, n)


def _kf_replace_all(args):
    _require(args, 3, "replace_all")
    s = _require_type(args[0], ["string"], "replace_all", 1)
    old = _require_type(args[1], ["string"], "replace_all", 2)
    new = _require_type(args[2], ["string"], "replace_all", 3)
    return s.replace(old, new)


def _kf_to_upper(args):
    _require(args, 1, "to_upper")
    return _require_type(args[0], ["string"], "to_upper", 1).upper()


def _kf_to_lower(args):
    _require(args, 1, "to_lower")
    return _require_type(args[0], ["string"], "to_lower", 1).lower()


def _kf_trim(args):
    _require(args, 2, "trim")
    s = _require_type(args[0], ["string"], "trim", 1)
    cutset = _require_type(args[1], ["string"], "trim", 2)
    return s.strip(cutset)  # Go strings.Trim semantics: cutset of chars


def _kf_split(args):
    _require(args, 2, "split")
    s = _require_type(args[0], ["string"], "split", 1)
    sep = _require_type(args[1], ["string"], "split", 2)
    if sep == "":
        return list(s)
    return s.split(sep)


def _go_expand_repl(compiled: re.Pattern, repl: str):
    """Build a replacement callable with Go Regexp.ReplaceAllString
    semantics: $N / $name / ${name} expand to the matched group, and
    references to groups that don't exist expand to the empty string
    (Python's re raises instead)."""

    def expand(m: re.Match) -> str:
        out = []
        i, n = 0, len(repl)
        while i < n:
            c = repl[i]
            if c != "$":
                out.append(c)
                i += 1
                continue
            if i + 1 < n and repl[i + 1] == "$":
                out.append("$")
                i += 2
                continue
            j = i + 1
            braced = j < n and repl[j] == "{"
            if braced:
                j += 1
            start = j
            while j < n and (repl[j].isalnum() or repl[j] == "_"):
                j += 1
            name = repl[start:j]
            if braced:
                if j < n and repl[j] == "}":
                    j += 1
                else:  # unterminated ${ — Go emits nothing
                    i = j
                    continue
            if not name:
                out.append("$")
                i += 1
                continue
            if name.isdigit():
                idx = int(name)
                out.append((m.group(idx) or "") if idx <= compiled.groups else "")
            else:
                out.append((m.group(name) or "") if name in compiled.groupindex else "")
            i = j
        return "".join(out)

    return expand


def _kf_regex_replace_all(args):
    _require(args, 3, "regex_replace_all")
    pattern = _require_type(args[0], ["string"], "regex_replace_all", 1)
    src = _as_str(args[1], "regex_replace_all", 2)
    repl = _as_str(args[2], "regex_replace_all", 3)
    try:
        compiled = re.compile(pattern)
        return compiled.sub(_go_expand_repl(compiled, repl), src)
    except re.error as e:
        raise FunctionError(f"regex_replace_all(): {e}")


def _kf_regex_replace_all_literal(args):
    _require(args, 3, "regex_replace_all_literal")
    pattern = _require_type(args[0], ["string"], "regex_replace_all_literal", 1)
    src = _as_str(args[1], "regex_replace_all_literal", 2)
    repl = _as_str(args[2], "regex_replace_all_literal", 3)
    try:
        return re.sub(pattern, lambda m: repl, src)
    except re.error as e:
        raise FunctionError(f"regex_replace_all_literal(): {e}")


def _kf_regex_match(args):
    _require(args, 2, "regex_match")
    pattern = _require_type(args[0], ["string"], "regex_match", 1)
    s = _as_str(args[1], "regex_match", 2)
    try:
        return re.search(pattern, s) is not None
    except re.error as e:
        raise FunctionError(f"regex_match(): {e}")


def _kf_label_match(args):
    """True iff every (k, v) of the selector object is present in the labels
    object (functions.go jpLabelMatch)."""
    _require(args, 2, "label_match")
    selector = _require_type(args[0], ["object"], "label_match", 1)
    labels = _require_type(args[1], ["object"], "label_match", 2)
    return all(labels.get(k) == v for k, v in selector.items())


def _numeric_pair(args, name):
    _require(args, 2, name)
    a = _require_type(args[0], ["number"], name, 1)
    b = _require_type(args[1], ["number"], name, 2)
    return a, b


def _kf_add(args):
    a, b = _numeric_pair(args, "add")
    return a + b


def _kf_subtract(args):
    a, b = _numeric_pair(args, "subtract")
    return a - b


def _kf_multiply(args):
    a, b = _numeric_pair(args, "multiply")
    return a * b


def _kf_divide(args):
    a, b = _numeric_pair(args, "divide")
    if b == 0:
        raise FunctionError("divide: division by zero")
    r = a / b
    return r


def _kf_modulo(args):
    a, b = _numeric_pair(args, "modulo")
    ia, ib = int(a), int(b)
    if ia != a or ib != b:
        raise FunctionError("modulo: operands must be integers")
    if ib == 0:
        raise FunctionError("modulo: division by zero")
    return int(math.fmod(ia, ib))  # Go % truncates toward zero


def _kf_base64_decode(args):
    _require(args, 1, "base64_decode")
    s = _require_type(args[0], ["string"], "base64_decode", 1)
    try:
        return base64.b64decode(s).decode("utf-8")
    except Exception as e:
        raise FunctionError(f"base64_decode(): {e}")


def _kf_base64_encode(args):
    _require(args, 1, "base64_encode")
    s = _require_type(args[0], ["string"], "base64_encode", 1)
    return base64.b64encode(s.encode("utf-8")).decode("ascii")


FUNCTIONS = {
    # spec builtins
    "abs": _fn_abs,
    "avg": _fn_avg,
    "ceil": _fn_ceil,
    "contains": _fn_contains,
    "ends_with": _fn_ends_with,
    "floor": _fn_floor,
    "join": _fn_join,
    "keys": _fn_keys,
    "length": _fn_length,
    "map": _fn_map,
    "max": _fn_max,
    "max_by": _fn_max_by,
    "merge": _fn_merge,
    "min": _fn_min,
    "min_by": _fn_min_by,
    "not_null": _fn_not_null,
    "reverse": _fn_reverse,
    "sort": _fn_sort,
    "sort_by": _fn_sort_by,
    "starts_with": _fn_starts_with,
    "sum": _fn_sum,
    "to_array": _fn_to_array,
    "to_number": _fn_to_number,
    "to_string": _fn_to_string,
    "type": _fn_type,
    "values": _fn_values,
    # kyverno dialect (functions.go:57)
    "compare": _kf_compare,
    "equal_fold": _kf_equal_fold,
    "replace": _kf_replace,
    "replace_all": _kf_replace_all,
    "to_upper": _kf_to_upper,
    "to_lower": _kf_to_lower,
    "trim": _kf_trim,
    "split": _kf_split,
    "regex_replace_all": _kf_regex_replace_all,
    "regex_replace_all_literal": _kf_regex_replace_all_literal,
    "regex_match": _kf_regex_match,
    "label_match": _kf_label_match,
    "add": _kf_add,
    "subtract": _kf_subtract,
    "multiply": _kf_multiply,
    "divide": _kf_divide,
    "modulo": _kf_modulo,
    "base64_decode": _kf_base64_decode,
    "base64_encode": _kf_base64_encode,
}
