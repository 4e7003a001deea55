"""Precondition / deny condition operators.

Mirrors kyverno/pkg/engine/variables/operator/: Equals, NotEquals,
In, AnyIn, AllIn, NotIn, AnyNotIn, AllNotIn, GreaterThan(OrEquals),
LessThan(OrEquals), Duration*. Key/value arrive with variables already
substituted. Semantics notes carried over from the reference:

  - string Equals: durations compare first, then k8s quantities, then the
    condition *value* acts as the wildcard pattern over the key
  - In-family with string key: key is the wildcard pattern over list items;
    a plain-string value may be a JSON-encoded array
  - Any/All-In with list keys: wildcard per-element containment
  - numeric compare coerces int/float/duration/quantity from strings
"""

from __future__ import annotations

import json
import math

from ..utils.duration import DurationError, parse_duration
from ..utils.quantity import QuantityError, parse_quantity
from ..utils.wildcard import wildcard_match


def evaluate_condition(key, operator: str, value) -> bool:
    """variables/evaluate.go:11 Evaluate (substitution already applied)."""
    op = (operator or "").lower()
    if op in ("equal", "equals"):
        return _equal(key, value)
    if op in ("notequal", "notequals"):
        return not _equal(key, value)
    if op == "in":
        return _in(key, value)
    if op == "anyin":
        return _any_in(key, value)
    if op == "allin":
        return _all_in(key, value)
    if op == "notin":
        return _not_in(key, value)
    if op == "anynotin":
        return _any_not_in(key, value)
    if op == "allnotin":
        return _all_not_in(key, value)
    if op in ("greaterthanorequals", "greaterthan", "lessthanorequals", "lessthan"):
        return _numeric(key, op, value)
    if op in (
        "durationgreaterthanorequals",
        "durationgreaterthan",
        "durationlessthanorequals",
        "durationlessthan",
    ):
        return _duration_compare(key, op.removeprefix("duration"), value)
    return False  # unsupported operator


def evaluate_conditions(conditions, evaluate=None) -> bool:
    """variables/evaluate.go:21 EvaluateConditions: {any/all} dict or bare
    list (backwards compat). ``evaluate`` defaults to evaluate_condition on
    already-substituted condition dicts."""
    ev = evaluate or (
        lambda c: evaluate_condition(c.get("key"), c.get("operator", ""), c.get("value"))
    )
    if isinstance(conditions, dict):
        any_conds = conditions.get("any")
        all_conds = conditions.get("all")
        any_ok = True
        if any_conds is not None:
            any_ok = any(ev(c) for c in any_conds)
        all_ok = all(ev(c) for c in (all_conds or []))
        return any_ok and all_ok
    if isinstance(conditions, list):
        return all(ev(c) for c in conditions)
    return False


# ---------------------------------------------------------------- duration


def _parse_duration_pair(key, value) -> tuple[float, float] | None:
    """operator.go:82 parseDuration: at least one side must be a real
    duration string (not "0"); the other may be numeric seconds."""

    def as_duration(x) -> float | None:
        if isinstance(x, str) and x != "0":
            try:
                return parse_duration(x)
            except DurationError:
                return None
        return None

    kd, vd = as_duration(key), as_duration(value)
    if kd is None and vd is None:
        return None

    def as_seconds(x) -> float | None:
        if isinstance(x, bool):
            return None
        if isinstance(x, (int, float)):
            return float(x)
        return None

    if kd is None:
        kd = as_seconds(key)
        if kd is None:
            return None
    if vd is None:
        vd = as_seconds(value)
        if vd is None:
            return None
    return kd, vd


def _compare(a: float, b: float, op: str) -> bool:
    if op == "greaterthanorequals":
        return a >= b
    if op == "greaterthan":
        return a > b
    if op == "lessthanorequals":
        return a <= b
    if op == "lessthan":
        return a < b
    if op in ("equal", "equals"):
        return a == b
    if op in ("notequal", "notequals"):
        return a != b
    return False


def _duration_compare(key, op: str, value) -> bool:
    """duration.go: deprecated Duration* handlers; int/float = seconds."""

    def to_seconds(x) -> float | None:
        if isinstance(x, bool):
            return None
        if isinstance(x, (int, float)):
            return float(x)
        if isinstance(x, str):
            try:
                return parse_duration(x)
            except DurationError:
                return None
        return None

    k, v = to_seconds(key), to_seconds(value)
    if k is None or v is None:
        return False
    return _compare(k, v, op)


# ------------------------------------------------------------------- equal


def _equal(key, value) -> bool:
    if isinstance(key, bool):
        return isinstance(value, bool) and key == value
    if isinstance(key, int):
        return _equal_int(key, value)
    if isinstance(key, float):
        return _equal_float(key, value)
    if isinstance(key, str):
        return _equal_string(key, value)
    if isinstance(key, (dict, list)):
        return type(value) is type(key) and key == value
    return False


def _equal_int(key: int, value) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return value == key
    if isinstance(value, float):
        return value == math.trunc(value) and int(value) == key
    if isinstance(value, str):
        try:
            return int(value, 10) == key
        except ValueError:
            return False
    return False


def _equal_float(key: float, value) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return key == math.trunc(key) and int(key) == value
    if isinstance(value, float):
        return value == key
    if isinstance(value, str):
        try:
            return float(value) == key
        except ValueError:
            return False
    return False


def _equal_string(key: str, value) -> bool:
    pair = _parse_duration_pair(key, value)
    if pair is not None:
        return pair[0] == pair[1]
    try:
        kq = parse_quantity(key)
        if isinstance(value, str):
            try:
                return kq == parse_quantity(value)
            except QuantityError:
                return False
    except QuantityError:
        pass
    if isinstance(value, str):
        return wildcard_match(value, key)  # the condition value is the pattern
    return False


# ---------------------------------------------------------------- in-family
#
# Reference quirks carried over deliberately (in.go / anyin.go / allin.go /
# notin.go / anynotin.go / allnotin.go):
#   - numeric keys Sprint-coerce to strings for In/NotIn/AnyIn/AnyNotIn/
#     AllNotIn, but NOT for AllIn (allin.go has no numeric branch)
#   - a single-element list key equal to a plain-string value short-circuits
#     to "exists" BEFORE the not-in flag applies, so NotIn(['a'], 'a') is true
#   - In/NotIn require string elements in a list value; the Any/All family
#     Sprint-coerces them
#   - In/NotIn set containment is exact; Any/All families use wildcards


def _sprint(v) -> str:
    """Go fmt.Sprint for the value kinds that appear in conditions."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "<nil>"
    if isinstance(v, float) and v == math.trunc(v) and abs(v) < 1e21:
        return str(int(v))  # Go %v prints 5.0 as "5"
    return str(v)


def _as_string_slice(key, coerce: bool) -> list[str] | None:
    if not isinstance(key, list):
        return None
    out = []
    for el in key:
        if isinstance(el, str):
            out.append(el)
        elif coerce:
            out.append(_sprint(el))
        else:
            return None  # reference panics; we fail the condition
    return out


def _key_exists_in_array(key: str, value) -> tuple[bool, bool]:
    """in.go:62 keyExistsInArray -> (invalid_type, exists)."""
    if isinstance(value, list):
        for val in value:
            if wildcard_match(key, _sprint(val)):
                return False, True
        return False, False
    if isinstance(value, str):
        if wildcard_match(value, key):
            return False, True
        try:
            arr = json.loads(value)
        except ValueError:
            return True, False
        if not isinstance(arr, list) or not all(isinstance(x, str) for x in arr):
            return True, False
        return False, key in arr
    return True, False


ALL_IN = "all_in"        # every key present        (isIn / isAllIn)
ANY_IN = "any_in"        # at least one key present (isAnyIn)
ANY_NOT_IN = "any_not_in"  # at least one key absent  (isNotIn / isAnyNotIn)
ALL_NOT_IN = "all_not_in"  # no key present           (isAllNotIn)


def _set_exists_in_array(
    keys: list[str], value, mode: str, wildcard: bool
) -> tuple[bool, bool]:
    """in.go:110 setExistsInArray / anyin.go:69 anySetExistsInArray /
    allin.go allSetExistsInArray -> (invalid_type, result). ``wildcard``
    selects the Any/All-family per-element wildcard containment; In/NotIn
    use exact membership."""
    if isinstance(value, list):
        vals = []
        for v in value:
            if isinstance(v, str):
                vals.append(v)
            elif wildcard:  # Any/All families Sprint-coerce value elements
                vals.append(_sprint(v))
            else:
                return True, False
        return False, _contains(keys, vals, mode, wildcard)
    if isinstance(value, str):
        if len(keys) == 1 and keys[0] == value:
            return False, True  # short-circuits before the mode applies
        try:
            arr = json.loads(value)
        except ValueError:
            return True, False
        if not isinstance(arr, list) or not all(isinstance(x, str) for x in arr):
            return True, False
        return False, _contains(keys, arr, mode, wildcard)
    return True, False


def _contains(keys: list[str], vals: list[str], mode: str, use_wildcard: bool) -> bool:
    if use_wildcard:
        found = sum(1 for k in keys if any(wildcard_match(k, v) for v in vals))
    else:
        vset = set(vals)
        found = sum(1 for k in keys if k in vset)
    if mode == ALL_IN:
        return found == len(keys)
    if mode == ANY_IN:
        return found > 0
    if mode == ANY_NOT_IN:
        return found < len(keys)
    return found == 0  # ALL_NOT_IN


def _numeric_key_to_str(key):
    if isinstance(key, bool):
        return None
    if isinstance(key, (int, float)):
        return _sprint(key)
    return None


def _in(key, value) -> bool:
    k = key if isinstance(key, str) else _numeric_key_to_str(key)
    if k is not None:
        invalid, exists = _key_exists_in_array(k, value)
        return False if invalid else exists
    keys = _as_string_slice(key, coerce=False)
    if keys is not None:
        invalid, result = _set_exists_in_array(keys, value, ALL_IN, wildcard=False)
        return False if invalid else result
    return False


def _not_in(key, value) -> bool:
    k = key if isinstance(key, str) else _numeric_key_to_str(key)
    if k is not None:
        invalid, exists = _key_exists_in_array(k, value)
        return False if invalid else not exists
    keys = _as_string_slice(key, coerce=False)
    if keys is not None:
        invalid, result = _set_exists_in_array(keys, value, ANY_NOT_IN, wildcard=False)
        return False if invalid else result
    return False


def _any_in(key, value) -> bool:
    k = key if isinstance(key, str) else _numeric_key_to_str(key)
    if k is not None:
        invalid, exists = _key_exists_in_array(k, value)
        return False if invalid else exists
    keys = _as_string_slice(key, coerce=True)
    if keys is not None:
        invalid, result = _set_exists_in_array(keys, value, ANY_IN, wildcard=True)
        return False if invalid else result
    return False


def _all_in(key, value) -> bool:
    if isinstance(key, str):
        invalid, exists = _key_exists_in_array(key, value)
        return False if invalid else exists
    keys = _as_string_slice(key, coerce=True)
    if keys is not None:
        invalid, result = _set_exists_in_array(keys, value, ALL_IN, wildcard=True)
        return False if invalid else result
    return False


def _any_not_in(key, value) -> bool:
    k = key if isinstance(key, str) else _numeric_key_to_str(key)
    if k is not None:
        invalid, exists = _key_exists_in_array(k, value)
        return False if invalid else not exists
    keys = _as_string_slice(key, coerce=True)
    if keys is not None:
        invalid, result = _set_exists_in_array(keys, value, ANY_NOT_IN, wildcard=True)
        return False if invalid else result
    return False


def _all_not_in(key, value) -> bool:
    k = key if isinstance(key, str) else _numeric_key_to_str(key)
    if k is not None:
        invalid, exists = _key_exists_in_array(k, value)
        return False if invalid else not exists
    keys = _as_string_slice(key, coerce=True)
    if keys is not None:
        invalid, result = _set_exists_in_array(keys, value, ALL_NOT_IN, wildcard=True)
        return False if invalid else result
    return False


# ----------------------------------------------------------------- numeric


def _numeric(key, op: str, value) -> bool:
    """numeric.go NumericOperatorHandler."""
    if isinstance(key, bool):
        return False
    if isinstance(key, (int, float)):
        return _numeric_number_key(float(key), op, value)
    if isinstance(key, str):
        return _numeric_string_key(key, op, value)
    return False


def _numeric_number_key(key: float, op: str, value) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, (int, float)):
        return _compare(key, float(value), op)
    if isinstance(value, str):
        pair = _parse_duration_pair(key, value)
        if pair is not None:
            return _compare(pair[0], pair[1], op)
        try:
            return _compare(key, float(value), op)
        except ValueError:
            return False
    return False


def _numeric_string_key(key: str, op: str, value) -> bool:
    """numeric.go:144: duration pair, then float key, then int key, then
    resource quantity (whose value must be a quantity *string*)."""
    pair = _parse_duration_pair(key, value)
    if pair is not None:
        return _compare(pair[0], pair[1], op)
    try:
        kf = float(key)
    except ValueError:
        kf = None
    if kf is not None:
        return _numeric_number_key(kf, op, value)
    try:
        kq = parse_quantity(key)
    except QuantityError:
        return False
    if not isinstance(value, str):
        return False
    try:
        vq = parse_quantity(value)
    except QuantityError:
        return False
    cmp = -1 if kq < vq else (1 if kq > vq else 0)
    return _compare(float(cmp), 0.0, op)
