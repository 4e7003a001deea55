"""Leaf comparator: scalar resource value vs scalar pattern.

Semantics mirror kyverno/pkg/engine/validate/pattern.go and
pkg/engine/operator/operator.go:
  - operators: == (default, wildcard), ! (negated wildcard), > >= < <=,
    ranges "a-b" (inside) and "a!-b" (outside)
  - "|"-separated alternatives (OR) each of which may be "&"-joined (AND)
  - numeric-looking operands compare as k8s quantities ("1Gi" > "500Mi")
  - everything else compares as a glob wildcard over the stringified value

This module is the executable specification for the device leaf kernel
(ops/eval.py): the compiler decomposes each pattern through the same
parse path and emits (op, operand) lanes; results must agree everywhere.
"""

from __future__ import annotations

import re
from enum import Enum

from ..utils.gofmt import (
    convert_number_to_string,
    value_to_string_for_equality,
)
from ..utils.quantity import QuantityError, parse_quantity
from ..utils.wildcard import wildcard_match


class Op(Enum):
    EQUAL = ""
    MORE_EQUAL = ">="
    LESS_EQUAL = "<="
    NOT_EQUAL = "!"
    MORE = ">"
    LESS = "<"
    IN_RANGE = "-"
    NOT_IN_RANGE = "!-"


_NOT_IN_RANGE_RE = re.compile(r"^(\d+(\.\d+)?)([^-]*)!-(\d+(\.\d+)?)([^-]*)$")
_IN_RANGE_RE = re.compile(r"^(\d+(\.\d+)?)([^-]*)-(\d+(\.\d+)?)([^-]*)$")
_LEADING_NUMBER_RE = re.compile(r"^(\d*(\.\d+)?)(.*)", re.DOTALL)


def get_operator(pattern: str) -> Op:
    """operator.go:33 GetOperatorFromStringPattern."""
    if len(pattern) < 2:
        return Op.EQUAL
    if pattern.startswith(">="):
        return Op.MORE_EQUAL
    if pattern.startswith("<="):
        return Op.LESS_EQUAL
    if pattern.startswith(">"):
        return Op.MORE
    if pattern.startswith("<"):
        return Op.LESS
    if pattern.startswith("!"):
        return Op.NOT_EQUAL
    if _NOT_IN_RANGE_RE.match(pattern):
        return Op.NOT_IN_RANGE
    if _IN_RANGE_RE.match(pattern):
        return Op.IN_RANGE
    return Op.EQUAL


def validate_value_with_pattern(value, pattern) -> bool:
    """pattern.go:25 ValidateValueWithPattern."""
    if isinstance(pattern, bool):
        return isinstance(value, bool) and value == pattern
    if isinstance(pattern, int):
        return _validate_int(value, pattern)
    if isinstance(pattern, float):
        return _validate_float(value, pattern)
    if isinstance(pattern, str):
        return _validate_string_patterns(value, pattern)
    if pattern is None:
        return _validate_nil(value)
    if isinstance(pattern, dict):
        # existence-of-object check only, not deep equality (pattern.go:56)
        return isinstance(value, dict)
    return False  # arrays and unknown types are not valid leaf patterns


def _validate_int(value, pattern: int) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return value == pattern
    if isinstance(value, float):
        return value == int(value) and int(value) == pattern
    if isinstance(value, str):
        try:
            return int(value, 10) == pattern
        except ValueError:
            return False
    return False


def _validate_float(value, pattern: float) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, int):
        return pattern == int(pattern) and int(pattern) == value
    if isinstance(value, float):
        return value == pattern
    if isinstance(value, str):
        try:
            return float(value) == pattern
        except ValueError:
            return False
    return False


def _validate_nil(value) -> bool:
    if isinstance(value, bool):
        return not value
    if isinstance(value, float):
        return value == 0.0
    if isinstance(value, int):
        return value == 0
    if isinstance(value, str):
        return value == ""
    if value is None:
        return True
    return False


def _validate_string_patterns(value, pattern: str) -> bool:
    """OR over "|" alternatives, AND over "&" within each (pattern.go:153)."""
    for alternative in pattern.split("|"):
        alternative = alternative.strip(" ")
        if _check_and_conditions(value, alternative):
            return True
    return False


def _check_and_conditions(value, pattern: str) -> bool:
    for condition in pattern.split("&"):
        if not validate_string_pattern(value, condition.strip(" ")):
            return False
    return True


def validate_string_pattern(value, pattern: str) -> bool:
    """Single operator-prefixed pattern (pattern.go:177)."""
    op = get_operator(pattern)

    if op is Op.IN_RANGE:
        left, right = pattern.split("-")[0], pattern.split("-")[1]
        return validate_string_pattern(value, f">={left}") and validate_string_pattern(
            value, f"<={right}"
        )
    if op is Op.NOT_IN_RANGE:
        left, right = pattern.split("!-")[0], pattern.split("!-")[1]
        return validate_string_pattern(value, f"<{left}") or validate_string_pattern(
            value, f">{right}"
        )

    body = pattern[len(op.value):].strip()
    number, rest = _split_leading_number(body)
    if number == "":
        return _validate_string(value, rest, op)
    return _validate_number_with_str(value, body, op)


def _split_leading_number(pattern: str) -> tuple[str, str]:
    m = _LEADING_NUMBER_RE.match(pattern)
    return m.group(1), m.group(3)


def _validate_string(value, pattern: str, op: Op) -> bool:
    """Wildcard equality for non-numeric operands (pattern.go:210)."""
    if op not in (Op.EQUAL, Op.NOT_EQUAL):
        return False  # >, >=, <, <= are not applicable to strings
    s = value_to_string_for_equality(value)
    if s is None:
        return False
    result = wildcard_match(pattern, s)
    return (not result) if op is Op.NOT_EQUAL else result


def _validate_number_with_str(value, pattern: str, op: Op) -> bool:
    """Quantity comparison if the operand parses as one, else wildcard
    (pattern.go:263)."""
    s = convert_number_to_string(value)
    if s is None:
        return False
    try:
        pattern_q = parse_quantity(pattern)
    except QuantityError:
        return wildcard_match(pattern, s)
    try:
        value_q = parse_quantity(s)
    except QuantityError:
        return False
    if value_q < pattern_q:
        cmp = -1
    elif value_q > pattern_q:
        cmp = 1
    else:
        cmp = 0
    if op is Op.EQUAL:
        return cmp == 0
    if op is Op.NOT_EQUAL:
        return cmp != 0
    if op is Op.MORE:
        return cmp > 0
    if op is Op.LESS:
        return cmp < 0
    if op is Op.MORE_EQUAL:
        return cmp >= 0
    if op is Op.LESS_EQUAL:
        return cmp <= 0
    return False
