"""Kubernetes resource.Quantity parsing and comparison.

Reimplements the subset of k8s.io/apimachinery/pkg/api/resource used by the
leaf comparator (kyverno/pkg/engine/validate/pattern.go:264-309):
parse a quantity string ("100Mi", "1500m", "2", "3e2", "1.5Gi") to an exact
rational and compare. Parsing is exact (fractions.Fraction), so "0.1" and
"100m" compare equal, as they do under k8s Quantity semantics.

The tensor compiler reuses :func:`decompose` to pre-split operands into
(mantissa, exponent) lanes so the on-device comparator is pure arithmetic.
"""

from __future__ import annotations

import re
from fractions import Fraction

_BINARY = {
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
    "Pi": Fraction(2**50),
    "Ei": Fraction(2**60),
}
_DECIMAL = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 10**3),
    "": Fraction(1),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
}

# number then suffix; scientific exponent must win over the bare E/e suffix
_QUANTITY_RE = re.compile(
    r"^([+-]?)(\d+(?:\.\d*)?|\.\d+)"
    r"(Ki|Mi|Gi|Ti|Pi|Ei|[eE][+-]?\d+|[numkMGTPE])?$"
)


class QuantityError(ValueError):
    pass


def parse_quantity(s: str) -> Fraction:
    """Parse a k8s quantity string into an exact Fraction.

    Raises QuantityError on anything unparseable (the caller treats that as
    "not a quantity, fall back to wildcard string match").
    """
    if not isinstance(s, str):
        raise QuantityError(f"not a string: {s!r}")
    s = s.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise QuantityError(f"invalid quantity: {s!r}")
    sign, number, suffix = m.group(1), m.group(2), m.group(3) or ""
    if "." in number:
        whole, frac = number.split(".")
        base = Fraction(int(whole or "0")) + (
            Fraction(int(frac), 10 ** len(frac)) if frac else Fraction(0)
        )
    else:
        base = Fraction(int(number))
    if suffix in _BINARY:
        mult = _BINARY[suffix]
    elif suffix in _DECIMAL:
        mult = _DECIMAL[suffix]
    elif suffix[:1] in ("e", "E"):
        exp = int(suffix[1:])
        mult = Fraction(10) ** exp
    else:  # pragma: no cover - regex prevents this
        raise QuantityError(f"invalid suffix: {suffix!r}")
    value = base * mult
    return -value if sign == "-" else value


def compare_quantities(a: Fraction, b: Fraction) -> int:
    """Three-way compare: -1, 0, 1 (mirrors Quantity.Cmp)."""
    if a < b:
        return -1
    if a > b:
        return 1
    return 0


def is_quantity(s: str) -> bool:
    try:
        parse_quantity(s)
        return True
    except QuantityError:
        return False


def decompose(s: str) -> tuple[float, bool]:
    """(float value, ok) for the device operand lanes.

    float64 loses exactness for extreme quantities (> 2^53); acceptable for
    the accelerated tier because the CPU oracle is authoritative for ties —
    the compiler routes patterns whose operands exceed the exact-float range
    to the CPU lane.
    """
    try:
        q = parse_quantity(s)
    except QuantityError:
        return 0.0, False
    return float(q), True
