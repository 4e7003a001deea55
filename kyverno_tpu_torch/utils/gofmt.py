"""Number<->string conversions matching the reference engine's Go formatting.

The leaf comparator stringifies resource values before wildcard/quantity
comparison; byte-identical formatting matters for conformance (e.g. a float
2.5 must become "2.500000" on the quantity path and "2.5E+00" on the string
equality path, as in kyverno/pkg/engine/validate/pattern.go:219,265
and validate/common.go:9).
"""

from __future__ import annotations


def format_float_fixed(v: float) -> str:
    """Go fmt.Sprintf("%f", v): fixed-point, 6 decimals."""
    return f"{v:f}"


def format_float_sci(v: float) -> str:
    """Go strconv.FormatFloat(v, 'E', -1, 64): shortest round-trip mantissa,
    capital E, >=2-digit exponent."""
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    mant, _, exp = f"{v:E}".partition("E")
    # shortest round-trip: use repr() which is shortest, then re-derive
    shortest = repr(float(v))
    if "e" in shortest or "E" in shortest:
        m, _, e = shortest.lower().partition("e")
        mant = m
        iexp = int(e)
    else:
        neg = shortest.startswith("-")
        digits = shortest.lstrip("-")
        int_part, _, frac_part = digits.partition(".")
        frac_part = frac_part.rstrip("0") if frac_part != "0" else ""
        if int_part == "0":
            # 0.00123 -> 1.23E-03
            stripped = frac_part.lstrip("0")
            if not stripped:
                return "-0E+00" if neg else "0E+00"
            iexp = -(len(frac_part) - len(stripped) + 1)
            mant_digits = stripped
        else:
            iexp = len(int_part) - 1
            mant_digits = (int_part + frac_part).rstrip("0") or "0"
        mant = mant_digits[0] + ("." + mant_digits[1:] if len(mant_digits) > 1 else "")
        if neg:
            mant = "-" + mant
    sign = "+" if iexp >= 0 else "-"
    return f"{mant}E{sign}{abs(iexp):02d}"


def convert_number_to_string(value) -> str | None:
    """validate/common.go:9 convertNumberToString; None return => not convertible."""
    if value is None:
        return "0"
    if isinstance(value, bool):
        return None
    if isinstance(value, str):
        return value
    if isinstance(value, float):
        return format_float_fixed(value)
    if isinstance(value, int):
        return str(value)
    return None


def value_to_string_for_equality(value) -> str | None:
    """pattern.go:210-232 validateString value stringification; None => fail."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):
        return format_float_sci(value)
    if isinstance(value, int):
        return str(value)
    if isinstance(value, str):
        return value
    return None
