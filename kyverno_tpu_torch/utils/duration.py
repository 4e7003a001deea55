"""Go-style duration parsing for the Duration* condition operators.

Mirrors time.ParseDuration as used by the precondition operator handlers
(kyverno/pkg/engine/variables/operator/duration.go). Returns seconds
as a float. Also accepts bare numbers (treated as seconds), matching the
reference operator's fallback for numeric operands.
"""

from __future__ import annotations

import re

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,  # µs
    "μs": 1e-6,  # μs
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}

_PART = re.compile(r"(\d+(?:\.\d*)?|\.\d+)(ns|us|µs|μs|ms|s|m|h)")


class DurationError(ValueError):
    pass


def parse_duration(s: str) -> float:
    """Parse "1h30m", "300ms", "-1.5h" etc. into seconds."""
    if not isinstance(s, str):
        raise DurationError(f"not a string: {s!r}")
    orig = s
    s = s.strip()
    neg = False
    if s and s[0] in "+-":
        neg = s[0] == "-"
        s = s[1:]
    if s == "0":
        return 0.0
    if not s:
        raise DurationError(f"invalid duration: {orig!r}")
    total = 0.0
    pos = 0
    for m in _PART.finditer(s):
        if m.start() != pos:
            raise DurationError(f"invalid duration: {orig!r}")
        total += float(m.group(1)) * _UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise DurationError(f"invalid duration: {orig!r}")
    return -total if neg else total
