"""Glob wildcard matching: ``*`` (any run, incl. empty) and ``?`` (one char).

Semantics match the matcher used throughout the reference engine
(minio wildcard.Match, used from kyverno/pkg/engine/validate/pattern.go:241
and the match/exclude filters). No character classes, no escapes.

This is the host-side scalar twin of the batched glob NFA kernel in
``ops/glob.py`` — both must agree on every (pattern, text) pair.
"""

from __future__ import annotations


def wildcard_match(pattern: str, text: str) -> bool:
    """Return True iff ``text`` matches glob ``pattern``.

    Two-pointer with star backtracking: O(len(p) * len(t)) worst case,
    O(len(t)) typical.
    """
    p, s = pattern, text
    pi = si = 0
    star = -1
    star_si = 0
    np_, ns = len(p), len(s)
    while si < ns:
        if pi < np_ and (p[pi] == "?" or p[pi] == s[si]):
            pi += 1
            si += 1
        elif pi < np_ and p[pi] == "*":
            star = pi
            star_si = si
            pi += 1
        elif star != -1:
            pi = star + 1
            star_si += 1
            si = star_si
        else:
            return False
    while pi < np_ and p[pi] == "*":
        pi += 1
    return pi == np_


def has_wildcards(s: str) -> bool:
    """True if the string contains glob metacharacters (wildcards.go:36)."""
    return "*" in s or "?" in s
