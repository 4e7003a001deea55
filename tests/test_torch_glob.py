"""K1 parity: the port's glob matrix (plain version on the CPU) equals the
JAX package's glob_match_matrix and the host wildcard matcher, on the
glob NFA suite's patterns and strings and on seeded random sets with
star runs, '?' and full 64-byte strings. The kernel's shift-and tables
(``nfa_tables``, built with the plan), stepped by numpy as the kernel
steps them, give the same matrix, also at the kernel's 63 states and for
more patterns than a block takes."""

import os
import re

import numpy as np
import pytest
import torch

from kyverno_tpu.models.compiler import STR_LEN, _compile_glob
from kyverno_tpu.ops.glob import glob_match_matrix as jax_glob
from kyverno_tpu_torch.ops import glob as tglob
from kyverno_tpu_torch.utils.wildcard import wildcard_match
from tests.ops.test_glob_nfa import PATTERNS, STRINGS
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _compile_wide(pattern: str, states: int = 63):
    """An NFA row of ``states`` states, as _compile_glob builds one of
    NFA_STATES (star runs collapsed; ASCII only)."""
    while "**" in pattern:
        pattern = pattern.replace("**", "*")
    assert len(pattern) <= states - 1 or len(pattern) == states
    char = np.zeros(states, dtype=np.uint8)
    star = np.zeros(states, dtype=bool)
    q = np.zeros(states, dtype=bool)
    for i, ch in enumerate(pattern):
        star[i], q[i] = ch == "*", ch == "?"
        if ch not in "*?":
            char[i] = ord(ch)
    return char, star, q, len(pattern)


def _tables(patterns, strings, states=None):
    rows = [_compile_glob(p) if states is None else _compile_wide(p, states)
            for p in patterns]
    assert all(r is not None for r in rows)
    nfa = (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
           np.stack([r[2] for r in rows]),
           np.array([r[3] for r in rows], dtype=np.int32))
    str_bytes = np.zeros((len(strings), STR_LEN), dtype=np.uint8)
    str_len = np.zeros(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        bs = s.encode()[:STR_LEN]
        str_bytes[i, :len(bs)] = np.frombuffer(bs, dtype=np.uint8)
        str_len[i] = len(bs)
    return nfa, str_bytes, str_len


def _random_set(seed: int):
    rng = np.random.default_rng(seed)
    alphabet = "ab:*?."
    patterns = []
    for _ in range(24):
        n = int(rng.integers(0, 20))
        patterns.append("".join(alphabet[int(i)] for i in rng.integers(0, 6, n)))
    patterns += ["*" * 5 + "a", "?" * 47, "a" * 40 + "*", "**?**"]
    strings = [""]
    for _ in range(40):
        n = int(rng.integers(0, STR_LEN + 1))
        strings.append("".join("ab:."[int(i)] for i in rng.integers(0, 4, n)))
    strings += ["a" * STR_LEN, "b" * 47, "a:b." * 16]
    return patterns, strings


def _wide_set(seed: int):
    """More patterns than a block of the kernel takes (16), with a
    63-state one (the kernel's limit: 64 states with the accepting one),
    the empty pattern, star runs and '?', over strings of 0 to 64 bytes."""
    patterns, strings = _random_set(seed)
    rng = np.random.default_rng(seed)
    for _ in range(16):
        n = int(rng.integers(20, 61))
        patterns.append("".join("ab*?"[int(i)] for i in rng.integers(0, 4, n)))
    patterns += ["", "a" * 63, "?" * 62 + "*", "*" + "ab" * 31, "*a*b*" * 12]
    strings += ["ab" * 32, "a" * 63]
    return patterns, strings


CASES = {"suite": (PATTERNS, STRINGS)}
CASES.update({f"random{s}": _random_set(s) for s in (1, 2, 3)})
WIDE_CASES = {f"wide{s}": _wide_set(s) for s in (4, 5)}


def _shift_and(tables, str_bytes, str_len):
    """The kernel's steps in numpy over the plan's tables: [N, V] bool.
    numpy's uint64 shifts drop the bit shifted out of bit 63, as the
    card's do (a 63-state pattern fills all 64 bits)."""
    consume, star, full, acc = (t.numpy() for t in tables)
    consume, star, full = (x.view(np.uint64) for x in (consume, star, full))
    one = np.uint64(1)
    star, full = star[:, None], full[:, None]
    s = np.ones((consume.shape[0], str_bytes.shape[0]), dtype=np.uint64)
    s = (s | ((s & star) << one)) & full
    lens = str_len.astype(np.int64) & tglob.LEN_MASK
    for j in range(str_bytes.shape[1]):
        nw = ((s & consume[:, str_bytes[:, j]]) << one) | (s & star)
        nw = (nw | ((nw & star) << one)) & full
        s = np.where((j < lens)[None, :], nw, s)
    S = consume.shape[0] and int(full.max()).bit_length() - 1
    ok = (acc >= 0) & (acc <= S)
    return ((s >> np.where(ok, acc, 0).astype(np.uint64)[:, None]) & one
            ).astype(bool) & ok[:, None]


@pytest.mark.parametrize("case", sorted(CASES))
def test_glob_matrix_equals_jax_and_wildcard(case):
    patterns, strings = CASES[case]
    nfa, str_bytes, str_len = _tables(patterns, strings)
    want = np.asarray(jax_glob(*nfa, str_bytes, str_len))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in nfa]
    got = tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes),
                                  torch.from_numpy(str_len),
                                  tglob.nfa_tables(*nfa, "cpu")).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    for i, p in enumerate(patterns):
        for j, s in enumerate(strings):
            if len(s.encode()) <= STR_LEN:
                assert got[i, j] == wildcard_match(p, s), (p, s)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(WIDE_CASES))
def test_shift_and_tables_equal_lattice(case):
    """The plan-built tables, stepped as the kernel steps them (numpy,
    length words with flag bits above bit 7), equal the lattice and the
    JAX package."""
    wide = case in WIDE_CASES
    patterns, strings = (WIDE_CASES if wide else CASES)[case]
    nfa, str_bytes, str_len = _tables(patterns, strings, 63 if wide else None)
    tables = tglob.nfa_tables(*nfa, "cpu")
    assert tables.consume.shape == (len(patterns), 256)
    assert tables.consume.dtype == torch.int64
    if wide:
        assert nfa[0].shape[1] + 1 == tglob.MAX_STATES
        assert len(patterns) > tglob.KERNEL_PATTERNS
        assert 0 in str_len and tglob.STR_LEN in str_len
    flagged = str_len | (1 << 7) | (1 << 9)
    got = _shift_and(tables, str_bytes, flagged)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in nfa]
    lattice = tglob.glob_match_matrix_plain(*t, torch.from_numpy(str_bytes),
                                            torch.from_numpy(flagged)).numpy()
    want = np.asarray(jax_glob(*nfa, str_bytes, str_len))
    assert np.array_equal(lattice, want)
    assert np.array_equal(got, want)


def test_kernel_constants_match_source():
    """The pattern group and state limit the wrapper states are the
    kernel's own."""
    src = open(os.path.join(os.path.dirname(tglob.__file__), "..", "csrc",
                            "glob_nfa.cu")).read()
    assert int(re.search(r"kNP = (\d+);", src).group(1)) == tglob.KERNEL_PATTERNS
    assert int(re.search(r"kWords = (\d+);", src).group(1)) * 4 == STR_LEN
    assert tglob.STR_LEN == STR_LEN


def test_len_mask_reads_packed_dictionary_column():
    """The blob path passes dictv[:, 4] (length | flag bits above 7); the
    length mask drops the flags, so the result equals the plain-length
    call."""
    nfa, str_bytes, str_len = _tables(PATTERNS, STRINGS)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in nfa]
    packed = torch.from_numpy(str_len | (1 << 7) | (1 << 9))
    tables = tglob.nfa_tables(*nfa, "cpu")
    a = tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes),
                                torch.from_numpy(str_len), tables)
    b = tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes), packed,
                                tables)
    assert torch.equal(a, b)


def test_wrapper_refuses_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: on another
    device, and for patterns of 64 states and more (nfa_tables
    refuses them too)."""
    nfa, str_bytes, str_len = _tables(["*"], ["a"])
    t = [torch.from_numpy(np.ascontiguousarray(a)).to("meta") for a in nfa]
    tables = tglob.nfa_tables(*nfa, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes).to("meta"),
                                torch.from_numpy(str_len).to("meta"), tables)
    nfa, str_bytes, str_len = _tables(["a*b"], ["ab"], 64)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to("meta") for a in nfa]
    with pytest.raises(ValueError, match="64 NFA states exceed"):
        tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes).to("meta"),
                                torch.from_numpy(str_len).to("meta"), tables)
    with pytest.raises(ValueError, match="64 NFA states exceed"):
        tglob.nfa_tables(*nfa, "cpu")
