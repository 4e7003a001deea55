"""K1 parity: the port's glob matrix (plain version on the CPU) equals the
JAX package's glob_match_matrix and the host wildcard matcher, on the
glob NFA suite's patterns and strings and on seeded random sets with
star runs, '?' and full 64-byte strings."""

import numpy as np
import pytest
import torch

from kyverno_tpu.models.compiler import STR_LEN, _compile_glob
from kyverno_tpu.ops.glob import glob_match_matrix as jax_glob
from kyverno_tpu_torch.ops import glob as tglob
from kyverno_tpu_torch.utils.wildcard import wildcard_match
from tests.ops.test_glob_nfa import PATTERNS, STRINGS


def _tables(patterns, strings):
    rows = [_compile_glob(p) for p in patterns]
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


CASES = {"suite": (PATTERNS, STRINGS)}
CASES.update({f"random{s}": _random_set(s) for s in (1, 2, 3)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_glob_matrix_equals_jax_and_wildcard(case):
    patterns, strings = CASES[case]
    nfa, str_bytes, str_len = _tables(patterns, strings)
    want = np.asarray(jax_glob(*nfa, str_bytes, str_len))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in nfa]
    got = tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes),
                                  torch.from_numpy(str_len)).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    for i, p in enumerate(patterns):
        for j, s in enumerate(strings):
            if len(s.encode()) <= STR_LEN:
                assert got[i, j] == wildcard_match(p, s), (p, s)


def test_len_mask_reads_packed_dictionary_column():
    """The blob path passes dictv[:, 4] (length | flag bits above 7); the
    length mask drops the flags, so the result equals the plain-length
    call."""
    nfa, str_bytes, str_len = _tables(PATTERNS, STRINGS)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in nfa]
    packed = torch.from_numpy(str_len | (1 << 7) | (1 << 9))
    a = tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes),
                                torch.from_numpy(str_len))
    b = tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes), packed)
    assert torch.equal(a, b)


def test_wrapper_refuses_other_devices():
    nfa, str_bytes, str_len = _tables(["*"], ["a"])
    t = [torch.from_numpy(np.ascontiguousarray(a)).to("meta") for a in nfa]
    with pytest.raises(ValueError, match="unsupported device"):
        tglob.glob_match_matrix(*t, torch.from_numpy(str_bytes).to("meta"),
                                torch.from_numpy(str_len).to("meta"))
