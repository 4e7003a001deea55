"""Glob (wildcard) matching of every pattern against every dictionary string.

    match[n, v] = glob(pattern_n) accepts string_v

The NFA has one state per pattern position. ``*`` states self-loop and
epsilon-advance (runs of stars are collapsed at compile time, so one
propagation step per transition suffices); ``?`` consumes any byte; a
string steps only while ``j < str_len``. A string's length is
``str_len & 0x7F``: the packed dictionary keeps flag bits above bit 7 of
the same word, and no valid length exceeds ``STR_LEN`` = 64.

:func:`glob_match_matrix` launches the CUDA kernel ``csrc/glob_nfa.cu``
for tensors on the card and runs :func:`glob_match_matrix_plain`, the
plain PyTorch version, for tensors on the CPU. The kernel steps a
shift-and automaton whose tables depend only on the policy set; they are
built once, with the plan, by :func:`nfa_tables`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build

LEN_MASK = 0x7F
# bytes a dictionary string, models/compiler.py STR_LEN (not imported:
# the models package imports ops; a test holds the two equal)
STR_LEN = 64
MAX_STATES = 64     # S + 1 NFA states are the bits of one uint64
KERNEL_PATTERNS = 16  # patterns a block of csrc/glob_nfa.cu takes (kNP)


class GlobTables(NamedTuple):
    """Per-pattern shift-and tables (uint64 bits held as int64):
    ``consume`` [N, 256], bit i of row (n, c) set where state i of
    pattern n is '?' or its literal is byte c (the padded state S has
    literal 0 and no '?'); ``star`` [N], the '*' states; ``full`` [N],
    the S + 1 live states; ``acc`` [N] int32, the accepting state
    (``nfa_len``)."""
    consume: torch.Tensor
    star: torch.Tensor
    full: torch.Tensor
    acc: torch.Tensor


def nfa_tables(nfa_char, nfa_is_star, nfa_is_q, nfa_len, device) -> GlobTables:
    """:class:`GlobTables` on ``device`` from the compiled NFA rows [N, S]
    (numpy arrays or tensors), built with numpy."""
    def arr(x, dtype):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        return np.asarray(x, dtype=dtype)

    char = arr(nfa_char, np.int64)
    q, star = arr(nfa_is_q, bool), arr(nfa_is_star, bool)
    n, s = char.shape
    if s + 1 > MAX_STATES:
        raise ValueError(f"nfa_tables: {s} NFA states exceed the kernel's "
                         f"{MAX_STATES - 1}")
    char_pad = np.zeros((n, s + 1), dtype=np.int64)
    char_pad[:, :s] = char
    q_pad = np.zeros((n, s + 1), dtype=bool)
    q_pad[:, :s] = q
    bit = np.uint64(1) << np.arange(s + 1, dtype=np.uint64)
    hit = q_pad[:, None, :] | (char_pad[:, None, :]
                               == np.arange(256)[None, :, None])
    consume = np.bitwise_or.reduce(np.where(hit, bit, np.uint64(0)), axis=2)
    star_m = np.bitwise_or.reduce(np.where(star, bit[:s], np.uint64(0)), axis=1)
    full = np.full(n, ~np.uint64(0) if s + 1 == MAX_STATES
                   else (np.uint64(1) << np.uint64(s + 1)) - np.uint64(1))

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return GlobTables(dev(consume.reshape(n, 256).view(np.int64)),
                      dev(star_m.reshape(n).view(np.int64)),
                      dev(full.view(np.int64)),
                      dev(arr(nfa_len, np.int32).reshape(n)))


def _epsilon_closure(states, star_pad):
    """Advance through '*' states without consuming input."""
    advanced = torch.zeros_like(states)
    advanced[..., 1:] = states[..., :-1] & star_pad[:, None, :-1]
    return states | advanced


def glob_match_matrix_plain(nfa_char, nfa_is_star, nfa_is_q, nfa_len,
                            str_bytes, str_len):
    """match[n, v] as a [N, V, S+1] boolean lattice stepped over the bytes.

    Args (tensors on one device):
      nfa_char:    [N, S] uint8 literal byte per state (0 for meta states)
      nfa_is_star: [N, S] bool
      nfa_is_q:    [N, S] bool
      nfa_len:     [N]    int32 pattern length (accepting state index)
      str_bytes:   [V, L] uint8 zero-padded string bytes
      str_len:     [V]    int32; ``str_len & LEN_MASK`` is the length
    Returns: [N, V] bool
    """
    n, s = nfa_char.shape
    v, L = str_bytes.shape
    dev = nfa_char.device
    lens = str_len.to(torch.int64) & LEN_MASK
    char_pad = torch.zeros((n, s + 1), dtype=torch.int64, device=dev)
    char_pad[:, :s] = nfa_char.to(torch.int64)
    star_pad = torch.zeros((n, s + 1), dtype=torch.bool, device=dev)
    star_pad[:, :s] = nfa_is_star
    q_pad = torch.zeros((n, s + 1), dtype=torch.bool, device=dev)
    q_pad[:, :s] = nfa_is_q

    states = torch.zeros((n, v, s + 1), dtype=torch.bool, device=dev)
    states[:, :, 0] = True
    states = _epsilon_closure(states, star_pad)
    sb = str_bytes.to(torch.int64)
    for j in range(L):
        c = sb[:, j]                                            # [V]
        in_range = j < lens                                     # [V]
        consume = q_pad[:, None, :] | (char_pad[:, None, :] == c[None, :, None])
        advanced = torch.zeros_like(states)
        advanced[..., 1:] = (states & consume)[..., :-1]
        stay = states & star_pad[:, None, :]
        new = _epsilon_closure(advanced | stay, star_pad)
        states = torch.where(in_range[None, :, None], new, states)
    idx = nfa_len.to(torch.int64)[:, None, None].expand(n, v, 1)
    return torch.gather(states, 2, idx)[:, :, 0]


def glob_match_matrix(nfa_char, nfa_is_star, nfa_is_q, nfa_len,
                      str_bytes, str_len, tables: GlobTables, out=None):
    """match[n, v] for every (glob pattern n, dictionary string v): the
    kernel on the card, the plain version on the CPU. ``str_len`` may be
    a strided view (the dictionary column of a packed blob). ``tables``
    is :func:`nfa_tables` of the same NFA rows, as ``Plan.glob`` holds
    them: the kernel reads them in place of the rows, after the wrapper
    checks their shapes against the rows, and takes strings of
    ``STR_LEN`` bytes. ``out``, a contiguous bool [N, V] on the same
    device, receives the matrix in place of a new tensor (a buffer that
    a CUDA graph's capture holds)."""
    dev = str_bytes.device
    n, s = nfa_char.shape
    v, L = str_bytes.shape
    if out is not None and (out.device != dev or out.dtype != torch.bool
                            or tuple(out.shape) != (n, v)
                            or not out.is_contiguous()):
        raise ValueError(f"glob_match_matrix: out must be a contiguous "
                         f"torch.bool[{n}, {v}] on {dev}, got {out.dtype}"
                         f"{list(out.shape)} on {out.device}")
    if dev.type == "cpu":
        m = glob_match_matrix_plain(nfa_char, nfa_is_star, nfa_is_q,
                                    nfa_len, str_bytes, str_len)
        return m if out is None else out.copy_(m)
    if s + 1 > MAX_STATES:
        raise ValueError(f"glob_match_matrix: {s} NFA states exceed the "
                         f"kernel's {MAX_STATES - 1}")
    if dev.type != "cuda":
        raise ValueError(f"glob_match_matrix: unsupported device {dev}")
    if L != STR_LEN or str_bytes.data_ptr() % 4:
        raise ValueError(f"glob_match_matrix: strings must be {STR_LEN} "
                         "bytes a row from a 4-byte aligned address")
    for name, t, dtype, shape in (
            ("str_bytes", str_bytes, torch.uint8, (v, L)),
            ("str_len", str_len, torch.int32, (v,)),
            ("consume", tables.consume, torch.int64, (n, 256)),
            ("star", tables.star, torch.int64, (n,)),
            ("full", tables.full, torch.int64, (n,)),
            ("acc", tables.acc, torch.int32, (n,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"glob_match_matrix: {name} must be {dtype}"
                             f"{list(shape)} on {dev}, got {t.dtype}"
                             f"{list(t.shape)} on {t.device}")
        if name != "str_len" and not t.is_contiguous():
            raise ValueError(f"glob_match_matrix: {name} must be contiguous")
    if tables.consume.data_ptr() % 16:
        raise ValueError("glob_match_matrix: consume is not 16-byte aligned")
    if out is None:
        out = torch.empty((n, v), dtype=torch.bool, device=dev)
    if n == 0 or v == 0:
        return out
    f = _build.fn("glob_nfa", "ktpu_glob_nfa", 12)
    err = f(tables.consume.data_ptr(), tables.star.data_ptr(),
            tables.full.data_ptr(), tables.acc.data_ptr(), n, s,
            str_bytes.data_ptr(), str_len.data_ptr(), str_len.stride(0), v,
            out.data_ptr(), _build.stream_handle(dev))
    _build.check("glob_nfa", err)
    _build.note_launch("glob_nfa")
    return out
