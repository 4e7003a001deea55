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
plain PyTorch version, for tensors on the CPU.
"""

from __future__ import annotations

import torch

from . import _build

LEN_MASK = 0x7F

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
                      str_bytes, str_len):
    """match[n, v] for every (glob pattern n, dictionary string v): the
    kernel on the card, the plain version on the CPU. ``str_len`` may be
    a strided view (the dictionary column of a packed blob)."""
    dev = str_bytes.device
    if dev.type == "cpu":
        return glob_match_matrix_plain(nfa_char, nfa_is_star, nfa_is_q,
                                       nfa_len, str_bytes, str_len)
    if dev.type != "cuda":
        raise ValueError(f"glob_match_matrix: unsupported device {dev}")
    n, s = nfa_char.shape
    v, L = str_bytes.shape
    if s + 1 > 64:
        raise ValueError(f"glob_match_matrix: {s} NFA states exceed the "
                         "kernel's 63")
    for name, t, dtype in (("nfa_char", nfa_char, torch.uint8),
                           ("nfa_is_star", nfa_is_star, torch.bool),
                           ("nfa_is_q", nfa_is_q, torch.bool),
                           ("nfa_len", nfa_len, torch.int32),
                           ("str_bytes", str_bytes, torch.uint8),
                           ("str_len", str_len, torch.int32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"glob_match_matrix: {name} must be {dtype} "
                             f"on {dev}, got {t.dtype} on {t.device}")
        if name != "str_len" and not t.is_contiguous():
            raise ValueError(f"glob_match_matrix: {name} must be contiguous")
    if str_len.dim() != 1 or str_len.shape[0] != v:
        raise ValueError("glob_match_matrix: str_len must be [V]")
    out = torch.empty((n, v), dtype=torch.bool, device=dev)
    if n == 0 or v == 0:
        return out
    f = _build.fn("glob_nfa", "ktpu_glob_nfa", 13)
    err = f(nfa_char.data_ptr(), nfa_is_star.data_ptr(), nfa_is_q.data_ptr(),
            nfa_len.data_ptr(), n, s, str_bytes.data_ptr(), L,
            str_len.data_ptr(), str_len.stride(0), v,
            out.data_ptr(), _build.stream_handle(dev))
    _build.check("glob_nfa", err)
    _build.LAUNCHES["glob_nfa"] += 1
    return out
