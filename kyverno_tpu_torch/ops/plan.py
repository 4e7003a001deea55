"""The device plan: a compiled policy set's static tensors, turned once
into what the kernels and their plain versions read.

``Plan.buf`` is one int32 buffer for the CUDA kernel ``eval_rules``. The
rules are cut into tiles of consecutive rules, each small enough for one
block to stage in shared memory. The buffer holds a header, a tile table
(each tile's rule, check-row, aux-row, gate and condition-slot ranges,
and where its section lies) and one section per tile. A section is
self-contained, with tile-local ids: the check and aux tables column-major
(one contiguous int32 column per field, so neighbouring rows' fields lie
at neighbouring addresses), the global ids of the paths it reads, and the
CSR lists that replace the segment scatters of the TPU program: gate ->
groups -> rows, aux group -> aux rows, and per rule one flat list of its
pattern entries (rows in alternative and group order, with end marks) and
one of its aux groups (in filter order, with end marks). Its layout is
``csrc/plan.cuh``.

A tile is one range of check rows and one of aux rows only because the
compiler emits every row, group, alternative, gate and filter in rule
order; `Plan` checks that and refuses anything else. A section keeps each
distinct check and aux row of its tile once (:func:`_section`). A block holds its
tile's section and, beside it, the slots it decodes (per path, element
and resource) and its flags: tiles are cut so that all of it fits in a
block's shared memory at 8 resources a block with the flattener's 16
slots a path, and at one resource with the kernel's cap of 32
(:func:`tile_bytes`).

``Plan.glob`` holds K1's shift-and tables (``ops/glob.py``
:func:`nfa_tables`), built once here: they depend only on the policy
set.

``Plan.cols`` holds the same static columns as separate tensors, in the
form the plain PyTorch versions use: segment ids, as the JAX program
closed over them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.compiler import PolicyTensors
from ..models.ir import AUX_DENY, AUX_EXCLUDE, AUX_MATCH, SEP
from .glob import nfa_tables

# ---- csrc/plan.cuh: global header
(H_C, H_X, H_R, H_KMAX, H_NTILES, H_TILES, H_NHEADER) = range(7)

# ---- csrc/plan.cuh: tile table, [NTILES, TT_NCOLS] int32 (global ids)
(TT_R0, TT_R1, TT_C0, TT_C1, TT_X0, TT_X1, TT_GATE0, TT_GATE1, TT_SLOT0,
 TT_SLOT1, TT_NPATH, TT_OFF, TT_WORDS, TT_NCHK, TT_NAUX, TT_NCOLS) = range(16)

# ---- csrc/plan.cuh: tile section header: counts, then the offsets (in
# words from the section's start) of its arrays, which follow in this order
(TS_C, TS_X, TS_R, TS_NGATES, TS_NPATH, TS_CHK, TS_AUX, TS_PATHS,
 TS_GATE_PTR, TS_GATE_GRP, TS_GRP_PTR, TS_GRP_ROW, TS_PAT_PTR, TS_PAT,
 TS_RULE_FLAGS, TS_RULE_KINDS, TS_AUXP_PTR, TS_AUXP, TS_AXG_PTR, TS_AXG_ROW,
 TS_AXG_INFO, TS_NHEADER) = range(22)

# ---- csrc/plan.cuh: a rule's pattern entries (PAT), in alternative then
# group order: (local check row << PE_SHIFT) | bits. The last row of a
# group carries PE_GROUP_END, the last entry of an alternative PE_ALT_END
# (and PE_MULTI if the rule has several); an alternative with no rows is
# one PE_NOROW entry. Groups with no rows add nothing and have no entry.
PE_PLAIN, PE_COND, PE_TRACKED, PE_GROUP_END = 1, 2, 4, 8
PE_ALT_END, PE_MULTI, PE_NOROW, PE_SHIFT = 16, 32, 64, 8
# ---- csrc/plan.cuh: a rule's aux-group entries (AUXP): (local aux group
# << AE_SHIFT) | bits, each group of the rule once, those of its filters
# first, filter by filter; the last group of a filter carries AE_FILT_END
# (and AE_FILT_EX for an exclude filter); a filter with no groups is one
# AE_NOGROUP entry.
AE_FILTER, AE_FILT_END, AE_FILT_EX, AE_NOGROUP, AE_SHIFT = 1, 2, 4, 8, 8

# Sections start and end on 16 bytes, as the bulk copy into shared memory
# needs.
SECTION_ALIGN = 4
# Words a tile's section may hold where more than one rule shares it: 96 KB
# of a block's shared memory, so that at least two blocks fit on an SM. A
# tile of one rule may take more, within SMEM_BYTES.
TILE_WORDS = 24 * 1024
# Dynamic shared memory a block of eval_rules may take: the H100's 227 KB
# less 1 KB for the kernel's static shared memory.
SMEM_BYTES = 227 * 1024 - 1024
# Slots per path: the flattener's cap (models/flatten.py flatten_batch
# max_slots), at which every tile fits 8 resources a block, and the
# kernel's (per-element bits travel as one 32-bit word), at which it fits
# one.
FLAT_SLOTS, MAX_SLOTS = 16, 32
FLAT_TB = 8
# Resources of eval_rules' largest group (csrc/eval_rules.cu: kMaxK words
# of kMaxTB resources a mask)
MAX_GROUP = 128

# ---- csrc/plan.cuh: a block's shared memory (layout(); tile_bytes)
(SM_SLOT_LANES, SM_CHECK_MASKS, SM_AUX_MASKS, SM_COND_WORDS,
 SM_RULE_MASKS, SM_ALIGN) = 7, 4, 3, 3, 1, 16

# ---- csrc/plan.cuh: check table columns (column-major in a section)
(CK_PATH, CK_OP, CK_PLEN, CK_GUARD, CK_NFA, CK_HAS_NFA, CK_LO_H, CK_LO_L,
 CK_HI_H, CK_HI_L, CK_BOOL, CK_NUMFB, CK_NUMMODE, CK_GATE, CK_IS_GATE,
 CK_IS_COND, CK_EXIST, CK_TRACK, CK_COND_DEPTH, CK_COND_SLOT,
 CK_NCOLS) = range(21)

# ---- csrc/plan.cuh: aux table columns (column-major in a section)
(AX_PATH, AX_HAS_PATH, AX_PLEN, AX_OP, AX_KIND, AX_NFA, AX_HAS_NFA,
 AX_ABSENT, AX_ERR, AX_ALLOW_NUM, AX_KEY_PAT, AX_OBOOL, AX_IS_OBOOL,
 AX_IS_OSTR, AX_IS_ONUM, AX_IS_ODUR, AX_IS_OFLOAT, AX_IS_OINT, AX_IS_OQUANT,
 AX_Q_H, AX_Q_L, AX_S_H, AX_S_L, AX_IS_MK, AX_IS_DENY, AX_NEGATED,
 AX_NCOLS) = range(27)

# ---- csrc/plan.cuh: rule flag bits and aux-group info bits
RF_COVERED, RF_HOST, RF_DENY, RF_DENY_ANY, RF_PRECOND_ANY = 1, 2, 4, 8, 16
RF_MATCH_ANY, RF_HAS_MATCH, RF_HAS_EXCLUDE, RF_EXCLUDE_ALL = 32, 64, 128, 256
RF_ALL_KINDS = 512
AG_NEGATE, AG_ANY, AG_KLASS_SHIFT = 1, 2, 4

# ---- csrc/plan.cuh: per-(b, c) check flags and per-(b, x) aux flags
CF_OK, CF_MISSING, CF_UNC, CF_STRUCT = 1, 2, 4, 8
XF_ROW, XF_UNC, XF_ERR = 1, 2, 4


def _limbs(n: np.ndarray):
    """Split i64 micro-units into (hi, lo) int32 limbs; lexicographic
    compare of (hi, lo) equals i64 compare (lo is non-negative)."""
    n = np.asarray(n, dtype=np.int64)
    return ((n >> 31).astype(np.int32), (n & 0x7FFFFFFF).astype(np.int32))


def tile_bytes(words: int, paths: int, checks: int, aux: int, rules: int,
               gates: int, cond: int, E: int, tb: int) -> int:
    """Dynamic shared memory of a block over a tile of these sizes (its
    distinct check and aux rows) at E slots a path, for a group of ``tb``
    resources (a mask holds 32 of them: above 32, each mask is tb / 32
    words): ``layout()`` of csrc/plan.cuh, term by term."""
    def a(n):
        return -(-n // SM_ALIGN) * SM_ALIGN

    if not 1 <= tb <= MAX_GROUP:
        raise ValueError(f"tile_bytes: a group of {tb} resources, not 1 to "
                         f"{MAX_GROUP}")
    w = -(-tb // 32)
    return (a(4 * words) + a(4 * SM_SLOT_LANES * paths * E * tb) + a(4 * tb)
            + a(4 * gates * tb) + a(4 * SM_COND_WORDS * cond * E * w)
            + a(4 * SM_CHECK_MASKS * checks * w) + a(4 * SM_AUX_MASKS * aux * w)
            + a(4 * SM_RULE_MASKS * rules * w))


def _row_dims(row) -> tuple[int, ...]:
    """A tile-table row's sizes, in tile_bytes' order (tile_dims() of
    csrc/plan.cuh)."""
    return (int(row[TT_WORDS]), int(row[TT_NPATH]),
            int(row[TT_NCHK]), int(row[TT_NAUX]),
            int(row[TT_R1] - row[TT_R0]), int(row[TT_GATE1] - row[TT_GATE0]),
            int(row[TT_SLOT1] - row[TT_SLOT0]))


def _csr(seg: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(ptr [n+1], items): items of segment s are items[ptr[s]:ptr[s+1]],
    in increasing id order. Ids whose segment is outside [0, n) drop."""
    seg = np.asarray(seg, dtype=np.int64)
    ids = np.nonzero((seg >= 0) & (seg < n))[0]
    order = ids[np.argsort(seg[ids], kind="stable")]
    counts = np.bincount(seg[ids], minlength=n) if n else np.zeros(0, np.int64)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return ptr, order.astype(np.int32)


class Plan:
    """Static device state of one compiled policy set (see module doc)."""

    def __init__(self, tensors: PolicyTensors, device,
                 tile_words: int = TILE_WORDS, smem_bytes: int = SMEM_BYTES):
        t = tensors
        self.device = torch.device(device)
        C = int(t.chk_op.size)
        X = int(t.ax_op.size)
        G, A, R = int(t.n_groups), int(t.n_alts), int(t.n_rules)
        NG = int(t.n_gates)
        GX, FX = int(t.n_aux_groups), int(t.n_aux_filters)
        self.C, self.X, self.G, self.A, self.R = C, X, G, A, R
        self.n_gates, self.GX, self.FX = NG, GX, FX
        _check_segments(t)

        path_len = np.array([len(p.split(SEP)) for p in t.paths], dtype=np.int32)
        # the kernels read slot 0 of path max(ax_path, 0) even for constant
        # aux rows, so every batch needs at least one path
        self.min_paths = 1 + int(max(np.max(t.chk_path, initial=0),
                                     np.max(t.ax_path, initial=0)))
        is_gate = np.asarray(t.chk_is_gate_row, dtype=bool)
        is_cond = np.asarray(t.chk_is_cond, dtype=bool)
        cond_rows = np.nonzero(is_cond)[0].astype(np.int64)
        cond_slot = np.full(C, -1, dtype=np.int32)
        cond_slot[cond_rows] = np.arange(cond_rows.size, dtype=np.int32)
        self.NCOND = int(cond_rows.size)

        n_groups = max(G, 1)
        n_gates = max(NG, 1)
        group_gate = np.full(n_groups, -1, dtype=np.int32)
        group_gate[t.chk_group_gid[is_gate]] = t.chk_gate[is_gate]
        cond_group = np.zeros(n_groups, dtype=bool)
        cond_group[t.chk_group_gid[is_cond]] = True
        has_plain = np.zeros(n_groups, dtype=bool)
        has_plain[t.chk_group_gid[~(is_gate | is_cond)]] = True
        covered = np.zeros(max(R, 1), dtype=bool)
        covered[t.alt_rule] = True
        alt_is_multi = (np.bincount(t.alt_rule, minlength=R)[t.alt_rule] > 1
                        if A else np.zeros(0, dtype=bool))

        lo_h, lo_l = _limbs(t.chk_num_lo)
        hi_h, hi_l = _limbs(t.chk_num_hi)
        chk = np.zeros((C, CK_NCOLS), dtype=np.int32)
        chk[:, CK_PATH] = t.chk_path
        chk[:, CK_OP] = t.chk_op
        chk[:, CK_PLEN] = path_len[t.chk_path] if C else 0
        chk[:, CK_GUARD] = t.chk_guard
        chk[:, CK_NFA] = np.maximum(t.chk_nfa, 0)
        chk[:, CK_HAS_NFA] = t.chk_nfa >= 0
        chk[:, CK_LO_H], chk[:, CK_LO_L] = lo_h, lo_l
        chk[:, CK_HI_H], chk[:, CK_HI_L] = hi_h, hi_l
        chk[:, CK_BOOL] = t.chk_bool
        chk[:, CK_NUMFB] = t.chk_num_fallback
        chk[:, CK_NUMMODE] = t.chk_num_mode
        chk[:, CK_GATE] = t.chk_gate
        chk[:, CK_IS_GATE] = is_gate
        chk[:, CK_IS_COND] = is_cond
        chk[:, CK_EXIST] = t.chk_existence
        chk[:, CK_TRACK] = t.chk_track_depth
        chk[:, CK_COND_DEPTH] = t.chk_cond_depth
        chk[:, CK_COND_SLOT] = cond_slot

        axg_klass = np.asarray(t.axg_klass, dtype=np.int32)
        ax_klass = axg_klass[t.ax_group] if X else np.zeros(0, np.int32)
        q_h, q_l = np.asarray(t.ax_q_hi, np.int32), np.asarray(t.ax_q_lo, np.int32)
        s_h, s_l = np.asarray(t.ax_s_hi, np.int32), np.asarray(t.ax_s_lo, np.int32)
        aux = np.zeros((X, AX_NCOLS), dtype=np.int32)
        aux[:, AX_PATH] = np.maximum(t.ax_path, 0)
        aux[:, AX_HAS_PATH] = t.ax_path >= 0
        aux[:, AX_PLEN] = t.ax_plen
        aux[:, AX_OP] = t.ax_op
        aux[:, AX_KIND] = t.ax_kind_req
        aux[:, AX_NFA] = np.maximum(t.ax_nfa, 0)
        aux[:, AX_HAS_NFA] = t.ax_nfa >= 0
        aux[:, AX_ABSENT] = t.ax_absent
        aux[:, AX_ERR] = t.ax_err_absent
        aux[:, AX_ALLOW_NUM] = t.ax_allow_num
        aux[:, AX_KEY_PAT] = t.ax_key_pat
        aux[:, AX_OBOOL] = t.ax_obool
        aux[:, AX_IS_OBOOL] = t.ax_is_obool
        aux[:, AX_IS_OSTR] = t.ax_is_ostr
        aux[:, AX_IS_ONUM] = t.ax_is_onum
        aux[:, AX_IS_ODUR] = t.ax_is_odur
        aux[:, AX_IS_OFLOAT] = t.ax_is_ofloat
        aux[:, AX_IS_OINT] = t.ax_is_oint
        aux[:, AX_IS_OQUANT] = t.ax_is_oquant
        aux[:, AX_Q_H], aux[:, AX_Q_L] = q_h, q_l
        aux[:, AX_S_H], aux[:, AX_S_L] = s_h, s_l
        aux[:, AX_IS_MK] = (ax_klass == AUX_MATCH) | (ax_klass == AUX_EXCLUDE)
        aux[:, AX_IS_DENY] = ax_klass == AUX_DENY
        aux[:, AX_NEGATED] = (np.asarray(t.axg_negate)[t.ax_group]
                              if X else np.zeros(0, bool))

        flags = np.zeros(R, dtype=np.int32)
        for bit, arr in ((RF_COVERED, covered[:R]), (RF_HOST, t.rule_host_only),
                         (RF_DENY, t.rule_is_deny), (RF_DENY_ANY, t.rule_deny_any),
                         (RF_PRECOND_ANY, t.rule_precond_any),
                         (RF_MATCH_ANY, t.rule_match_any),
                         (RF_HAS_MATCH, t.rule_has_match),
                         (RF_HAS_EXCLUDE, t.rule_has_exclude),
                         (RF_EXCLUDE_ALL, t.rule_exclude_all),
                         (RF_ALL_KINDS, t.rule_match_all_kinds)):
            flags |= np.where(np.asarray(arr[:R], dtype=bool), bit, 0).astype(np.int32)
        kinds = np.asarray(t.rule_kind_ids, dtype=np.int32)
        kmax = int(kinds.shape[1])

        axg_info = (np.asarray(t.axg_negate, np.int32) * AG_NEGATE
                    | np.asarray(t.axg_any, np.int32) * AG_ANY
                    | (axg_klass << AG_KLASS_SHIFT)).astype(np.int32)

        rows = dict(
            chk=chk, aux=aux, cond_slot=cond_slot,
            group_gate=group_gate[:G].astype(np.int64),
            alt_is_multi=np.asarray(alt_is_multi, np.int32), flags=flags,
            kinds=kinds, axg_info=axg_info,
            filt_ex=np.asarray(t.axf_is_exclude, np.int32))
        self.buf_np, self.tiles, self.row_maps = _tiled_buffer(
            t, rows, tile_words, smem_bytes)
        self.buf_np[[H_C, H_X, H_R, H_KMAX]] = [C, X, R, kmax]
        self.buf = torch.from_numpy(self.buf_np).to(self.device)
        self.n_tiles = len(self.tiles)
        # the tile table in host memory, from which a launch sizes its
        # blocks' shared memory
        self.tile_table = self.buf_np[H_NHEADER:H_NHEADER + self.n_tiles
                                      * TT_NCOLS].reshape(self.n_tiles, TT_NCOLS)
        self.tile_ptr = self.tile_table.ctypes.data

        def dt(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a)).to(dtype=dtype, device=self.device)

        b = torch.bool
        self.nfa_char = dt(t.nfa_char, torch.uint8).contiguous()
        self.nfa_is_star = dt(t.nfa_is_star, b).contiguous()
        self.nfa_is_q = dt(t.nfa_is_q, b).contiguous()
        self.nfa_len = dt(t.nfa_len, torch.int32).contiguous()
        # K1's shift-and tables, built once beside the plan buffer
        self.glob = nfa_tables(t.nfa_char, t.nfa_is_star, t.nfa_is_q,
                               t.nfa_len, self.device)

        # columns for the plain versions (segment-id form, as in JAX)
        self.cols = dict(
            c_path=dt(t.chk_path), c_op=dt(t.chk_op), c_plen=dt(chk[:, CK_PLEN]),
            c_guard=dt(t.chk_guard.astype(np.int64)), c_nfa=dt(np.maximum(t.chk_nfa, 0)),
            c_has_nfa=dt(t.chk_nfa >= 0, b), c_lo_h=dt(lo_h), c_lo_l=dt(lo_l),
            c_hi_h=dt(hi_h), c_hi_l=dt(hi_l), c_bool=dt(t.chk_bool, b),
            c_numfb=dt(t.chk_num_fallback, b), c_nummode=dt(t.chk_num_mode),
            c_gate=dt(t.chk_gate), c_is_gate=dt(is_gate, b), c_is_cond=dt(is_cond, b),
            c_exist=dt(t.chk_existence, b), c_track=dt(t.chk_track_depth),
            c_alt=dt(t.chk_alt_gid), c_group=dt(t.chk_group_gid),
            c_cond_depth=dt(t.chk_cond_depth), c_rule=dt(t.chk_rule),
            cond_rows=dt(cond_rows),
            group_alt=dt(t.group_alt), alt_rule=dt(t.alt_rule),
            alt_is_multi=dt(alt_is_multi, b),
            group_is_gate=dt(group_gate >= 0, b),
            group_gate_seg=dt(np.where(group_gate >= 0, group_gate, n_gates)),
            cond_group=dt(cond_group, b), has_plain=dt(has_plain, b),
            covered=dt(covered, b),
            rule_kind_ids=dt(kinds), rule_all_kinds=dt(t.rule_match_all_kinds, b),
            rule_host=dt(t.rule_host_only, b), rule_deny=dt(t.rule_is_deny, b),
            rule_deny_any=dt(t.rule_deny_any, b),
            rule_precond_any=dt(t.rule_precond_any, b),
            rule_match_any=dt(t.rule_match_any, b),
            rule_has_match=dt(t.rule_has_match, b),
            rule_has_exclude=dt(t.rule_has_exclude, b),
            rule_exclude_all=dt(t.rule_exclude_all, b),
            x_path=dt(np.maximum(t.ax_path, 0)), x_has_path=dt(t.ax_path >= 0, b),
            x_plen=dt(t.ax_plen), x_op=dt(t.ax_op), x_rule=dt(t.ax_rule),
            x_group=dt(t.ax_group), x_kind=dt(t.ax_kind_req),
            x_nfa=dt(np.maximum(t.ax_nfa, 0)), x_has_nfa=dt(t.ax_nfa >= 0, b),
            x_absent=dt(t.ax_absent, b), x_err=dt(t.ax_err_absent, b),
            x_allow_num=dt(t.ax_allow_num, b), x_key_pat=dt(t.ax_key_pat, b),
            x_obool=dt(t.ax_obool, b), x_o_bool=dt(t.ax_is_obool, b),
            x_o_str=dt(t.ax_is_ostr, b), x_o_num=dt(t.ax_is_onum, b),
            x_o_dur=dt(t.ax_is_odur, b), x_o_float=dt(t.ax_is_ofloat, b),
            x_o_int=dt(t.ax_is_oint, b), x_o_quant=dt(t.ax_is_oquant, b),
            x_q_h=dt(q_h), x_q_l=dt(q_l), x_s_h=dt(s_h), x_s_l=dt(s_l),
            x_is_match_klass=dt(aux[:, AX_IS_MK], b),
            x_deny_row=dt(aux[:, AX_IS_DENY], b),
            axg_negate=dt(t.axg_negate, b), axg_klass=dt(axg_klass),
            axg_rule=dt(t.axg_rule), axg_any=dt(t.axg_any, b),
            axg_filt=dt(t.axg_filt), axf_rule=dt(t.axf_rule),
            axf_is_ex=dt(t.axf_is_exclude, b),
        )

    def smem_bytes(self, E: int, tb: int) -> int:
        """The dynamic shared memory a launch at E slots and groups of
        ``tb`` resources asks for: its largest tile's."""
        return max((tile_bytes(*_row_dims(row), E, tb) for row in self.tile_table),
                   default=0)


def _check_segments(t: PolicyTensors) -> None:
    """The CSR walks reach a rule's rows through its alternatives and
    groups, and its aux rows through its aux groups. That equals the JAX
    program's reductions by chk_rule / ax_rule only when the segment maps
    nest; the compiler builds them so, and a plan refuses anything else."""
    if t.chk_op.size:
        if not np.array_equal(t.group_alt[t.chk_group_gid], t.chk_alt_gid):
            raise ValueError("plan: chk_alt_gid disagrees with group_alt")
        if not np.array_equal(t.alt_rule[t.chk_alt_gid], t.chk_rule):
            raise ValueError("plan: chk_rule disagrees with alt_rule")
    if t.ax_op.size and not np.array_equal(t.axg_rule[t.ax_group], t.ax_rule):
        raise ValueError("plan: ax_rule disagrees with axg_rule")
    filt = np.asarray(t.axg_filt)
    has = filt >= 0
    if has.any() and not np.array_equal(t.axf_rule[filt[has]], t.axg_rule[has]):
        raise ValueError("plan: axf_rule disagrees with axg_rule")


def _check_order(t: PolicyTensors, gate_rule: np.ndarray) -> None:
    """A rule tile reaches one range of each kind of row only if the
    compiler emitted them in rule order, as it does: refuse anything
    else."""
    group_rule = t.alt_rule[t.group_alt] if t.group_alt.size else t.group_alt
    for name, arr in (("chk_rule", t.chk_rule), ("ax_rule", t.ax_rule),
                      ("alt_rule", t.alt_rule), ("group rule", group_rule),
                      ("axg_rule", t.axg_rule), ("axf_rule", t.axf_rule),
                      ("gate rule", gate_rule[gate_rule >= 0])):
        if np.any(np.diff(np.asarray(arr, dtype=np.int64)) < 0):
            raise ValueError(f"plan: {name} is not in rule order")


def _gate_rules(t: PolicyTensors) -> np.ndarray:
    """The rule of each gate: that of every check row naming it. A gate
    no row names takes the rule before it, so the ids stay in order."""
    gate_rule = np.full(int(t.n_gates), -1, dtype=np.int64)
    has = t.chk_gate >= 0
    gate_rule[t.chk_gate[has]] = t.chk_rule[has]
    if not np.array_equal(gate_rule[t.chk_gate[has]], t.chk_rule[has]):
        raise ValueError("plan: a gate's rows belong to more than one rule")
    return gate_rule


def _local(ids, lo: int, hi: int, what: str) -> np.ndarray:
    """Global ids -> ids local to [lo, hi); -1 (none) stays -1. Raises if
    an id lies outside the tile."""
    ids = np.asarray(ids, dtype=np.int64)
    if np.any((ids >= 0) & ((ids < lo) | (ids >= hi))):
        raise ValueError(f"plan: {what} leaves its rule's tile")
    return np.where(ids >= 0, ids - lo, -1).astype(np.int32)


def _per_rule(rule_of, R: int) -> np.ndarray:
    """How many of the items (by their rule; -1 none) each rule has."""
    rule_of = np.asarray(rule_of, dtype=np.int64)
    return np.bincount(rule_of[rule_of >= 0], minlength=R)[:R]


def _rule_words(t: PolicyTensors, gate_rule: np.ndarray, kmax: int) -> np.ndarray:
    """An upper bound on the section words each rule adds to its tile."""
    R = int(t.n_rules)

    def per_rule(rule_of):
        return _per_rule(rule_of, R)

    group_rule = t.alt_rule[t.group_alt] if t.group_alt.size else t.group_alt
    # check row: columns, group row, pattern entry, path; aux row: columns,
    # group row, path; alternative: a no-row entry; group: pointer, gate
    # group; aux group: pointer, info, entry; filter: a no-group entry;
    # rule: two pointers, flags, kinds
    return (per_rule(t.chk_rule) * (CK_NCOLS + 3)
            + per_rule(t.ax_rule) * (AX_NCOLS + 2)
            + per_rule(t.alt_rule) + per_rule(group_rule) * 2
            + per_rule(gate_rule) + per_rule(t.axg_rule) * 3
            + per_rule(t.axf_rule) + 3 + kmax)


def _cut_tiles(t: PolicyTensors, gate_fill: np.ndarray, kmax: int,
               tile_words: int, smem_bytes: int) -> list[tuple[int, int]]:
    """Rule ranges of the tiles. A tile takes consecutive rules while its
    section stays within ``tile_words`` and a block over it fits
    ``smem_bytes`` at FLAT_SLOTS slots and FLAT_TB resources; a rule that
    does not fit so beside others takes a tile alone. Every tile fits at
    MAX_SLOTS slots and one resource, or the plan is refused."""
    R = int(t.n_rules)
    # words (a bound), checks, aux, rules, gates, condition slots
    adds = np.stack([_rule_words(t, gate_fill, kmax), _per_rule(t.chk_rule, R),
                     _per_rule(t.ax_rule, R), np.ones(R, np.int64),
                     _per_rule(gate_fill, R),
                     _per_rule(t.chk_rule[np.asarray(t.chk_is_cond, bool)], R)], 1)
    fixed = np.array([TS_NHEADER + 5 + SECTION_ALIGN - 1, 0, 0, 0, 0, 0])
    # the paths each rule reads (an aux row without one reads path 0)
    rule_of = np.concatenate([t.chk_rule, t.ax_rule]).astype(np.int64)
    path_of = np.concatenate([t.chk_path, np.maximum(t.ax_path, 0)])
    order = np.argsort(rule_of, kind="stable")
    cuts = np.searchsorted(rule_of[order], np.arange(R + 1))
    paths_of = [set(path_of[order[cuts[r]:cuts[r + 1]]].tolist())
                for r in range(R)]

    def need(d, paths, E, tb):
        w, c, x, r, g, q = (int(v) for v in d)
        return tile_bytes(w, len(paths), c, x, r, g, q, E, tb)

    tiles, r0 = [], 0
    dims, paths = fixed, set()
    for r in range(R):
        if r > r0:
            d, p = dims + adds[r], paths | paths_of[r]
            if (d[0] <= tile_words and need(d, p, FLAT_SLOTS, FLAT_TB) <= smem_bytes
                    and need(d, p, MAX_SLOTS, 1) <= smem_bytes):
                dims, paths = d, p
                continue
            tiles.append((r0, r))
            r0 = r
        dims, paths = fixed + adds[r], set(paths_of[r])
        alone = need(dims, paths, MAX_SLOTS, 1)
        if alone > smem_bytes:
            raise ValueError(f"plan: rule {r} needs {alone} bytes of shared "
                             f"memory at one resource a block, more than "
                             f"{smem_bytes}")
    if R:
        tiles.append((r0, R))
    return tiles


def _tiled_buffer(t: PolicyTensors, rows: dict, tile_words: int,
                  smem_bytes: int):
    """The plan buffer (header sizes left 0 for the caller), the tiles'
    rule ranges (:func:`_cut_tiles`) and each tile's row maps (the
    distinct check and aux row that each of its rows became, by local
    id; :func:`_section`)."""
    gate_rule = _gate_rules(t)
    _check_order(t, gate_rule)
    # gates no row names follow the rule before them
    gate_fill = np.maximum.accumulate(gate_rule) if gate_rule.size else gate_rule
    gate_fill = np.maximum(gate_fill, 0)
    tiles = _cut_tiles(t, gate_fill, int(rows["kinds"].shape[1]), tile_words,
                       smem_bytes)

    cond_before = np.concatenate([[0], np.cumsum(rows["cond_slot"] >= 0)])
    group_rule = t.alt_rule[t.group_alt] if t.group_alt.size else t.group_alt
    head = H_NHEADER + len(tiles) * TT_NCOLS
    off = -(-head // SECTION_ALIGN) * SECTION_ALIGN
    table, sections, maps = [], [], []
    for r0, r1 in tiles:
        def span(rule_of):
            lo, hi = np.searchsorted(np.asarray(rule_of), [r0, r1])
            return int(lo), int(hi)

        (c0, c1), (x0, x1) = span(t.chk_rule), span(t.ax_rule)
        (a0, a1), (g0, g1) = span(t.alt_rule), span(group_rule)
        (q0, q1), (gx0, gx1) = span(gate_fill), span(t.axg_rule)
        f0, f1 = span(t.axf_rule)
        s0, s1 = int(cond_before[c0]), int(cond_before[c1])
        sec, cmap, xmap = _section(t, rows, (r0, r1), (c0, c1), (x0, x1),
                                   (a0, a1), (g0, g1), (q0, q1), (gx0, gx1),
                                   (f0, f1), (s0, s1))
        table.append([r0, r1, c0, c1, x0, x1, q0, q1, s0, s1,
                      sec[TS_NPATH], off, sec.size, sec[TS_C], sec[TS_X]])
        sections.append(sec)
        maps.append((cmap, xmap))
        off += sec.size
    header = np.zeros(head, dtype=np.int32)
    header[H_NTILES] = len(tiles)
    header[H_TILES] = H_NHEADER
    header[H_NHEADER:] = np.asarray(table, dtype=np.int32).ravel()
    pad = np.zeros(-head % SECTION_ALIGN, dtype=np.int32)
    return np.concatenate([header, pad, *sections]), tiles, maps


def _distinct(table: np.ndarray):
    """(the distinct rows of ``table`` in order of first appearance, the
    index of each row's among them)."""
    if not len(table):
        return table, np.zeros(0, dtype=np.int64)
    _, first, inv = np.unique(table, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return table[first[order]], rank[np.ravel(inv)]


def _section(t: PolicyTensors, rows: dict, rr, cr, xr, ar, gr, qr, gxr, fr,
             sr) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One tile's section: its header, then its arrays in TS_ order, ids
    local to the tile, padded to SECTION_ALIGN words; and its row maps.

    Rows whose every column is equal (tile-local path, gate and condition
    slot included) give equal flags for every resource, so the section's
    check and aux tables hold each distinct row once and every list
    names the distinct row: a block evaluates each once. A condition row
    has a slot of its own and is never merged. Policy libraries repeat
    their checks (the 250-policy library's 248 check rows are 6 distinct
    ones), so this cuts the rows a block evaluates, its largest phase."""
    (r0, r1), (c0, c1), (x0, x1), (a0, a1) = rr, cr, xr, ar
    (g0, g1), (q0, q1), (gx0, gx1), (f0, f1), (s0, s1) = gr, qr, gxr, fr, sr
    ck = rows["chk"][c0:c1].copy()
    ax = rows["aux"][x0:x1].copy()
    paths = np.unique(np.concatenate([ck[:, CK_PATH], ax[:, AX_PATH]]))
    ck[:, CK_PATH] = np.searchsorted(paths, ck[:, CK_PATH])
    ax[:, AX_PATH] = np.searchsorted(paths, ax[:, AX_PATH])
    ck[:, CK_GATE] = _local(ck[:, CK_GATE], q0, q1, "a gated check row's gate")
    ck[:, CK_COND_SLOT] = _local(ck[:, CK_COND_SLOT], s0, s1,
                                 "a condition slot")
    ck_d, cmap = _distinct(ck)
    ax_d, xmap = _distinct(ax)
    parts = {
        TS_CHK: ck_d.T, TS_AUX: ax_d.T, TS_PATHS: paths,
        TS_RULE_FLAGS: rows["flags"][r0:r1],
        TS_RULE_KINDS: rows["kinds"][r0:r1],
        TS_AXG_INFO: rows["axg_info"][gx0:gx1],
    }
    for (hp, hi), (seg, n) in {
        (TS_GATE_PTR, TS_GATE_GRP):
            (_local(rows["group_gate"][g0:g1], q0, q1, "a gate's group"), q1 - q0),
        (TS_GRP_PTR, TS_GRP_ROW):
            (_local(t.chk_group_gid[c0:c1], g0, g1, "a check row's group"), g1 - g0),
        (TS_AXG_PTR, TS_AXG_ROW):
            (_local(t.ax_group[x0:x1], gx0, gx1, "an aux row's group"), gx1 - gx0),
    }.items():
        parts[hp], parts[hi] = _csr(seg, n)
    # rows_of below walks the check rows by their own ids; the lists the
    # kernel reads name the distinct rows
    grp_row = parts[TS_GRP_ROW]
    parts[TS_GRP_ROW] = cmap[grp_row].astype(np.int32)
    parts[TS_AXG_ROW] = xmap[parts[TS_AXG_ROW]].astype(np.int32)
    nr = r1 - r0

    def lists(seg, n, what, lo, hi):
        ptr, items = _csr(_local(seg, lo, hi, what), n)
        return [items[ptr[i]:ptr[i + 1]] for i in range(n)]

    # pattern entries: rule -> alternatives -> groups -> rows, flattened
    alts_of = lists(t.alt_rule[a0:a1], nr, "an alternative", r0, r1)
    groups_of = lists(t.group_alt[g0:g1], a1 - a0, "a group's alternative", a0, a1)
    rows_of = [grp_row[parts[TS_GRP_PTR][g]:parts[TS_GRP_PTR][g + 1]]
               for g in range(g1 - g0)]
    kind = (np.where(ck[:, CK_IS_GATE] | ck[:, CK_IS_COND], 0, PE_PLAIN)
            | np.where(ck[:, CK_IS_COND] != 0, PE_COND, 0)
            | np.where(ck[:, CK_TRACK] >= 0, PE_TRACKED, 0)).astype(np.int64)
    multi = rows["alt_is_multi"][a0:a1]
    pat_ptr, pat = [0], []
    for r in range(nr):
        for a in alts_of[r]:
            start = len(pat)
            for g in groups_of[a]:
                rows_g = rows_of[g]
                for k, c in enumerate(rows_g):
                    end = PE_GROUP_END if k == len(rows_g) - 1 else 0
                    pat.append((int(cmap[c]) << PE_SHIFT) | int(kind[c])
                               | end)
            if len(pat) == start:
                pat.append(PE_NOROW)
            pat[-1] |= PE_ALT_END | (PE_MULTI if multi[a] else 0)
        pat_ptr.append(len(pat))
    parts[TS_PAT_PTR], parts[TS_PAT] = pat_ptr, pat

    # aux-group entries: the rule's filters' groups, filter by filter, then
    # its other groups
    filts_of = lists(t.axf_rule[f0:f1], nr, "a filter", r0, r1)
    fgroups_of = lists(t.axg_filt[gx0:gx1], f1 - f0, "an aux group's filter", f0, f1)
    axgs_of = lists(t.axg_rule[gx0:gx1], nr, "an aux group", r0, r1)
    in_filter = np.asarray(t.axg_filt[gx0:gx1]) >= 0
    filt_ex = rows["filt_ex"][f0:f1]
    auxp_ptr, auxp = [0], []
    for r in range(nr):
        for f in filts_of[r]:
            for g in fgroups_of[f]:
                auxp.append((int(g) << AE_SHIFT) | AE_FILTER)
            if not len(fgroups_of[f]):
                auxp.append(AE_NOGROUP)
            auxp[-1] |= AE_FILT_END | (AE_FILT_EX if filt_ex[f] else 0)
        auxp.extend(int(g) << AE_SHIFT for g in axgs_of[r] if not in_filter[g])
        auxp_ptr.append(len(auxp))
    parts[TS_AUXP_PTR], parts[TS_AUXP] = auxp_ptr, auxp

    header = np.zeros(TS_NHEADER, dtype=np.int32)
    header[:TS_CHK] = [len(ck_d), len(ax_d), r1 - r0, q1 - q0, paths.size]
    chunks, off = [header], TS_NHEADER
    for h in range(TS_CHK, TS_NHEADER):
        arr = np.ascontiguousarray(parts[h], dtype=np.int32).ravel()
        header[h] = off
        chunks.append(arr)
        off += arr.size
    chunks.append(np.zeros(-off % SECTION_ALIGN, dtype=np.int32))
    return np.concatenate(chunks), cmap, xmap
