"""The device plan: a compiled policy set's static tensors, turned once
into what the kernels and their plain versions read.

``Plan.buf`` is one int32 buffer for the CUDA kernels: a header of sizes
and offsets, the per-check and per-aux-row tables, and CSR lists (rule ->
alternatives -> groups -> rows, gate -> groups, rule -> aux groups -> aux
rows, rule -> filters -> groups) that replace the segment scatters of the
TPU program. Its layout is ``csrc/plan.cuh``.

``Plan.cols`` holds the same static columns as separate tensors, in the
form the plain PyTorch versions use: segment ids, as the JAX program
closed over them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.compiler import PolicyTensors
from ..models.ir import AUX_DENY, AUX_EXCLUDE, AUX_MATCH, SEP

# ---- csrc/plan.cuh: header
(H_C, H_X, H_G, H_A, H_R, H_NGATES, H_NCOND, H_GX, H_FX, H_KMAX,
 H_CHK, H_AUX, H_GATE_PTR, H_GATE_GRP, H_GRP_PTR, H_GRP_ROW, H_ALT_PTR,
 H_ALT_GRP, H_ALT_MULTI, H_RULE_PTR, H_RULE_ALT, H_RULE_FLAGS, H_RULE_KINDS,
 H_RAXG_PTR, H_RAXG_GRP, H_AXG_PTR, H_AXG_ROW, H_AXG_INFO, H_RF_PTR,
 H_RF_FILT, H_FG_PTR, H_FG_GRP, H_FILT_EX, H_NHEADER) = range(34)

# ---- csrc/plan.cuh: check table columns
(CK_PATH, CK_OP, CK_PLEN, CK_GUARD, CK_NFA, CK_HAS_NFA, CK_LO_H, CK_LO_L,
 CK_HI_H, CK_HI_L, CK_BOOL, CK_NUMFB, CK_NUMMODE, CK_GATE, CK_IS_GATE,
 CK_IS_COND, CK_EXIST, CK_TRACK, CK_COND_DEPTH, CK_COND_SLOT,
 CK_NCOLS) = range(21)

# ---- csrc/plan.cuh: aux table columns
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

    def __init__(self, tensors: PolicyTensors, device):
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

        parts = {
            H_CHK: chk.ravel(),
            H_AUX: aux.ravel(),
            H_ALT_MULTI: np.asarray(alt_is_multi, np.int32),
            H_RULE_FLAGS: flags,
            H_RULE_KINDS: kinds.ravel(),
            H_AXG_INFO: axg_info,
            H_FILT_EX: np.asarray(t.axf_is_exclude, np.int32),
        }
        group_gate_ids = group_gate[:G] if G else np.zeros(0, np.int32)
        for (hp, hi), (seg, n) in {
            (H_GATE_PTR, H_GATE_GRP): (group_gate_ids, NG),
            (H_GRP_PTR, H_GRP_ROW): (t.chk_group_gid, G),
            (H_ALT_PTR, H_ALT_GRP): (t.group_alt, A),
            (H_RULE_PTR, H_RULE_ALT): (t.alt_rule, R),
            (H_RAXG_PTR, H_RAXG_GRP): (t.axg_rule, R),
            (H_AXG_PTR, H_AXG_ROW): (t.ax_group, GX),
            (H_RF_PTR, H_RF_FILT): (t.axf_rule, R),
            (H_FG_PTR, H_FG_GRP): (t.axg_filt, FX),
        }.items():
            parts[hp], parts[hi] = _csr(seg, n)

        header = np.zeros(H_NHEADER, dtype=np.int32)
        header[[H_C, H_X, H_G, H_A, H_R, H_NGATES, H_NCOND, H_GX, H_FX, H_KMAX]] = \
            [C, X, G, A, R, NG, self.NCOND, GX, FX, kmax]
        chunks = [header]
        off = H_NHEADER
        for h in sorted(parts):
            arr = np.asarray(parts[h], dtype=np.int32).ravel()
            header[h] = off
            chunks.append(arr)
            off += arr.size
        self.buf_np = np.concatenate(chunks)
        self.buf = torch.from_numpy(self.buf_np).to(self.device)

        def dt(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a)).to(dtype=dtype, device=self.device)

        b = torch.bool
        self.nfa_char = dt(t.nfa_char, torch.uint8).contiguous()
        self.nfa_is_star = dt(t.nfa_is_star, b).contiguous()
        self.nfa_is_q = dt(t.nfa_is_q, b).contiguous()
        self.nfa_len = dt(t.nfa_len, torch.int32).contiguous()

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
