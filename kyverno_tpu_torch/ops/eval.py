"""Batched verdict evaluation: the policy x resource matrix on the card.

The same dataflow as the JAX program it was ported from, over the
compiled check rows:

  1. glob-NFA over the string dictionary                    [N, V]   K1
  2. per-check, per-slot leaf comparison + anchor masks     [B, C, E]
  3. element reduction (AND / existence-OR / gate open)     [B, C]
     aux row predicates (match/exclude/precondition/deny)   [B, X]
  4. group OR -> alternative AND -> rule verdict            [B, R]
  5. aux programs reduced to match/exclude/conditions       [B, R]
  6. verdict composition: match miss -> NOT_APPLICABLE,
     failed precondition -> SKIP, met deny -> FAIL, deny
     key unresolved -> ERROR
     (stages 2-6 are one kernel, eval_rules)
  *  scan form: eval_rules writes, instead of the verdicts, FAIL, PASS
     and HOST bit masks over 32 resources a word; K5 reduces them to
     per-rule FAIL/PASS counts over non-HOST rows and the HOST rows
  *  K7, the mesh scan's program (:func:`evaluate_live_counts`): K1,
     then eval_rules' counts form, which writes the verdicts and, as
     its epilogue, per-rule FAIL and PASS counts over every row of the
     live rule columns; the verdicts are sliced to those columns on the
     device

Each of K1 (``ops/glob.py``), :func:`eval_rules`, :func:`eval_rules_scan`
and :func:`eval_rules_counts` (stages 2-6, one kernel source) and K5
(:func:`scan_reduce`) is a wrapper that launches a CUDA kernel from
``csrc/`` for tensors on the card and runs its plain PyTorch version for
tensors on the CPU. The plain versions mirror the JAX code stage by
stage, segment reductions included: :func:`eval_checks_plain` (stages
2-3, returning the per-row flags) and :func:`eval_verdict_plain` (stages
4-6, from those flags) compose to what ``eval_rules`` computes. The
kernel keeps those flags in shared memory and walks the plan's CSR lists
instead (``ops/plan.py``).

The batch arrives as the packed blob (``FlatBatch.packed_blob``), held
on the device as int32 (the same bits as the host's uint32 words).

Verdict codes: 0 = not applicable, 1 = pass, 2 = fail, 3 = skip,
4 = error, 5 = host lane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.compiler import STR_LEN
from ..models.ir import AUX_DENY, AUX_PRECOND, AuxOp, CheckOp
from . import _build
from .glob import MAX_STATES, glob_match_matrix
from .plan import (CF_MISSING, CF_OK, CF_STRUCT, CF_UNC, MAX_SLOTS, TT_R0,
                   TT_R1, XF_ERR, XF_ROW, XF_UNC, Plan)

V_NOT_APPLICABLE, V_PASS, V_FAIL, V_SKIP, V_ERROR, V_HOST = range(6)

# type tags (mirror models/flatten.py)
T_ABSENT, T_NULL, T_BOOL, T_NUM, T_STR, T_OBJ, T_LIST = range(7)

INT32_MIN = -(1 << 31)


# ------------------------------------------------------------ blob layout

def check_blob(blob: torch.Tensor, B: int, P: int, E: int, V: int) -> None:
    """Raise unless the blob holds the parts of a (B, P, E, V) batch."""
    if blob.numel() < B * P * E * 2 + B + V * (5 + STR_LEN // 4):
        raise ValueError(f"blob of {blob.numel()} words is too short for "
                         f"B={B} P={P} E={E} V={V}")


def blob_parts(blob: torch.Tensor, B: int, P: int, E: int, V: int):
    """Views of the blob's parts: (cells [B*P*E*2], bmeta [B],
    dictv [V, 5], str_bytes [V, STR_LEN] uint8). The byte view of the
    string words is their little-endian byte order, as the JAX program's
    explicit shifts give it."""
    check_blob(blob, B, P, E, V)
    w = STR_LEN // 4
    o0 = B * P * E * 2
    o1 = o0 + B
    o2 = o1 + V * 5
    cells = blob[:o0]
    bmeta = blob[o0:o1]
    dictv = blob[o1:o2].reshape(V, 5)
    str_bytes = blob[o2:o2 + V * w].view(torch.uint8).reshape(V, STR_LEN)
    return cells, bmeta, dictv, str_bytes


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value in int64 (torch on the CPU has
    no uint32 shifts)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 value (in int64) -> its two's-complement int32 value."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def unpack_lanes_plain(blob: torch.Tensor, B: int, P: int, E: int, V: int):
    """K2, plain: the 22 evaluation lanes of flatten.unpack_batch, from
    the blob, every integer lane widened to int64."""
    cells, bmeta, dictv, str_bytes = blob_parts(blob, B, P, E, V)
    cells = _u32(cells).reshape(B, P, E, 2)
    bmeta = _u32(bmeta)
    dictv = _u32(dictv)
    w0 = cells[..., 0]
    meta = cells[..., 1]
    str_id = _i32(w0) - 1
    mask = meta & 0xFFFF
    type_tag = (meta >> 16) & 7
    slot_valid = ((meta >> 19) & 1).bool()
    null_break = ((meta >> 20) & 1).bool()
    num_int = ((meta >> 21) & 1).bool()
    elem0 = ((meta >> 22) & 0xFF) - 1

    sid_safe = torch.clamp(str_id, min=0)
    present = str_id >= 0
    is_numlike = (type_tag == T_NUM) | (type_tag == T_STR)
    is_str = type_tag == T_STR
    is_bool = type_tag == T_BOOL
    d0, d1, d2, d3, d4 = (dictv[:, col][sid_safe] for col in range(5))
    zero = torch.zeros_like(d0)
    num_ok = ((d0 >> 31) & 1).bool() & present & is_numlike
    num_lo = torch.where(num_ok, d0 & 0x7FFFFFFF, zero)
    num_hi = torch.where(num_ok, _i32(d1), zero)
    num_plain = ((d4 >> 10) & 1).bool() & present & is_numlike
    dur_any = ((d4 >> 9) & 1).bool() & present & is_str
    dur_ok = ((d2 >> 31) & 1).bool() & present & is_str
    dur_lo = torch.where(dur_any, d2 & 0x7FFFFFFF, zero)
    dur_hi = torch.where(dur_any, _i32(d3), zero)
    bool_val = ((d4 >> 8) & 1).bool() & present & is_bool
    num_int = num_int & is_numlike

    kind_id = (bmeta & 0xFFFF) - 1
    host_flag = ((bmeta >> 16) & 1).bool()
    live = ((bmeta >> 17) & 1).bool()
    str_len = dictv[:, 4] & 0x7F
    str_has_glob = ((dictv[:, 4] >> 7) & 1).bool()
    return (mask, slot_valid, null_break, type_tag, str_id, num_hi, num_lo,
            num_ok, num_plain, num_int, dur_hi, dur_lo, dur_ok, dur_any,
            bool_val, elem0, kind_id, host_flag, live,
            str_bytes, str_len, str_has_glob)


# ------------------------------------------------------ segment reductions
# JAX's segment_max over an empty segment gives INT_MIN and segment_min
# INT_MAX, so an empty OR is False and an empty AND is True. Counting
# keeps both identities explicit.

def _segment_or(values, seg, num):
    out = torch.zeros((num,) + tuple(values.shape[1:]), dtype=torch.int32,
                      device=values.device)
    out.index_add_(0, seg, values.to(torch.int32))
    return out > 0


def _segment_and(values, seg, num):
    out = torch.zeros((num,) + tuple(values.shape[1:]), dtype=torch.int32,
                      device=values.device)
    out.index_add_(0, seg, (~values).to(torch.int32))
    return out == 0


def _lex_lt(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def _lex_eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., E] bool -> [...] int32 word with bit e = bits[..., e]."""
    E = bits.shape[-1]
    shifts = torch.arange(E, device=bits.device, dtype=torch.int64)
    word = (bits.to(torch.int64) << shifts).sum(-1)
    return _i32(word).to(torch.int32)


def _unpack_bits(word: torch.Tensor, E: int) -> torch.Tensor:
    shifts = torch.arange(E, device=word.device, dtype=torch.int64)
    return ((_u32(word)[..., None] >> shifts) & 1).bool()


# ------------------------------------------------- stages 2-3, plain

def eval_checks_plain(plan: Plan, blob, B: int, P: int, E: int, V: int,
                      match_nv):
    """Stages 2-3 and the aux row predicates, plain. Returns
    (chk_flags uint8 [B, C], cond_w int32 [B, NCOND, 3],
    aux_flags uint8 [B, X]); see csrc/plan.cuh for the bits."""
    k = plan.cols
    (mask, slot_valid, null_break, type_tag, str_id, num_hi, num_lo,
     num_ok, num_plain, num_int, dur_hi, dur_lo, dur_ok, dur_any,
     bool_val, elem0, kind_id, host_flag, live,
     str_bytes, str_len, str_has_glob) = unpack_lanes_plain(blob, B, P, E, V)
    dev = blob.device
    C, X = plan.C, plan.X
    empty_str = str_len == 0
    chk_flags = torch.zeros((B, C), dtype=torch.uint8, device=dev)
    cond_w = torch.zeros((B, plan.NCOND, 3), dtype=torch.int32, device=dev)
    aux_flags = torch.zeros((B, X), dtype=torch.uint8, device=dev)
    n_groups = max(plan.G, 1)
    n_gates = max(plan.n_gates, 1)

    if C:
        c_path = k["c_path"]

        def g(x):
            return x[:, c_path, :]

        mask_c = g(mask)
        valid_c = g(slot_valid)
        nbrk_c = g(null_break)
        type_c = g(type_tag)
        sid_c = g(str_id)
        numh_c = g(num_hi)
        numl_c = g(num_lo)
        numok_c = g(num_ok)
        nplain_c = g(num_plain)
        nint_c = g(num_int)
        bool_c = g(bool_val)
        elem0_c = g(elem0)

        def col(name):
            return k[name][None, :, None]

        leaf_bit = 1 << col("c_plen")
        want_bits = (leaf_bit << 1) - 2
        absent_bits = (~mask_c) & want_bits
        first_absent = absent_bits & (-absent_bits)
        leaf_present = absent_bits == 0
        c_guard = col("c_guard")
        guard_pass = (first_absent & c_guard) != 0

        has_sid = sid_c >= 0
        sid0 = torch.clamp(sid_c, min=0)
        str_hit = match_nv[col("c_nfa"), sid0] & has_sid & col("c_has_nfa")
        stringy = (type_c == T_STR) | (type_c == T_BOOL) | (type_c == T_NUM)
        nil_like = (type_c == T_NULL) | (~leaf_present & ~nbrk_c)
        numok_n = numok_c | nil_like

        lo_h, lo_l = col("c_lo_h"), col("c_lo_l")
        hi_h, hi_l = col("c_hi_h"), col("c_hi_l")
        ge_lo = ~_lex_lt(numh_c, numl_c, lo_h, lo_l)
        le_hi = ~_lex_lt(hi_h, hi_l, numh_c, numl_c)
        gt_lo = _lex_lt(lo_h, lo_l, numh_c, numl_c)
        lt_lo = _lex_lt(numh_c, numl_c, lo_h, lo_l)
        eq_lo = _lex_eq(numh_c, numl_c, lo_h, lo_l)
        in_range = ge_lo & le_hi

        mode = col("c_nummode")
        numk_v = type_c == T_NUM
        strk_v = type_c == T_STR
        lit_str_ok = torch.where(mode == 1, nint_c, nplain_c)
        num_lit_ok = numok_c & (numk_v | (strk_v & lit_str_ok))

        numfb = col("c_numfb")
        num_eq = numok_n & eq_lo
        str_eq_ok = torch.where(numfb, num_eq, stringy & str_hit)
        str_ne_ok = torch.where(numfb, numok_n & ~eq_lo, stringy & ~str_hit)

        op = col("c_op")
        choices = [
            (CheckOp.STR_EQ, str_eq_ok),
            (CheckOp.STR_NE, str_ne_ok),
            (CheckOp.NUM_EQ, num_lit_ok & eq_lo),
            (CheckOp.NUM_NE, num_lit_ok & ~eq_lo),
            (CheckOp.NUM_GT, numok_n & gt_lo),
            (CheckOp.NUM_GE, numok_n & ge_lo),
            (CheckOp.NUM_LT, numok_n & lt_lo),
            (CheckOp.NUM_LE, numok_n & ~gt_lo),
            (CheckOp.NUM_IN_RANGE, numok_n & in_range),
            (CheckOp.NUM_NOT_IN_RANGE, numok_n & ~in_range),
            (CheckOp.BOOL_EQ, (type_c == T_BOOL) & (bool_c == col("c_bool"))),
            (CheckOp.IS_NULL,
             nil_like
             | ((type_c == T_BOOL) & ~bool_c)
             | ((type_c == T_NUM) & numok_c & (numh_c == 0) & (numl_c == 0))
             | ((type_c == T_STR) & empty_str[sid0] & has_sid)),
            (CheckOp.EXISTS_OBJECT, type_c == T_OBJ),
            (CheckOp.EXISTS_NONNIL, leaf_present & (type_c != T_NULL)),
            (CheckOp.EXISTS_LIST, type_c == T_LIST),
            (CheckOp.ABSENT, torch.ones_like(leaf_present)),
        ]
        value_ok = torch.zeros_like(leaf_present)
        for code, val in choices:
            value_ok = torch.where(op == int(code), val, value_ok)

        absent_ok = ~leaf_present & ~nbrk_c & ((first_absent & (c_guard | leaf_bit)) != 0)
        eval_on_nil = (
            ((op >= CheckOp.NUM_GT) & (op <= CheckOp.NUM_NOT_IN_RANGE))
            | (op == CheckOp.IS_NULL)
            | (((op == CheckOp.STR_EQ) | (op == CheckOp.STR_NE)) & numfb)
        )
        nil_leaf = (~leaf_present & ~nbrk_c & ~guard_pass
                    & (first_absent == leaf_bit))
        slot_ok = torch.where(
            op == CheckOp.ABSENT,
            absent_ok,
            torch.where(leaf_present | (nil_leaf & eval_on_nil),
                        value_ok, guard_pass & ~nbrk_c),
        )

        # gates: rows OR within a group, groups AND within the gate
        gate_row_open = ~leaf_present | value_ok
        c_is_gate = k["c_is_gate"]
        c_is_cond = k["c_is_cond"]
        c_group = k["c_group"]

        def flat(x):
            return x.permute(1, 0, 2).reshape(C, B * E)

        gate_gseg = torch.where(c_is_gate, c_group, n_groups)
        ggrp_open = _segment_or(
            torch.where(c_is_gate[:, None], flat(gate_row_open | ~valid_c), False),
            gate_gseg, n_groups + 1)[:n_groups]
        gate_open = _segment_and(
            torch.where(k["group_is_gate"][:, None], ggrp_open, True),
            k["group_gate_seg"], n_gates + 1)[:n_gates].reshape(n_gates, B, E)

        c_gate = k["c_gate"]
        has_gate = c_gate >= 0
        gate_idx = torch.clamp(c_gate, min=0)
        e0 = torch.clamp(elem0_c, 0, E - 1)
        b_idx = torch.arange(B, device=dev)[:, None, None]
        gate_for_slot = gate_open[gate_idx[None, :, None], b_idx, e0]
        gate_skips = has_gate[None, :, None] & (elem0_c >= 0) & ~gate_for_slot
        slot_ok = torch.where(gate_skips, True, slot_ok)

        # element reduction
        and_ok = (slot_ok | ~valid_c).all(dim=2)
        or_ok = (slot_ok & valid_c & leaf_present).any(dim=2)
        tr0 = col("c_track")
        exist_clean_miss = (((first_absent == (1 << torch.clamp(tr0, min=0)))
                             | guard_pass) & ~nbrk_c)
        exist_absent_ok = ((exist_clean_miss | ~valid_c).all(dim=2)
                           & valid_c.any(dim=2))
        check_ok = torch.where(k["c_exist"][None, :], or_ok | exist_absent_ok,
                               and_ok)

        # condition rows: per-element words, OR-ed over a group's rows in stage 4
        cond_bit = 1 << torch.clamp(col("c_cond_depth"), min=0)
        cond_key_present = (mask_c & cond_bit) != 0
        cond_ok_bits = leaf_present & value_ok
        cond_kp_bits = cond_key_present & valid_c
        cond_chain_bits = (
            ((first_absent != 0) & (first_absent < cond_bit)
             & ~(guard_pass & ~nbrk_c) & valid_c)
            | (nbrk_c & (first_absent == cond_bit) & valid_c))
        cr = k["cond_rows"]
        if plan.NCOND:
            cond_w[:, :, 0] = _pack_bits(cond_ok_bits[:, cr, :])
            cond_w[:, :, 1] = _pack_bits(cond_kp_bits[:, cr, :])
            cond_w[:, :, 2] = _pack_bits(cond_chain_bits[:, cr, :])

        # anchorMap tracking
        tr = tr0
        tr_parent = ((mask_c >> torch.clamp(tr - 1, min=0)) & 1) > 0
        tr_present = ((mask_c >> torch.clamp(tr, min=0)) & 1) > 0
        break_at_tr = nbrk_c & (first_absent == (1 << torch.clamp(tr, min=0)))
        registered = ((k["c_track"][None, :] >= 0)
                      & (tr_parent & valid_c & ~break_at_tr).any(dim=2))
        anchor_missing = registered & ~(tr_present & valid_c).any(dim=2)

        # cells the device cannot score faithfully (composed in stages 4-6)
        gate_key_absent = (c_is_gate[None, :]
                           & (~leaf_present & valid_c & (elem0_c >= 0)).any(dim=2))
        gate_struct = c_is_gate[None, :] & (nbrk_c & valid_c).any(dim=2)
        is_value_check = ~((op == CheckOp.ABSENT)
                           | (op == CheckOp.EXISTS_OBJECT)
                           | (op == CheckOp.EXISTS_NONNIL)
                           | (op == CheckOp.EXISTS_LIST))[:, :, 0]
        list_leaf = (is_value_check
                     & ((type_c == T_LIST) & leaf_present & valid_c).any(dim=2))
        unc_rows = gate_key_absent | list_leaf
        chk_flags = (check_ok.to(torch.uint8) * CF_OK
                     | anchor_missing.to(torch.uint8) * CF_MISSING
                     | unc_rows.to(torch.uint8) * CF_UNC
                     | gate_struct.to(torch.uint8) * CF_STRUCT)

    if X:
        x_path = k["x_path"]

        def gx(arr):
            return arr[:, x_path, 0]

        maskx = gx(mask)
        typex = gx(type_tag)
        sidx = gx(str_id)
        nhx, nlx = gx(num_hi), gx(num_lo)
        nokx = gx(num_ok)
        nplainx = gx(num_plain)
        nintx = gx(num_int)
        dhx, dlx = gx(dur_hi), gx(dur_lo)
        durokx = gx(dur_ok)
        duranyx = gx(dur_any)
        boolx = gx(bool_val)
        nbrkx = gx(null_break)

        def xc(name):
            return k[name][None, :]

        leafb = 1 << xc("x_plen")
        wantb = (leafb << 1) - 2
        presx = ((~maskx) & wantb) == 0
        nullx = (presx & (typex == T_NULL)) | (~presx & nbrkx)
        absx = ~presx & ~nbrkx

        hasid = sidx >= 0
        sid0 = torch.clamp(sidx, min=0)
        globx = match_nv[xc("x_nfa"), sid0] & hasid & xc("x_has_nfa")
        keyglob = str_has_glob[sid0] & hasid

        strk = typex == T_STR
        numk = typex == T_NUM
        boolk = typex == T_BOOL
        listk = typex == T_LIST

        qh, ql = xc("x_q_h"), xc("x_q_l")
        sh, sl = xc("x_s_h"), xc("x_s_l")
        n_lt_q = _lex_lt(nhx, nlx, qh, ql)
        n_gt_q = _lex_lt(qh, ql, nhx, nlx)
        n_eq_q = _lex_eq(nhx, nlx, qh, ql)
        n_lt_s = _lex_lt(nhx, nlx, sh, sl)
        n_gt_s = _lex_lt(sh, sl, nhx, nlx)
        d_lt_s = _lex_lt(dhx, dlx, sh, sl)
        d_gt_s = _lex_lt(sh, sl, dhx, dlx)
        d_eq_s = _lex_eq(dhx, dlx, sh, sl)

        o_str, o_num, o_dur = xc("x_o_str"), xc("x_o_num"), xc("x_o_dur")
        o_float, o_int, o_quant = xc("x_o_float"), xc("x_o_int"), xc("x_o_quant")

        dur_pair = durokx & (o_dur | o_num)
        ceq = (
            (boolk & xc("x_o_bool") & (boolx == xc("x_obool")))
            | (numk & nokx & o_quant & n_eq_q
               & (o_num | (o_str & ((nintx & o_int) | (~nintx & o_float)))))
            | (strk & ((dur_pair & d_eq_s)
                       | (~dur_pair & nokx & o_str & o_quant & n_eq_q)
                       | (~dur_pair & ~nokx & o_str & globx)))
        )
        opx = xc("x_op")

        def rel4(base, lt, gt):
            return (((opx == base) & gt)
                    | ((opx == base + 1) & ~lt)
                    | ((opx == base + 2) & lt)
                    | ((opx == base + 3) & ~gt))

        cmp_q = rel4(int(AuxOp.CGT), n_lt_q, n_gt_q)
        cmp_ns = rel4(int(AuxOp.CGT), n_lt_s, n_gt_s)
        cmp_ds = rel4(int(AuxOp.CGT), d_lt_s, d_gt_s)
        numkey_cmp = ((o_num & cmp_q)
                      | (~o_num & o_str & o_dur & cmp_ns)
                      | (~o_num & o_str & ~o_dur & o_float & cmp_q))
        cnum = (
            (numk & numkey_cmp)
            | (strk & dur_pair & cmp_ds)
            | (strk & ~dur_pair & nplainx & numkey_cmp)
            | (strk & ~dur_pair & ~nplainx & nokx & o_str & o_quant & cmp_q)
        )
        dnum = rel4(int(AuxOp.DGT), n_lt_s, n_gt_s)
        ddur = rel4(int(AuxOp.DGT), d_lt_s, d_gt_s)
        cdur = (numk & dnum) | (strk & duranyx & ddur)
        in_keyish = strk | (numk & xc("x_allow_num") & nintx)
        cin = in_keyish & globx

        op_val = (
            (opx == int(AuxOp.TRUE))
            | ((opx == int(AuxOp.GLOB)) & (strk | (numk & nintx)) & globx)
            | ((opx == int(AuxOp.EXISTS)) & presx)
            | ((opx == int(AuxOp.NOT_EXISTS)) & ~presx)
            | ((opx == int(AuxOp.CEQ)) & ceq)
            | (((opx == int(AuxOp.CIN_ITEM)) | (opx == int(AuxOp.CIN_GLOB))) & cin)
            | ((opx >= int(AuxOp.CGT)) & (opx <= int(AuxOp.CLE)) & cnum)
            | ((opx >= int(AuxOp.DGT)) & (opx <= int(AuxOp.DLE)) & cdur)
        )

        absres = xc("x_absent")
        is_exist_op = (opx == int(AuxOp.EXISTS)) | (opx == int(AuxOp.NOT_EXISTS))
        pres_nonnull = presx & (typex != T_NULL)
        match_val = ((is_exist_op & op_val)
                     | (~is_exist_op & pres_nonnull & op_val)
                     | (~is_exist_op & ~pres_nonnull & absres))
        cond_val_deny = ~nullx & ((presx & op_val) | (~presx & absres))
        cond_val_pre = ((presx & ~nullx & op_val)
                        | ((~presx | nullx) & absres))
        cond_val = torch.where(xc("x_deny_row"), cond_val_deny, cond_val_pre)
        is_mk = xc("x_is_match_klass")
        has_p = xc("x_has_path")
        rowv = (is_mk & match_val) | (~is_mk & cond_val)
        rowv = (has_p & rowv) | (~has_p & op_val)
        x_kind = xc("x_kind")
        kind_ok = (x_kind < 0) | (kind_id[:, None] == x_kind)
        rowv = rowv & kind_ok

        is_cinop = (opx == int(AuxOp.CIN_ITEM)) | (opx == int(AuxOp.CIN_GLOB))
        xg_negated = k["axg_negate"][k["x_group"]][None, :]
        unc = is_cinop & (
            listk
            | (typex == T_OBJ)
            | (xg_negated & boolk)
            | (numk & xc("x_allow_num") & ~nintx)
            | (xc("x_key_pat") & strk & keyglob))
        unc = unc | ((opx == int(AuxOp.GLOB)) & presx
                     & ~(strk | (numk & nintx) | (typex == T_NULL)))
        unc = unc & kind_ok
        errx = xc("x_err") & (absx | nullx) & has_p
        aux_flags = (rowv.to(torch.uint8) * XF_ROW
                     | unc.to(torch.uint8) * XF_UNC
                     | errx.to(torch.uint8) * XF_ERR)

    return chk_flags, cond_w, aux_flags


# ------------------------------------------------- stages 4-6, plain

def eval_verdict_plain(plan: Plan, blob, B: int, P: int, E: int, V: int,
                       chk_flags, cond_w, aux_flags):
    """Stages 4-6, plain: segment reductions over the static id maps,
    then the verdict composition. Returns int8 [B, R]."""
    k = plan.cols
    dev = blob.device
    _, bmeta, _, _ = blob_parts(blob, B, P, E, V)
    bmeta = _u32(bmeta)
    kind_id = (bmeta & 0xFFFF) - 1
    host_flag = ((bmeta >> 16) & 1).bool()
    live = ((bmeta >> 17) & 1).bool()
    C, X = plan.C, plan.X
    n_groups = max(plan.G, 1)
    n_alts = max(plan.A, 1)
    n_rules = max(plan.R, 1)
    n_axg = max(plan.GX, 1)
    n_axf = max(plan.FX, 1)

    if C:
        flags = chk_flags.to(torch.int32)
        check_ok = (flags & CF_OK) != 0
        anchor_missing = (flags & CF_MISSING) != 0
        unc_rows = (flags & CF_UNC) != 0
        gate_struct = (flags & CF_STRUCT) != 0
        c_is_gate, c_is_cond = k["c_is_gate"], k["c_is_cond"]
        c_group, c_track = k["c_group"], k["c_track"]
        group_alt, alt_rule = k["group_alt"], k["alt_rule"]
        alt_is_multi = k["alt_is_multi"]

        seg_ok = check_ok.T
        is_plain = ~(c_is_gate | c_is_cond)
        plain_seg = torch.where(is_plain, c_group, n_groups)
        group_or = _segment_or(torch.where(is_plain[:, None], seg_ok, False),
                               plain_seg, n_groups + 1)[:n_groups]
        group_ok = group_or | ~k["has_plain"][:, None]
        alt_ok = _segment_and(group_ok, group_alt, n_alts)

        # condition groups: OR rows per element, then any over elements
        cond_g = c_group[k["cond_rows"]]
        NC = plan.NCOND
        bits = _unpack_bits(cond_w, E)                       # [B, NC, 3, E]

        def per_group(j):
            x = bits[:, :, j, :].permute(1, 0, 2).reshape(NC, B * E)
            return _segment_or(x, cond_g, n_groups)          # [G, B*E]

        cgrp_ok, cgrp_kp, cgrp_ch = per_group(0), per_group(1), per_group(2)
        cond_fail_g = (cgrp_kp & ~cgrp_ok).reshape(n_groups, B, E).any(dim=2)
        cond_chain_g = cgrp_ch.reshape(n_groups, B, E).any(dim=2)
        cond_group = k["cond_group"][:, None]
        alt_skip = _segment_or(torch.where(cond_group, cond_fail_g, False),
                               group_alt, n_alts)
        alt_chain_fail = _segment_or(torch.where(cond_group, cond_chain_g, False),
                                     group_alt, n_alts)
        alt_ok = alt_ok & ~alt_chain_fail

        track_seg = torch.where(c_track >= 0, k["c_alt"], n_alts)
        alt_missing = _segment_or(
            torch.where((c_track >= 0)[:, None], anchor_missing.T, False),
            track_seg, n_alts + 1)[:n_alts]

        ambig = alt_skip & ~alt_ok & ~alt_is_multi[:, None]
        alt_verdict = torch.where(
            ambig, V_HOST,
            torch.where(alt_skip, V_SKIP,
                        torch.where(alt_ok, V_PASS,
                                    torch.where(alt_missing, V_HOST, V_FAIL))))
        alt_verdict = alt_verdict.to(torch.int32)

        rule_pass = _segment_or(alt_verdict == V_PASS, alt_rule, n_rules)
        # segment_max over alternatives; an empty segment keeps INT_MIN
        single_verdict = torch.full((n_rules, B), INT32_MIN, dtype=torch.int32,
                                    device=dev)
        single_verdict.scatter_reduce_(
            0, alt_rule[:, None].expand(plan.A, B),
            torch.where(alt_is_multi[:, None], 0, alt_verdict).to(torch.int32),
            "amax", include_self=True)
        multi = _segment_or(alt_is_multi[:, None].expand(plan.A, B),
                            alt_rule, n_rules)
        verdict = torch.where(
            multi, torch.where(rule_pass, V_PASS, V_FAIL).to(torch.int32),
            single_verdict).T

        c_rule = k["c_rule"]
        rule_uncertain = _segment_or(unc_rows.T, c_rule, n_rules + 1)[:n_rules].T
        verdict = torch.where(
            rule_uncertain & ((verdict == V_FAIL) | (verdict == V_ERROR)
                              | (verdict == V_SKIP)),
            V_HOST, verdict)
        rule_struct = _segment_or(gate_struct.T, c_rule, n_rules + 1)[:n_rules].T
        verdict = torch.where(rule_struct, V_HOST, verdict)
    else:
        verdict = torch.where(k["covered"][None, :], V_PASS,
                              V_NOT_APPLICABLE).expand(B, n_rules)
    verdict = verdict.to(torch.int32)

    if X:
        aflags = aux_flags.to(torch.int32)
        rowv = (aflags & XF_ROW) != 0
        unc = (aflags & XF_UNC) != 0
        errx = (aflags & XF_ERR) != 0
        x_rule = k["x_rule"]
        is_mk = k["x_is_match_klass"][None, :]
        match_unc = _segment_or((unc & is_mk).T, x_rule, n_rules).T
        cond_unc = _segment_or((unc & ~is_mk).T, x_rule, n_rules).T
        deny_err = _segment_or(errx.T, x_rule, n_rules).T

        grp0 = _segment_or(rowv.T, k["x_group"], n_axg)
        neg = k["axg_negate"][:, None]
        grp = (neg & ~grp0) | (~neg & grp0)

        axg_filt = k["axg_filt"]
        has_filt = axg_filt >= 0
        filt_seg = torch.where(has_filt, axg_filt, n_axf)
        filt_ok = _segment_and(~has_filt[:, None] | grp, filt_seg,
                               n_axf + 1)[:n_axf]

        axf_rule, axf_is_ex = k["axf_rule"], k["axf_is_ex"]
        is_m = ~axf_is_ex
        mseg = torch.where(is_m, axf_rule, n_rules)
        m_or = _segment_or(is_m[:, None] & filt_ok, mseg, n_rules + 1)[:n_rules]
        m_and = _segment_and(~is_m[:, None] | filt_ok, mseg, n_rules + 1)[:n_rules]
        m_any = k["rule_match_any"][:, None]
        match_ok = (m_any & m_or) | (~m_any & m_and)
        match_ok = match_ok | ~k["rule_has_match"][:, None]
        eseg = torch.where(axf_is_ex, axf_rule, n_rules)
        e_or = _segment_or(axf_is_ex[:, None] & filt_ok, eseg, n_rules + 1)[:n_rules]
        e_and = _segment_and(~axf_is_ex[:, None] | filt_ok, eseg,
                             n_rules + 1)[:n_rules]
        e_all = k["rule_exclude_all"][:, None]
        exclude_hit = (((e_all & e_and) | (~e_all & e_or))
                       & k["rule_has_exclude"][:, None])
        applicable_aux = (match_ok & ~exclude_hit).T

        axg_klass, axg_any, axg_rule = k["axg_klass"], k["axg_any"], k["axg_rule"]

        def cond_reduce(klass_const, has_any_col):
            isk = axg_klass == klass_const
            in_all = isk & ~axg_any
            in_any = isk & axg_any
            all_seg = torch.where(in_all, axg_rule, n_rules)
            all_ok = _segment_and(~in_all[:, None] | grp, all_seg,
                                  n_rules + 1)[:n_rules]
            any_seg = torch.where(in_any, axg_rule, n_rules)
            any_ok = _segment_or(in_any[:, None] & grp, any_seg,
                                 n_rules + 1)[:n_rules]
            return (all_ok & (any_ok | ~has_any_col[:, None])).T

        precond_ok = cond_reduce(AUX_PRECOND, k["rule_precond_any"])
        deny_match = cond_reduce(AUX_DENY, k["rule_deny_any"])
    else:
        ones = torch.ones((B, n_rules), dtype=torch.bool, device=dev)
        applicable_aux = precond_ok = ones
        deny_match = deny_err = match_unc = cond_unc = ~ones

    rule_host = k["rule_host"][None, :]
    rule_deny = k["rule_deny"][None, :]
    deny_v = torch.where(deny_err, V_ERROR, torch.where(deny_match, V_FAIL, V_PASS))
    verdict = torch.where(rule_deny, deny_v.to(torch.int32), verdict)
    verdict = torch.where((~k["covered"] & ~k["rule_host"] & ~k["rule_deny"])[None, :],
                          V_NOT_APPLICABLE, verdict)
    verdict = torch.where(precond_ok, verdict, V_SKIP)
    verdict = torch.where(cond_unc & ~rule_host, V_HOST, verdict)
    verdict = torch.where(applicable_aux | rule_host, verdict, V_NOT_APPLICABLE)
    verdict = torch.where(match_unc & ~rule_host, V_HOST, verdict)
    verdict = torch.where(rule_host, V_HOST, verdict)
    kind_hit = (k["rule_kind_ids"][None, :, :] == kind_id[:, None, None]).any(-1)
    applicable_host = kind_hit | k["rule_all_kinds"][None, :]
    verdict = torch.where(rule_host & ~applicable_host, V_NOT_APPLICABLE, verdict)
    verdict = torch.where(host_flag[:, None], V_HOST, verdict)
    verdict = torch.where(live[:, None], verdict, V_NOT_APPLICABLE)
    return verdict.to(torch.int8)[:, :plan.R]


# ------------------------------------------------- stages 2-6, eval_rules

# The geometry of the last launch of eval_rules (any form) in this
# process, as the kernel chose it: resources a group, dynamic shared
# memory a block (bytes), blocks in all (over every rule tile) and blocks
# an SM.
LAUNCH_INFO = 4
LAST_LAUNCH = np.zeros(LAUNCH_INFO, dtype=np.int32)
_LAST_LAUNCH_PTR = LAST_LAUNCH.ctypes.data


def eval_rules_plain(plan: Plan, blob, B: int, P: int, E: int, V: int,
                     match_nv):
    """Stages 2-6, plain: :func:`eval_verdict_plain` over
    :func:`eval_checks_plain`. Returns int8 [B, R]."""
    return eval_verdict_plain(plan, blob, B, P, E, V,
                              *eval_checks_plain(plan, blob, B, P, E, V,
                                                 match_nv))


def _check_rules_args(plan: Plan, blob, B, P, E, V, match_nv, name):
    _require(blob, torch.int32, blob.device, "blob")
    _require(match_nv, torch.bool, blob.device, "match_nv")
    check_blob(blob, B, P, E, V)
    if tuple(match_nv.shape) != (plan.nfa_char.shape[0], V):
        raise ValueError(f"{name}: match_nv {tuple(match_nv.shape)} is "
                         f"not [N={plan.nfa_char.shape[0]}, V={V}]")
    if plan.buf.device != blob.device:
        raise ValueError(f"{name}: plan and blob are on different devices")
    if plan.buf.data_ptr() % 16:
        raise ValueError(f"{name}: the plan buffer is not 16-byte aligned")
    if plan.min_paths > P:
        raise ValueError(f"{name}: the plan reads path {plan.min_paths - 1}"
                         f" but the batch has P={P}")


def _rules_device(blob, E: int, name: str):
    """The device of a stages 2-6 call; raises for E beyond the kernel's
    slots and for devices other than the CPU and CUDA."""
    if E > MAX_SLOTS:
        raise ValueError(f"{name}: E={E} slots exceed {MAX_SLOTS}")
    dev = blob.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def eval_rules(plan: Plan, blob, B: int, P: int, E: int, V: int, match_nv,
               out=None, launch=None):
    """Stages 2-6 in one launch: the verdicts int8 [B, R] from the blob and
    K1's glob matrix. CUDA kernel ``csrc/eval_rules.cu`` on the card
    (blocks over each rule tile of the plan that walk groups of up to 128
    resources, as the kernel chooses; see ``LAST_LAUNCH``),
    :func:`eval_rules_plain` on the CPU. ``out``, a contiguous int8
    [B, R] on the blob's device, receives the verdicts in place of a new
    tensor, and ``launch``, a C-contiguous numpy int32[LAUNCH_INFO], the
    launch's geometry in place of ``LAST_LAUNCH`` (K6's slot keeps both
    for its CUDA graph)."""
    dev = _rules_device(blob, E, "eval_rules")
    R = plan.R
    if out is not None and (out.device != dev or out.dtype != torch.int8
                            or tuple(out.shape) != (B, R)
                            or not out.is_contiguous()):
        raise ValueError(f"eval_rules: out must be a contiguous "
                         f"torch.int8[{B}, {R}] on {dev}, got {out.dtype}"
                         f"{list(out.shape)} on {out.device}")
    if dev.type == "cpu":
        v = eval_rules_plain(plan, blob, B, P, E, V, match_nv)
        return v if out is None else out.copy_(v)
    _check_rules_args(plan, blob, B, P, E, V, match_nv, "eval_rules")
    if launch is None:
        info = _LAST_LAUNCH_PTR
    elif (launch.dtype != np.int32 or launch.shape != (LAUNCH_INFO,)
          or not launch.flags.c_contiguous):
        raise ValueError(f"eval_rules: launch must be a C-contiguous numpy "
                         f"int32[{LAUNCH_INFO}]")
    else:
        info = launch.ctypes.data
    if out is None:
        out = torch.empty((B, R), dtype=torch.int8, device=dev)
    if B == 0 or R == 0:
        return out
    f = _build.fn("eval_rules", "ktpu_eval_rules", 12)
    err = f(plan.buf.data_ptr(), blob.data_ptr(), B, P, E, V,
            match_nv.data_ptr(), plan.tile_ptr, plan.n_tiles,
            info, out.data_ptr(), _build.stream_handle(dev))
    _build.check("eval_rules", err)
    _build.note_launch("eval_rules")
    return out


# ------------------------------------------------- scan form and K5
# Masks hold 32 resources a word: word g covers resources 32g .. 32g+31,
# bit b % 32 for resource b, whatever block size the kernel chose. The
# uint32 words are held as int32 tensors (the same bits), as the blob is.

def _words(bits: torch.Tensor) -> torch.Tensor:
    """[B, K] bool -> [ceil(B / 32), K] int32: bit b % 32 of word b // 32."""
    B, K = bits.shape
    G = -(-B // 32)
    pad = torch.zeros((G * 32, K), dtype=torch.int64, device=bits.device)
    pad[:B] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = (pad.reshape(G, 32, K) << shifts[None, :, None]).sum(dim=1)
    return _i32(w).to(torch.int32)


def scan_masks_plain(plan: Plan, verdict):
    """The scan form's masks from the verdicts int8 [B, R]: (fail_m
    [G, R], pass_m [G, R], host_m [n_tiles, G]), G = ceil(B / 32).
    host_m[t] is the OR over rule tile t's rules (``TT_R0`` .. ``TT_R1``
    of the plan's tile table) of their HOST cells."""
    B, R = verdict.shape
    if R != plan.R:
        raise ValueError(f"scan_masks_plain: {R} verdict columns, the plan "
                         f"has {plan.R} rules")
    host = verdict == V_HOST
    tiles = torch.zeros((B, plan.n_tiles), dtype=torch.bool,
                        device=verdict.device)
    for t, row in enumerate(plan.tile_table):
        tiles[:, t] = host[:, int(row[TT_R0]):int(row[TT_R1])].any(dim=1)
    return (_words(verdict == V_FAIL), _words(verdict == V_PASS),
            _words(tiles).T.contiguous())


def scan_reduce_plain(fail_m, pass_m, host_m, B: int):
    """K5, plain: (fails int32 [R], passes int32 [R], host_rows bool [B])
    from the masks: a row is HOST where any tile's mask has its bit, and
    the counts take the FAIL / PASS bits of the other rows."""
    G, R = fail_m.shape
    dev = fail_m.device
    host = torch.zeros(G, dtype=torch.int64, device=dev)
    for row in _u32(host_m):
        host |= row
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    keep = (~host & 0xFFFFFFFF)[:, None]

    def count(m):
        bits = ((_u32(m) & keep)[..., None] >> shifts) & 1
        return bits.sum(dim=(0, 2)).to(torch.int32)

    host_rows = ((host[:, None] >> shifts) & 1).bool().reshape(-1)[:B]
    return count(fail_m), count(pass_m), host_rows


def scan_counts_plain(verdict):
    """Per-rule FAIL/PASS counts over rows with no HOST cell, and the
    rows that hold one: (fails int32 [R], passes int32 [R], host_rows
    bool [B]). The reference for the whole scan reduction."""
    host_rows = (verdict == V_HOST).any(dim=1)
    live = ~host_rows[:, None]
    fails = ((verdict == V_FAIL) & live).sum(dim=0, dtype=torch.int32)
    passes = ((verdict == V_PASS) & live).sum(dim=0, dtype=torch.int32)
    return fails, passes, host_rows


def eval_rules_scan(plan: Plan, blob, B: int, P: int, E: int, V: int,
                    match_nv):
    """Stages 2-6, scan form: (fail_m, pass_m, host_m) as
    :func:`scan_masks_plain` gives them, without the [B, R] verdicts.
    The scan form of ``csrc/eval_rules.cu`` on the card (the same blocks
    as :func:`eval_rules`, which write masks instead of verdict bytes),
    :func:`scan_masks_plain` over :func:`eval_rules_plain` on the CPU."""
    dev = _rules_device(blob, E, "eval_rules_scan")
    if dev.type == "cpu":
        return scan_masks_plain(plan, eval_rules_plain(plan, blob, B, P, E,
                                                       V, match_nv))
    _check_rules_args(plan, blob, B, P, E, V, match_nv, "eval_rules_scan")
    R, T = plan.R, plan.n_tiles
    G = -(-B // 32)
    # one buffer, so that the kernel's entry zeroes it (where its blocks
    # share words) with one memset
    buf = torch.empty(2 * G * R + T * G, dtype=torch.int32, device=dev)
    masks = (buf[:G * R].view(G, R), buf[G * R:2 * G * R].view(G, R),
             buf[2 * G * R:].view(T, G))
    if B == 0 or R == 0:
        return masks
    f = _build.fn("eval_rules", "ktpu_eval_rules_scan", 12)
    err = f(plan.buf.data_ptr(), blob.data_ptr(), B, P, E, V,
            match_nv.data_ptr(), plan.tile_ptr, T, _LAST_LAUNCH_PTR,
            buf.data_ptr(), _build.stream_handle(dev))
    _build.check("eval_rules_scan", err)
    _build.note_launch("eval_rules_scan")
    return masks


def scan_reduce(fail_m, pass_m, host_m, B: int):
    """K5: (fails [R], passes [R], host_rows [B]) from the scan form's
    masks. CUDA kernel ``csrc/scan_counts.cu`` on the card (one launch;
    its entry zeroes the counts), :func:`scan_reduce_plain` on the CPU."""
    dev = fail_m.device
    if dev.type == "cpu":
        return scan_reduce_plain(fail_m, pass_m, host_m, B)
    if dev.type != "cuda":
        raise ValueError(f"scan_reduce: unsupported device {dev}")
    G, R = fail_m.shape
    for name, t in (("fail_m", fail_m), ("pass_m", pass_m), ("host_m", host_m)):
        _require(t, torch.int32, dev, name)
    if (tuple(pass_m.shape) != (G, R) or host_m.dim() != 2
            or host_m.shape[1] != G or G != -(-B // 32)):
        raise ValueError(f"scan_reduce: masks {tuple(fail_m.shape)}, "
                         f"{tuple(pass_m.shape)}, {tuple(host_m.shape)} do "
                         f"not fit B={B}")
    counts = torch.empty((2, R), dtype=torch.int32, device=dev)
    host_rows = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        counts.zero_()
        return counts[0], counts[1], host_rows
    f = _build.fn("scan_counts", "ktpu_scan_counts", 10)
    err = f(fail_m.data_ptr(), pass_m.data_ptr(), host_m.data_ptr(),
            host_m.shape[0], G, R, B, counts.data_ptr(),
            host_rows.data_ptr(), _build.stream_handle(dev))
    _build.check("scan_counts", err)
    _build.note_launch("scan_counts")
    return counts[0], counts[1], host_rows


# ------------------------------------------------------------- pipeline

def _require(t, dtype, dev, name):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")


def match_matrix(plan: Plan, blob, B: int, P: int, E: int, V: int,
                 out=None):
    """Stage 1 (K1) over the blob's dictionary: [N, V] bool (into
    ``out`` where given)."""
    _, _, dictv, str_bytes = blob_parts(blob, B, P, E, V)
    return glob_match_matrix(plan.nfa_char, plan.nfa_is_star, plan.nfa_is_q,
                             plan.nfa_len, str_bytes, dictv[:, 4], plan.glob,
                             out=out)


def evaluate_blob(plan: Plan, blob, B: int, P: int, E: int, V: int,
                  match=None, out=None, launch=None):
    """Verdicts int8 [B, R] of one packed blob: K1 -> eval_rules. K6's
    capture passes its slot's buffers: ``match`` for K1's matrix, ``out``
    for the verdicts, ``launch`` for eval_rules' block size and bytes."""
    return eval_rules(plan, blob, B, P, E, V,
                      match_matrix(plan, blob, B, P, E, V, out=match),
                      out=out, launch=launch)


def blob_launch_args(plan: Plan, blob_ptr: int, B: int, P: int, E: int,
                     V: int, match_ptr: int, out_ptr: int, stream: int):
    """What :func:`evaluate_blob` passes to the two C entries, for a packed
    blob at device address ``blob_ptr`` with K1's matrix [N, V] at
    ``match_ptr`` and the verdicts [B, R] at ``out_ptr`` (the plain
    route's one-call dispatch, ``csrc/dispatch.cu``): a list of (kernel,
    entry address, int64 arguments [12]), leaving out a kernel whose
    wrapper would launch nothing. The caller owns the buffers; the checks
    are the wrappers' checks of what the addresses cannot show."""
    n, s = plan.nfa_char.shape
    _rules_device(plan.buf, E, "blob_launch_args")
    if s + 1 > MAX_STATES:
        raise ValueError(f"blob_launch_args: {s} NFA states exceed the "
                         f"kernel's {MAX_STATES - 1}")
    if plan.min_paths > P:
        raise ValueError(f"blob_launch_args: the plan reads path "
                         f"{plan.min_paths - 1} but the batch has P={P}")
    if (blob_ptr % 4 or plan.buf.data_ptr() % 16
            or plan.glob.consume.data_ptr() % 16):
        raise ValueError("blob_launch_args: the blob is not 4-byte aligned, "
                         "or the plan not 16-byte aligned")
    o1 = B * P * E * 2 + B          # the dictionary's words [V, 5]
    o2 = o1 + V * 5                 # its strings, STR_LEN bytes each
    out = []
    if n > 0 and V > 0:
        g = plan.glob
        out.append(("glob_nfa", _build.address("glob_nfa", "ktpu_glob_nfa", 12),
                    np.array([g.consume.data_ptr(), g.star.data_ptr(),
                              g.full.data_ptr(), g.acc.data_ptr(), n, s,
                              blob_ptr + 4 * o2, blob_ptr + 4 * (o1 + 4), 5,
                              V, match_ptr, stream], dtype=np.int64)))
    if B > 0 and plan.R > 0:
        out.append(("eval_rules",
                    _build.address("eval_rules", "ktpu_eval_rules", 12),
                    np.array([plan.buf.data_ptr(), blob_ptr, B, P, E, V,
                              match_ptr, plan.tile_ptr, plan.n_tiles,
                              _LAST_LAUNCH_PTR, out_ptr, stream],
                             dtype=np.int64)))
    return out


def scan_blob(plan: Plan, blob, B: int, P: int, E: int, V: int):
    """Background-scan form: (fails [R], passes [R], host_rows [B]).
    K1 -> eval_rules (scan form) -> K5: the [B, R] verdicts are never
    made, only FAIL / PASS / HOST masks of 32 resources a word."""
    masks = eval_rules_scan(plan, blob, B, P, E, V,
                            match_matrix(plan, blob, B, P, E, V))
    return scan_reduce(*masks, B)


# ------------------------------------------------------------------ K7

def _check_live(plan: Plan, live: int, name: str) -> None:
    if not 0 <= live <= plan.R:
        raise ValueError(f"{name}: live={live} outside the plan's "
                         f"{plan.R} rules")


def rule_counts_plain(verdict):
    """K7's counts, plain: (fails int32 [R], passes int32 [R]) over every
    row of the verdicts int8 [B, R], HOST rows included."""
    return ((verdict == V_FAIL).sum(dim=0, dtype=torch.int32),
            (verdict == V_PASS).sum(dim=0, dtype=torch.int32))


def eval_rules_counts(plan: Plan, blob, B: int, P: int, E: int, V: int,
                      match_nv, live: int):
    """Stages 2-6 with K7's counts as their epilogue: (verdicts int8
    [B, R], fails int32 [live], passes int32 [live]), the counts over
    every row of the first ``live`` rule columns. The counts form of
    ``csrc/eval_rules.cu`` on the card (the matrix form's blocks, which
    also count each rule's FAIL and PASS cells; its entry zeroes the
    counts), :func:`eval_rules_plain` then :func:`rule_counts_plain` on
    the CPU."""
    dev = _rules_device(blob, E, "eval_rules_counts")
    _check_live(plan, live, "eval_rules_counts")
    if dev.type == "cpu":
        v = eval_rules_plain(plan, blob, B, P, E, V, match_nv)
        return (v, *rule_counts_plain(v[:, :live]))
    _check_rules_args(plan, blob, B, P, E, V, match_nv, "eval_rules_counts")
    R = plan.R
    out = torch.empty((B, R), dtype=torch.int8, device=dev)
    counts = torch.empty((2, live), dtype=torch.int32, device=dev)
    if B == 0 or R == 0:
        counts.zero_()
        return out, counts[0], counts[1]
    f = _build.fn("eval_rules", "ktpu_eval_rules_counts", 14)
    err = f(plan.buf.data_ptr(), blob.data_ptr(), B, P, E, V,
            match_nv.data_ptr(), plan.tile_ptr, plan.n_tiles,
            _LAST_LAUNCH_PTR, out.data_ptr(), live, counts.data_ptr(),
            _build.stream_handle(dev))
    _build.check("eval_rules_counts", err)
    _build.note_launch("eval_rules_counts")
    return out, counts[0], counts[1]


def evaluate_live_counts(plan: Plan, blob, B: int, P: int, E: int, V: int,
                         live: int):
    """K7's program on one data shard: K1 -> :func:`eval_rules_counts`.
    Returns (verdicts int8 [B, live], a view whose rows are plan.R bytes
    apart, sliced on the device; fails int32 [live]; passes int32
    [live]). A policy shard's rule axis pads to a power-of-two bucket;
    the slice keeps its inert columns off the copy back and out of the
    counts."""
    _check_live(plan, live, "evaluate_live_counts")
    v, fails, passes = eval_rules_counts(
        plan, blob, B, P, E, V, match_matrix(plan, blob, B, P, E, V), live)
    return v[:, :live], fails, passes
