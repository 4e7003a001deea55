// K2+K3 — the packed-blob decode fused into the per-check evaluation, and
// the aux row predicates.
//
// Replaces kyverno_tpu/ops/eval.py::_split_blob and the xp=jnp branch of
// kyverno_tpu/models/flatten.py::unpack_batch (K2), and stages 1-3 of
// kyverno_tpu/ops/eval.py::build_eval_fn's evaluate (eval.py:205-463) plus
// the per-row half of stage 5 (eval.py:571-761) (K3).
//
// Bound on the H100: bytes. A (b, c) pair reads E cells of 8 bytes and, for
// a cell that names a string, one 20-byte dictionary row and a byte of the
// glob matrix; it writes one flag byte. The arithmetic per slot is a few
// dozen integer operations, far below the card's rate.
//
// Design: no separate unpack pass and no 22 materialized lanes: each
// thread decodes the cells it needs straight from the blob at the
// _split_blob offsets (plan.cuh load_slot). Three launches of this file,
// in stream order:
//   1. gate_kernel, one thread per (gate, b): for every element e, rows OR
//      within a group and groups AND within the gate, as one E-bit word
//      (E <= 32), so the checks a gate guards can read it.
//   2. checks_kernel, one thread per (b, c), loops over the E slots and
//      reduces them (AND / existence-OR / anchor tracking) to one flag
//      byte. A condition row also writes three E-bit words (ok, key
//      present, chain failure) that the verdict kernel ORs over the rows
//      of a group per element.
//   3. aux_kernel, one thread per (b, x): the aux row predicate on slot 0.
// Neighbouring threads take neighbouring c (or x) of one resource, so the
// plan rows they read are contiguous and the cells they read share lines.

#include <cstdint>
#include <cuda_runtime.h>

#include "plan.cuh"

using namespace ktpu;

namespace {

constexpr int kThreads = 256;

struct SlotEval {
  bool leaf_present, value_ok, slot_ok, guard_pass;
  int first_absent;
};

// Stage 2 for one (check, slot): eval.py:239-358.
__device__ inline SlotEval eval_slot(const int32_t* ck, const Slot& s,
                                     const Blob& bl,
                                     const uint8_t* __restrict__ match_nv) {
  SlotEval r;
  const int op = ck[CK_OP];
  const int guard = ck[CK_GUARD];
  const int leaf_bit = 1 << ck[CK_PLEN];
  const int want = (leaf_bit << 1) - 2;
  const int absent_bits = (~s.mask) & want;
  const int first_absent = absent_bits & (-absent_bits);
  const bool leaf_present = absent_bits == 0;
  const bool guard_pass = (first_absent & guard) != 0;

  const bool has_sid = s.sid >= 0;
  const bool str_hit = has_sid && ck[CK_HAS_NFA] &&
                       match_nv[(long long)ck[CK_NFA] * bl.V + s.sid];
  const bool stringy = s.type == T_STR || s.type == T_BOOL || s.type == T_NUM;
  const bool nil_like = s.type == T_NULL || (!leaf_present && !s.nbrk);
  const bool numok_n = s.numok || nil_like;

  const int lo_h = ck[CK_LO_H], lo_l = ck[CK_LO_L];
  const int hi_h = ck[CK_HI_H], hi_l = ck[CK_HI_L];
  const bool ge_lo = !lex_lt(s.numh, s.numl, lo_h, lo_l);
  const bool le_hi = !lex_lt(hi_h, hi_l, s.numh, s.numl);
  const bool gt_lo = lex_lt(lo_h, lo_l, s.numh, s.numl);
  const bool lt_lo = lex_lt(s.numh, s.numl, lo_h, lo_l);
  const bool eq_lo = lex_eq(s.numh, s.numl, lo_h, lo_l);
  const bool in_range = ge_lo && le_hi;

  const bool numk = s.type == T_NUM;
  const bool strk = s.type == T_STR;
  const bool lit_str_ok = ck[CK_NUMMODE] == 1 ? s.nint : s.nplain;
  const bool num_lit_ok = s.numok && (numk || (strk && lit_str_ok));
  const bool numfb = ck[CK_NUMFB] != 0;
  const bool num_eq = numok_n && eq_lo;
  const bool str_eq_ok = numfb ? num_eq : (stringy && str_hit);
  const bool str_ne_ok = numfb ? (numok_n && !eq_lo) : (stringy && !str_hit);

  bool value_ok = false;
  switch (op) {
    case STR_EQ: value_ok = str_eq_ok; break;
    case STR_NE: value_ok = str_ne_ok; break;
    case NUM_EQ: value_ok = num_lit_ok && eq_lo; break;
    case NUM_NE: value_ok = num_lit_ok && !eq_lo; break;
    case NUM_GT: value_ok = numok_n && gt_lo; break;
    case NUM_GE: value_ok = numok_n && ge_lo; break;
    case NUM_LT: value_ok = numok_n && lt_lo; break;
    case NUM_LE: value_ok = numok_n && !gt_lo; break;
    case NUM_IN_RANGE: value_ok = numok_n && in_range; break;
    case NUM_NOT_IN_RANGE: value_ok = numok_n && !in_range; break;
    case BOOL_EQ: value_ok = s.type == T_BOOL && s.boolv == (ck[CK_BOOL] != 0); break;
    case IS_NULL: {
      const bool empty_str =
          has_sid && ((bl.dictv[(long long)s.sid * 5 + 4] & 0x7Fu) == 0);
      value_ok = nil_like || (s.type == T_BOOL && !s.boolv) ||
                 (numk && s.numok && s.numh == 0 && s.numl == 0) ||
                 (strk && empty_str);
      break;
    }
    case EXISTS_OBJECT: value_ok = s.type == T_OBJ; break;
    case EXISTS_NONNIL: value_ok = leaf_present && s.type != T_NULL; break;
    case EXISTS_LIST: value_ok = s.type == T_LIST; break;
    case ABSENT: value_ok = true; break;
    default: value_ok = false;
  }

  const bool absent_ok = !leaf_present && !s.nbrk &&
                         ((first_absent & (guard | leaf_bit)) != 0);
  const bool eval_on_nil = (op >= NUM_GT && op <= NUM_NOT_IN_RANGE) ||
                           op == IS_NULL ||
                           ((op == STR_EQ || op == STR_NE) && numfb);
  const bool nil_leaf = !leaf_present && !s.nbrk && !guard_pass &&
                        first_absent == leaf_bit;
  bool slot_ok;
  if (op == ABSENT)
    slot_ok = absent_ok;
  else if (leaf_present || (nil_leaf && eval_on_nil))
    slot_ok = value_ok;
  else
    slot_ok = guard_pass && !s.nbrk;

  r.leaf_present = leaf_present;
  r.value_ok = value_ok;
  r.slot_ok = slot_ok;
  r.guard_pass = guard_pass;
  r.first_absent = first_absent;
  return r;
}

// 1. gate_open[gate, b]: bit e = the gate is open for element e
//    (eval.py:365-378). An absent key or an invalid slot keeps it open.
__global__ void gate_kernel(const int32_t* __restrict__ plan, Blob bl,
                            const uint8_t* __restrict__ match_nv, int n_gates,
                            uint32_t* __restrict__ gate_open) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_gates * bl.B) return;
  const int gate = (int)(t / bl.B);
  const int b = (int)(t % bl.B);
  const int32_t* chk = plan + plan[H_CHK];
  const int32_t* gate_ptr = plan + plan[H_GATE_PTR];
  const int32_t* gate_grp = plan + plan[H_GATE_GRP];
  const int32_t* grp_ptr = plan + plan[H_GRP_PTR];
  const int32_t* grp_row = plan + plan[H_GRP_ROW];
  uint32_t word = 0xFFFFFFFFu;                 // AND over no groups: open
  for (int gi = gate_ptr[gate]; gi < gate_ptr[gate + 1]; ++gi) {
    const int g = gate_grp[gi];
    uint32_t gw = 0;                           // OR over no rows: closed
    for (int ri = grp_ptr[g]; ri < grp_ptr[g + 1]; ++ri) {
      const int32_t* ck = chk + (long long)grp_row[ri] * CK_NCOLS;
      if (!ck[CK_IS_GATE]) continue;
      for (int e = 0; e < bl.E; ++e) {
        const Slot s = load_slot(bl, b, ck[CK_PATH], e);
        const SlotEval ev = eval_slot(ck, s, bl, match_nv);
        if (!ev.leaf_present || ev.value_ok || !s.valid) gw |= 1u << e;
      }
    }
    word &= gw;
  }
  gate_open[(long long)gate * bl.B + b] = word;
}

// 2. per-(b, c) check flags and condition words (eval.py:380-463, 535-547).
__global__ void checks_kernel(const int32_t* __restrict__ plan, Blob bl,
                              const uint8_t* __restrict__ match_nv, int C,
                              int n_cond, const uint32_t* __restrict__ gate_open,
                              uint8_t* __restrict__ chk_flags,
                              uint32_t* __restrict__ cond_w) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)bl.B * C) return;
  const int b = (int)(t / C);
  const int c = (int)(t % C);
  const int32_t* ck = plan + plan[H_CHK] + (long long)c * CK_NCOLS;
  const int op = ck[CK_OP];
  const int gate = ck[CK_GATE];
  const int track = ck[CK_TRACK];
  const bool is_gate = ck[CK_IS_GATE] != 0;
  const bool is_cond = ck[CK_IS_COND] != 0;
  const int tr_bit = 1 << max(track, 0);
  const int tr_lo = max(track - 1, 0);
  const int tr_hi = max(track, 0);
  const int cond_bit = 1 << max(ck[CK_COND_DEPTH], 0);
  const uint32_t gword = gate >= 0 ? gate_open[(long long)gate * bl.B + b] : 0u;

  bool and_ok = true, or_ok = false, exist_all = true, valid_any = false;
  bool tr_reg = false, tr_pres = false, key_absent = false, brk = false;
  bool list_any = false;
  uint32_t okw = 0, kpw = 0, chw = 0;
  for (int e = 0; e < bl.E; ++e) {
    const Slot s = load_slot(bl, b, ck[CK_PATH], e);
    const SlotEval ev = eval_slot(ck, s, bl, match_nv);
    bool slot_ok = ev.slot_ok;
    if (gate >= 0 && s.elem0 >= 0) {
      const int e0 = min(max(s.elem0, 0), bl.E - 1);
      if (!((gword >> e0) & 1u)) slot_ok = true;   // gate closed: skip
    }
    and_ok = and_ok && (slot_ok || !s.valid);
    or_ok = or_ok || (slot_ok && s.valid && ev.leaf_present);
    const bool clean_miss =
        (ev.first_absent == tr_bit || ev.guard_pass) && !s.nbrk;
    exist_all = exist_all && (clean_miss || !s.valid);
    valid_any = valid_any || s.valid;
    if (is_cond) {
      if (ev.leaf_present && ev.value_ok) okw |= 1u << e;
      if ((s.mask & cond_bit) != 0 && s.valid) kpw |= 1u << e;
      const bool chain =
          (ev.first_absent != 0 && ev.first_absent < cond_bit &&
           !(ev.guard_pass && !s.nbrk) && s.valid) ||
          (s.nbrk && ev.first_absent == cond_bit && s.valid);
      if (chain) chw |= 1u << e;
    }
    const bool tr_parent = (s.mask >> tr_lo) & 1;
    const bool tr_present = (s.mask >> tr_hi) & 1;
    const bool break_at_tr = s.nbrk && ev.first_absent == tr_bit;
    tr_reg = tr_reg || (tr_parent && s.valid && !break_at_tr);
    tr_pres = tr_pres || (tr_present && s.valid);
    key_absent = key_absent || (!ev.leaf_present && s.valid && s.elem0 >= 0);
    brk = brk || (s.nbrk && s.valid);
    list_any = list_any || (s.type == T_LIST && ev.leaf_present && s.valid);
  }
  const bool check_ok =
      ck[CK_EXIST] ? (or_ok || (exist_all && valid_any)) : and_ok;
  const bool anchor_missing = track >= 0 && tr_reg && !tr_pres;
  const bool value_check = !(op == ABSENT || op == EXISTS_OBJECT ||
                             op == EXISTS_NONNIL || op == EXISTS_LIST);
  const bool unc = (is_gate && key_absent) || (value_check && list_any);
  const bool gate_struct = is_gate && brk;
  chk_flags[t] = (uint8_t)((check_ok ? CF_OK : 0) |
                           (anchor_missing ? CF_MISSING : 0) |
                           (unc ? CF_UNC : 0) | (gate_struct ? CF_STRUCT : 0));
  const int slot = ck[CK_COND_SLOT];
  if (slot >= 0) {
    uint32_t* w = cond_w + ((long long)b * n_cond + slot) * 3;
    w[0] = okw;
    w[1] = kpw;
    w[2] = chw;
  }
}

// 3. per-(b, x) aux row flags on slot 0 (eval.py:571-761).
__global__ void aux_kernel(const int32_t* __restrict__ plan, Blob bl,
                           const uint8_t* __restrict__ match_nv, int X,
                           uint8_t* __restrict__ aux_flags) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)bl.B * X) return;
  const int b = (int)(t / X);
  const int x = (int)(t % X);
  const int32_t* ax = plan + plan[H_AUX] + (long long)x * AX_NCOLS;
  const Slot s = load_slot(bl, b, ax[AX_PATH], 0);
  const int kind_id = (int)(bl.bmeta[b] & 0xFFFFu) - 1;

  const int leafb = 1 << ax[AX_PLEN];
  const int wantb = (leafb << 1) - 2;
  const bool presx = ((~s.mask) & wantb) == 0;
  const bool nullx = (presx && s.type == T_NULL) || (!presx && s.nbrk);
  const bool absx = !presx && !s.nbrk;
  const bool hasid = s.sid >= 0;
  const bool globx = hasid && ax[AX_HAS_NFA] &&
                     match_nv[(long long)ax[AX_NFA] * bl.V + s.sid];
  const bool keyglob =
      hasid && ((bl.dictv[(long long)s.sid * 5 + 4] >> 7) & 1u);
  const bool strk = s.type == T_STR, numk = s.type == T_NUM;
  const bool boolk = s.type == T_BOOL, listk = s.type == T_LIST;

  const int qh = ax[AX_Q_H], ql = ax[AX_Q_L], sh = ax[AX_S_H], sl = ax[AX_S_L];
  const bool n_lt_q = lex_lt(s.numh, s.numl, qh, ql);
  const bool n_gt_q = lex_lt(qh, ql, s.numh, s.numl);
  const bool n_eq_q = lex_eq(s.numh, s.numl, qh, ql);
  const bool n_lt_s = lex_lt(s.numh, s.numl, sh, sl);
  const bool n_gt_s = lex_lt(sh, sl, s.numh, s.numl);
  const bool d_lt_s = lex_lt(s.durh, s.durl, sh, sl);
  const bool d_gt_s = lex_lt(sh, sl, s.durh, s.durl);
  const bool d_eq_s = lex_eq(s.durh, s.durl, sh, sl);

  const bool o_str = ax[AX_IS_OSTR], o_num = ax[AX_IS_ONUM];
  const bool o_dur = ax[AX_IS_ODUR], o_float = ax[AX_IS_OFLOAT];
  const bool o_int = ax[AX_IS_OINT], o_quant = ax[AX_IS_OQUANT];
  const bool allow_num = ax[AX_ALLOW_NUM];
  const int op = ax[AX_OP];

  const bool dur_pair = s.durok && (o_dur || o_num);
  const bool ceq =
      (boolk && ax[AX_IS_OBOOL] && s.boolv == (ax[AX_OBOOL] != 0)) ||
      (numk && s.numok && o_quant && n_eq_q &&
       (o_num || (o_str && ((s.nint && o_int) || (!s.nint && o_float))))) ||
      (strk && ((dur_pair && d_eq_s) ||
                (!dur_pair && s.numok && o_str && o_quant && n_eq_q) ||
                (!dur_pair && !s.numok && o_str && globx)));
  auto rel4 = [op](int base, bool lt, bool gt) {
    return (op == base && gt) || (op == base + 1 && !lt) ||
           (op == base + 2 && lt) || (op == base + 3 && !gt);
  };
  const bool cmp_q = rel4(A_CGT, n_lt_q, n_gt_q);
  const bool cmp_ns = rel4(A_CGT, n_lt_s, n_gt_s);
  const bool cmp_ds = rel4(A_CGT, d_lt_s, d_gt_s);
  const bool numkey_cmp = (o_num && cmp_q) || (!o_num && o_str && o_dur && cmp_ns) ||
                          (!o_num && o_str && !o_dur && o_float && cmp_q);
  const bool cnum = (numk && numkey_cmp) || (strk && dur_pair && cmp_ds) ||
                    (strk && !dur_pair && s.nplain && numkey_cmp) ||
                    (strk && !dur_pair && !s.nplain && s.numok && o_str &&
                     o_quant && cmp_q);
  const bool dnum = rel4(A_DGT, n_lt_s, n_gt_s);
  const bool ddur = rel4(A_DGT, d_lt_s, d_gt_s);
  const bool cdur = (numk && dnum) || (strk && s.durany && ddur);
  const bool in_keyish = strk || (numk && allow_num && s.nint);
  const bool cin = in_keyish && globx;

  const bool op_val =
      op == A_TRUE ||
      (op == A_GLOB && (strk || (numk && s.nint)) && globx) ||
      (op == A_EXISTS && presx) || (op == A_NOT_EXISTS && !presx) ||
      (op == A_CEQ && ceq) ||
      ((op == A_CIN_ITEM || op == A_CIN_GLOB) && cin) ||
      (op >= A_CGT && op <= A_CLE && cnum) ||
      (op >= A_DGT && op <= A_DLE && cdur);

  const bool absres = ax[AX_ABSENT];
  const bool is_exist_op = op == A_EXISTS || op == A_NOT_EXISTS;
  const bool pres_nonnull = presx && s.type != T_NULL;
  const bool match_val = (is_exist_op && op_val) ||
                         (!is_exist_op && pres_nonnull && op_val) ||
                         (!is_exist_op && !pres_nonnull && absres);
  const bool cond_val =
      ax[AX_IS_DENY] ? (!nullx && ((presx && op_val) || (!presx && absres)))
                     : ((presx && !nullx && op_val) || ((!presx || nullx) && absres));
  const bool is_mk = ax[AX_IS_MK];
  const bool has_p = ax[AX_HAS_PATH];
  bool rowv = is_mk ? match_val : cond_val;
  rowv = has_p ? rowv : op_val;
  const bool kind_ok = ax[AX_KIND] < 0 || kind_id == ax[AX_KIND];
  rowv = rowv && kind_ok;

  const bool is_cinop = op == A_CIN_ITEM || op == A_CIN_GLOB;
  bool unc = is_cinop && (listk || s.type == T_OBJ || (ax[AX_NEGATED] && boolk) ||
                          (numk && allow_num && !s.nint) ||
                          (ax[AX_KEY_PAT] && strk && keyglob));
  unc = unc || (op == A_GLOB && presx &&
                !(strk || (numk && s.nint) || s.type == T_NULL));
  unc = unc && kind_ok;
  const bool errx = ax[AX_ERR] && (absx || nullx) && has_p;
  aux_flags[t] = (uint8_t)((rowv ? XF_ROW : 0) | (unc ? XF_UNC : 0) |
                           (errx ? XF_ERR : 0));
}

inline unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int ktpu_eval_checks(int64_t plan, int64_t blob, int64_t B,
                                int64_t P, int64_t E, int64_t V,
                                int64_t match_nv, int64_t C, int64_t X,
                                int64_t n_gates, int64_t n_cond,
                                int64_t gate_open,
                                int64_t chk_flags, int64_t cond_w,
                                int64_t aux_flags, int64_t stream) {
  const Blob bl = make_blob((const uint32_t*)blob, (int)B, (int)P, (int)E,
                            (int)V);
  const int32_t* pl = (const int32_t*)plan;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)match_nv;
  if (n_gates > 0 && C > 0)
    gate_kernel<<<blocks(n_gates * B), kThreads, 0, st>>>(
        pl, bl, m, (int)n_gates, (uint32_t*)gate_open);
  if (C > 0)
    checks_kernel<<<blocks(B * C), kThreads, 0, st>>>(
        pl, bl, m, (int)C, (int)n_cond, (const uint32_t*)gate_open,
        (uint8_t*)chk_flags, (uint32_t*)cond_w);
  if (X > 0)
    aux_kernel<<<blocks(B * X), kThreads, 0, st>>>(pl, bl, m, (int)X,
                                                   (uint8_t*)aux_flags);
  return (int)cudaGetLastError();
}
