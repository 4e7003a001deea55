// K4 — group / alternative / rule reductions, the aux programs and the
// verdict composition: int8 verdicts [B, R].
//
// Replaces stages 4-6 of kyverno_tpu/ops/eval.py::build_eval_fn's evaluate
// (eval.py:465-863), including the no-check branch (eval.py:559-567) and
// the no-aux branch (eval.py:815-821). XLA ran these as segment_max /
// segment_min scatters over static id maps.
//
// Bound on the H100: bytes. A (b, r) pair reads the flag bytes of the
// rule's check rows and aux rows (each row belongs to one rule, so the
// flags are read once in all), the condition words of its condition rows
// and one bmeta word; it writes one byte. The arithmetic is a handful of
// boolean operations per row.
//
// Design: one thread per (b, r) walks the rule's CSR lists from the plan
// (plan.cuh): rule -> alternatives -> groups -> rows for the pattern
// verdict, rule -> filters -> aux groups -> aux rows for match/exclude and
// rule -> aux groups -> aux rows for preconditions, deny and the host-lane
// flags. Every OR starts from false and every AND from true, which are
// the identities of the TPU program's empty segment_max / segment_min; a
// rule without alternatives starts from INT_MIN, as its segment_max did,
// and stage 6 overwrites it as the TPU program does. Neighbouring threads
// take neighbouring r of one resource, so the writes coalesce.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "plan.cuh"

using namespace ktpu;

namespace {

constexpr int kThreads = 256;

// XOR-negated OR over the rows of aux group g (eval.py:765-767)
__device__ inline bool aux_group(const int32_t* __restrict__ plan, int g,
                                 const uint8_t* __restrict__ aflags) {
  const int32_t* axg_ptr = plan + plan[H_AXG_PTR];
  const int32_t* axg_row = plan + plan[H_AXG_ROW];
  bool any = false;
  for (int i = axg_ptr[g]; i < axg_ptr[g + 1]; ++i)
    any = any || (aflags[axg_row[i]] & XF_ROW);
  const bool neg = plan[plan[H_AXG_INFO] + g] & AG_NEGATE;
  return neg != any;
}

__global__ void verdict_kernel(const int32_t* __restrict__ plan, Blob bl,
                               const uint8_t* __restrict__ chk_flags,
                               const uint32_t* __restrict__ cond_w,
                               const uint8_t* __restrict__ aux_flags, int C,
                               int X, int R, int8_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)bl.B * R) return;
  const int b = (int)(t / R);
  const int r = (int)(t % R);
  const int n_cond = plan[H_NCOND];
  const int32_t* chk = plan + plan[H_CHK];
  const int rflags = plan[plan[H_RULE_FLAGS] + r];
  const bool covered = rflags & RF_COVERED;
  const bool host = rflags & RF_HOST;
  const bool deny = rflags & RF_DENY;

  // ---- stage 4: pattern verdict
  int verdict;
  if (C > 0) {
    const int32_t* rule_ptr = plan + plan[H_RULE_PTR];
    const int32_t* rule_alt = plan + plan[H_RULE_ALT];
    const int32_t* alt_ptr = plan + plan[H_ALT_PTR];
    const int32_t* alt_grp = plan + plan[H_ALT_GRP];
    const int32_t* alt_multi = plan + plan[H_ALT_MULTI];
    const int32_t* grp_ptr = plan + plan[H_GRP_PTR];
    const int32_t* grp_row = plan + plan[H_GRP_ROW];
    const uint8_t* cf = chk_flags + (long long)b * C;
    bool rule_pass = false, multi = false, unc = false, st = false;
    int single = INT_MIN;
    for (int ai = rule_ptr[r]; ai < rule_ptr[r + 1]; ++ai) {
      const int a = rule_alt[ai];
      bool alt_ok = true, alt_skip = false, alt_chain = false;
      bool alt_missing = false;
      for (int gi = alt_ptr[a]; gi < alt_ptr[a + 1]; ++gi) {
        const int g = alt_grp[gi];
        bool g_or = false, has_plain = false;
        uint32_t ok = 0, kp = 0, ch = 0;
        for (int ri = grp_ptr[g]; ri < grp_ptr[g + 1]; ++ri) {
          const int c = grp_row[ri];
          const int32_t* ck = chk + (long long)c * CK_NCOLS;
          const int f = cf[c];
          const bool is_gate = ck[CK_IS_GATE], is_cond = ck[CK_IS_COND];
          if (!is_gate && !is_cond) {
            has_plain = true;
            g_or = g_or || (f & CF_OK);
          }
          if (is_cond) {
            const uint32_t* w =
                cond_w + ((long long)b * n_cond + ck[CK_COND_SLOT]) * 3;
            ok |= w[0];
            kp |= w[1];
            ch |= w[2];
          }
          if (ck[CK_TRACK] >= 0 && (f & CF_MISSING)) alt_missing = true;
          unc = unc || (f & CF_UNC);
          st = st || (f & CF_STRUCT);
        }
        alt_ok = alt_ok && (g_or || !has_plain);
        alt_skip = alt_skip || ((kp & ~ok) != 0);
        alt_chain = alt_chain || (ch != 0);
      }
      alt_ok = alt_ok && !alt_chain;
      const bool is_multi = alt_multi[a] != 0;
      const bool ambig = alt_skip && !alt_ok && !is_multi;
      const int av = ambig ? V_HOST
                     : alt_skip ? V_SKIP
                     : alt_ok ? V_PASS
                     : alt_missing ? V_HOST : V_FAIL;
      rule_pass = rule_pass || av == V_PASS;
      single = max(single, is_multi ? 0 : av);
      multi = multi || is_multi;
    }
    verdict = multi ? (rule_pass ? V_PASS : V_FAIL) : single;
    if (unc && (verdict == V_FAIL || verdict == V_ERROR || verdict == V_SKIP))
      verdict = V_HOST;
    if (st) verdict = V_HOST;
  } else {
    verdict = covered ? V_PASS : V_NA;
  }

  // ---- stage 5: aux programs
  const int kind_id = (int)(bl.bmeta[b] & 0xFFFFu) - 1;
  bool applicable = true, precond_ok = true, deny_match = false;
  bool deny_err = false, match_unc = false, cond_unc = false;
  if (X > 0) {
    const uint8_t* af = aux_flags + (long long)b * X;
    const int32_t* rf_ptr = plan + plan[H_RF_PTR];
    const int32_t* rf_filt = plan + plan[H_RF_FILT];
    const int32_t* fg_ptr = plan + plan[H_FG_PTR];
    const int32_t* fg_grp = plan + plan[H_FG_GRP];
    const int32_t* filt_ex = plan + plan[H_FILT_EX];
    bool m_or = false, m_and = true, e_or = false, e_and = true;
    for (int fi = rf_ptr[r]; fi < rf_ptr[r + 1]; ++fi) {
      const int f = rf_filt[fi];
      bool fok = true;
      for (int gi = fg_ptr[f]; gi < fg_ptr[f + 1]; ++gi)
        fok = fok && aux_group(plan, fg_grp[gi], af);
      if (filt_ex[f]) {
        e_or = e_or || fok;
        e_and = e_and && fok;
      } else {
        m_or = m_or || fok;
        m_and = m_and && fok;
      }
    }
    const bool match_ok =
        ((rflags & RF_MATCH_ANY) ? m_or : m_and) || !(rflags & RF_HAS_MATCH);
    const bool exclude_hit =
        ((rflags & RF_EXCLUDE_ALL) ? e_and : e_or) && (rflags & RF_HAS_EXCLUDE);
    applicable = match_ok && !exclude_hit;

    const int32_t* raxg_ptr = plan + plan[H_RAXG_PTR];
    const int32_t* raxg_grp = plan + plan[H_RAXG_GRP];
    const int32_t* axg_ptr = plan + plan[H_AXG_PTR];
    const int32_t* axg_row = plan + plan[H_AXG_ROW];
    const int32_t* axg_info = plan + plan[H_AXG_INFO];
    const int32_t* aux = plan + plan[H_AUX];
    bool pre_all = true, pre_any = false, den_all = true, den_any = false;
    for (int gi = raxg_ptr[r]; gi < raxg_ptr[r + 1]; ++gi) {
      const int g = raxg_grp[gi];
      for (int i = axg_ptr[g]; i < axg_ptr[g + 1]; ++i) {
        const int x = axg_row[i];
        const int f = af[x];
        if (f & XF_UNC) {
          if (aux[(long long)x * AX_NCOLS + AX_IS_MK]) match_unc = true;
          else cond_unc = true;
        }
        if (f & XF_ERR) deny_err = true;
      }
      const int info = axg_info[g];
      const int klass = info >> AG_KLASS_SHIFT;
      if (klass != AUX_PRECOND && klass != AUX_DENY) continue;
      const bool gv = aux_group(plan, g, af);
      const bool any_blk = info & AG_ANY;
      if (klass == AUX_PRECOND) {
        if (any_blk) pre_any = pre_any || gv; else pre_all = pre_all && gv;
      } else {
        if (any_blk) den_any = den_any || gv; else den_all = den_all && gv;
      }
    }
    precond_ok = pre_all && (pre_any || !(rflags & RF_PRECOND_ANY));
    deny_match = den_all && (den_any || !(rflags & RF_DENY_ANY));
  }

  // ---- stage 6: composition, in the TPU program's order (eval.py:823-856)
  const int deny_v = deny_err ? V_ERROR : (deny_match ? V_FAIL : V_PASS);
  if (deny) verdict = deny_v;
  if (!covered && !host && !deny) verdict = V_NA;
  if (!precond_ok) verdict = V_SKIP;
  if (cond_unc && !host) verdict = V_HOST;
  if (!(applicable || host)) verdict = V_NA;
  if (match_unc && !host) verdict = V_HOST;
  if (host) verdict = V_HOST;
  const int kmax = plan[H_KMAX];
  const int32_t* kinds = plan + plan[H_RULE_KINDS] + (long long)r * kmax;
  bool kind_hit = false;
  for (int k = 0; k < kmax; ++k) kind_hit = kind_hit || kinds[k] == kind_id;
  if (host && !(kind_hit || (rflags & RF_ALL_KINDS))) verdict = V_NA;
  const uint32_t bm = bl.bmeta[b];
  if ((bm >> 16) & 1u) verdict = V_HOST;
  if (!((bm >> 17) & 1u)) verdict = V_NA;
  out[t] = (int8_t)verdict;
}

}  // namespace

extern "C" int ktpu_eval_verdict(int64_t plan, int64_t blob, int64_t B,
                                 int64_t P, int64_t E, int64_t V,
                                 int64_t chk_flags, int64_t cond_w,
                                 int64_t aux_flags, int64_t C, int64_t X,
                                 int64_t R, int64_t out, int64_t stream) {
  const Blob bl = make_blob((const uint32_t*)blob, (int)B, (int)P, (int)E,
                            (int)V);
  const long long n = B * R;
  verdict_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(
      (const int32_t*)plan, bl, (const uint8_t*)chk_flags,
      (const uint32_t*)cond_w, (const uint8_t*)aux_flags, (int)C, (int)X,
      (int)R, (int8_t*)out);
  return (int)cudaGetLastError();
}
