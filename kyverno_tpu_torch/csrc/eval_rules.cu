// eval_rules — stages 2-6 of the verdict program in one launch: from the
// packed blob and K1's glob matrix to the int8 verdicts [B, R].
//
// Replaces stages 2-6 of the JAX package's ops/eval.py::build_eval_fn evaluate
// (eval.py:205-863): the per-check slot gather, gates and element
// reduction (:219-463), the group / alternative / rule reduction
// (:465-567), the aux programs (:569-821) and the verdict composition
// (:823-863), with the no-check and no-aux branches; and the blob decode
// of eval.py:905 _split_blob and models/flatten.py:280 unpack_batch
// (xp=jnp), which XLA fused into them.
//
// Bound on the H100: the larger of two terms (chip_smoke.py
// eval_rules_bytes, eval_rules_ops). Bytes: the blob's cells and bmeta,
// the 20-byte dictionary rows, the [N, V] glob matrix and the plan read
// once, one byte per (b, r) written. Integer operations: a few dozen per
// (resource, distinct check row, slot) and per (resource, distinct aux
// row), a few per (32 resources, list entry) and per (resource, rule).
// On the 250-policy library bytes bound it; on the autogen'd 670-column
// plan, operations. Timed by phase (clock64 on a scratch copy, PERF.md
// §6), the design before this one spent 62-72% of a block's cycles on
// check rows, staged its tile's section once per 16-32 resources, and
// walked each rule once per 16-32 resources with one thread, whose
// host-only rules looped over the resources serially. This design:
//
//  - Distinct rows: ops/plan.py keeps each distinct check and aux row of
//    a tile once and every list names it (the library's 248 check rows
//    are 6 distinct ones, its 248 aux rows 3), so a group evaluates each
//    once.
//  - A block stages its tile's section in shared memory once (one
//    thread's cp.async.bulk, completion counted on an mbarrier, while the
//    block decodes its first group) and walks the groups blockIdx.x,
//    blockIdx.x + gridDim.x, ... The blocks are persistent, as many as
//    the SMs hold at once, where the plan is one tile; with several tiles
//    a block takes one group and tile, and the card's block scheduler
//    balances tiles whose work differs. The grid is fixed at launch and
//    nothing counts work across blocks, so a CUDA graph (K6) replays it
//    as it is.
//  - Groups of up to 128 resources: a mask is K = 1, 2 or 4 words of 32
//    resources. Phases 2-3 take (row, word) tasks, TB lanes a task (TB =
//    32 where K > 1), so a warp's lanes run one row (its operator's value
//    test alone, what the row does not use skipped) and its ballots give
//    the word's masks. Phase 4 walks each rule once for all K words
//    (Mask<K>): the walk's loads and branches serve up to 128 resources.
//  - Decode once a group: every (path, e, resource) slot the tile reads
//    is decoded into shared memory, structure of arrays with the
//    resource fastest; rows read slots from there, not the blob.
//  - Flat lists: the plan flattens each rule's rule -> alternatives ->
//    groups -> rows and rule -> filters -> aux groups nests into one list
//    of entries each, with end-of-group / -alternative / -filter bits, so
//    a verdict is two flat walks over shared memory.
//  - Host-only rules' kind prefilter in parallel: a warp takes 32 rules
//    at a time and each host-only one among them for all the group's
//    resources, a resource a lane, one ballot a word.
//  - The verdict leaves from registers: the rule's thread writes its
//    column of the group from its three planes, and a warp's stores are
//    one resource's 32 consecutive rules.
//
// Phases of a group, a barrier after each of the first three:
//   1. decode the slots and bmeta (and, the first time, wait for the
//      section)
//   2. gates: one E-bit word per (gate, resource), open where the
//      element's gate rows pass (eval.py:360-389)
//   3. check rows and aux rows: flags per (row, resource), gathered into
//      masks; a condition row also gives three E-bit words a resource,
//      kept as one mask per (word, element) (eval.py:390-463, 535-547,
//      571-761); the host-only rules' kind masks; the group's HOST and
//      live words
//   4. verdicts: one thread per rule walks its two entry lists from the
//      identities of the empty OR / AND (a rule without alternatives keeps
//      the INT_MIN of its segment_max, which stage 6 always overwrites),
//      composes stage 6 in the TPU program's order, and writes its output
//
// The scan form (rules_kernel<true, K>, entry ktpu_eval_rules_scan)
// replaces the verdicts of build_scan_fn_blob's program (eval.py:962-966),
// whose reduction XLA fused after them so that the matrix never left the
// chip. Phases 1-3 are the same; phase 4 writes, from each rule's planes
// in registers, bit masks instead of verdict bytes:
//   fail_m[g, r] (code 2: p1 & ~p0 & ~p2) and pass_m[g, r] (code 1:
//   p0 & ~p1 & ~p2), uint32 [G, R], rule fastest so that the stores of a
//   warp's rules coalesce; host_m[t, g] (code 5: p0 & ~p1 & p2), uint32
//   [n_tiles, G], the OR over rule tile t's rules. G = ceil(B / 32): word
//   g holds resources 32g .. 32g+31 at bit b % 32, whatever group size the
//   launch chose, and each mask is cut to the group's nb live resources.
// A group of 32 or more resources owns whole words and stores them; of 8
// or 16, whole bytes (the last group of the batch also stores the zero
// bytes after the batch's end); below 8, groups share a byte, so the
// entry zeroes the masks with one memset and blocks atomicOr their bits
// in. K5 (scan_counts.cu) reduces the masks to the counts.
//
// The counts form (the matrix form with a counts buffer, entry
// ktpu_eval_rules_counts) is K7's program, the mesh scan's: it writes the
// verdicts as the matrix form does and, from the same planes in registers,
// per-rule FAIL and PASS counts over every resource of the batch, HOST
// rows included, for the rules below `live`. It replaces the count tail
// of the JAX package's parallel/mesh.py::sharded_eval_fn (mesh.py:197-198)
// and of shard_eval_fns' programs (mesh.py:247-248), jnp.sum(verdict ==
// V_FAIL, axis=0) and the same for V_PASS, which XLA fused behind the
// verdict program. In phase 4 the thread that owns a rule counts its
// group's FAIL (code 2) and PASS (code 1) bits, cut to the nb live
// resources, and adds each nonzero count to the output with one integer
// atomicAdd a (group, rule), exact in any order. The counts cost no second
// read of the [B, live] matrix and no launch; padded rows read
// NOT_APPLICABLE and count as nothing, as in the JAX sum. The entry zeroes
// the [2, live] counts with one memset before the launch.
//
// The group size is chosen at launch (choose_gs): 128 or 64 where the
// batch's groups fill the card's resident blocks, else 32, 16 or 8 where
// they give every SM a block, else 8, and smaller only where 8 does not
// fit (an E above the flattener's 16). Each block lays out its shared
// memory for its own tile (layout() in plan.cuh: the section, the slots,
// the flags, the kind masks), and the launch asks for the largest tile's.
// ops/plan.py cuts the tiles so that each fits at 8 resources with the
// flattener's 16 slots a path, and at one resource with 32. The launch
// bound holds the one-word instances to 80 registers, so that three blocks
// of 256 threads share an SM where their shared memory allows; the K = 2
// and 4 instances take up to 128 and two blocks an SM.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "plan.cuh"

using namespace ktpu;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTB = 32;    // a mask word's resources: the lanes of a task
// A bulk copy that has not landed after this long traps the kernel (a
// launch error) instead of hanging the card.
constexpr unsigned long long kStageTimeoutNs = 2000000000ull;

// decoded slot lanes in shared memory
enum SlotLane {
  L_META = 0, L_SID = 1, L_BITS = 2, L_NUMH = 3, L_NUML = 4, L_DURH = 5,
  L_DURL = 6, L_NLANES = 7,
};
enum SlotBit {
  SB_VALID = 1, SB_NBRK = 2, SB_NINT = 4, SB_NUMOK = 8, SB_NPLAIN = 16,
  SB_DUROK = 32, SB_DURANY = 64, SB_BOOLV = 128, SB_EMPTY = 256,
  SB_KEYGLOB = 512,
};

static_assert((int)L_NLANES == (int)SM_SLOT_LANES,
              "plan.cuh layout(): slot lanes");

// One row of a column-major table in shared memory.
struct Row {
  const int32_t* p;
  int stride;
  __device__ int operator[](int col) const { return p[col * stride]; }
};

// The group's decoded slots: lane k of (local path lp, element e,
// resource bi of the group) at lanes[k * n + (lp * E + e) * GS + bi]. A
// row reads the lanes it needs: mask, type, element and string id and the
// bits always, the numbers and durations only where its operator compares
// them.
struct Slots {
  uint32_t* lanes;
  int n, E, GS;

  __device__ void put(int i, const Slot& s) const {
    lanes[L_META * n + i] = (uint32_t)s.mask | ((uint32_t)s.type << 16) |
                            ((uint32_t)(s.elem0 + 1) << 19);
    lanes[L_SID * n + i] = (uint32_t)s.sid;
    lanes[L_BITS * n + i] =
        (s.valid ? SB_VALID : 0) | (s.nbrk ? SB_NBRK : 0) |
        (s.nint ? SB_NINT : 0) | (s.numok ? SB_NUMOK : 0) |
        (s.nplain ? SB_NPLAIN : 0) | (s.durok ? SB_DUROK : 0) |
        (s.durany ? SB_DURANY : 0) | (s.boolv ? SB_BOOLV : 0) |
        (s.empty ? SB_EMPTY : 0) | (s.keyglob ? SB_KEYGLOB : 0);
    lanes[L_NUMH * n + i] = (uint32_t)s.numh;
    lanes[L_NUML * n + i] = (uint32_t)s.numl;
    lanes[L_DURH * n + i] = (uint32_t)s.durh;
    lanes[L_DURL * n + i] = (uint32_t)s.durl;
  }

  __device__ int at(int lp, int e, int bi) const {
    return (lp * E + e) * GS + bi;
  }
  __device__ int lane(int k, int i) const { return (int)lanes[k * n + i]; }
};

// ---- the bulk copy of a section into shared memory

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// bytes: a multiple of 16, both addresses 16-byte aligned
__device__ inline void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ inline unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the single phase (parity 0) of a barrier used once
__device__ inline void barrier_wait(uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  const unsigned long long t0 = global_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(0u) : "memory");
    if (done) return;
    if (global_ns() - t0 > kStageTimeoutNs) __trap();
  }
}

// ---- the tile's section in shared memory: counts and array bases, read
// into registers once per thread after the copy lands

struct Sec {
  int C, X, R, ngates;
  const int32_t *chk, *aux, *gate_ptr, *gate_grp, *grp_ptr, *grp_row,
      *pat_ptr, *pat, *rule_flags, *rule_kinds, *auxp_ptr, *auxp, *axg_ptr,
      *axg_row, *axg_info;
};

__device__ inline Sec section(const int32_t* s) {
  Sec v;
  v.C = s[TS_C];
  v.X = s[TS_X];
  v.R = s[TS_R];
  v.ngates = s[TS_NGATES];
  v.chk = s + s[TS_CHK];
  v.aux = s + s[TS_AUX];
  v.gate_ptr = s + s[TS_GATE_PTR];
  v.gate_grp = s + s[TS_GATE_GRP];
  v.grp_ptr = s + s[TS_GRP_PTR];
  v.grp_row = s + s[TS_GRP_ROW];
  v.pat_ptr = s + s[TS_PAT_PTR];
  v.pat = s + s[TS_PAT];
  v.rule_flags = s + s[TS_RULE_FLAGS];
  v.rule_kinds = s + s[TS_RULE_KINDS];
  v.auxp_ptr = s + s[TS_AUXP_PTR];
  v.auxp = s + s[TS_AUXP];
  v.axg_ptr = s + s[TS_AXG_PTR];
  v.axg_row = s + s[TS_AXG_ROW];
  v.axg_info = s + s[TS_AXG_INFO];
  return v;
}

// The lanes of one decoded slot that every row reads.
struct SlotCore {
  int i, mask, type, elem0, sid;
  uint32_t bits;
  __device__ bool has(uint32_t b) const { return (bits & b) != 0; }
};

__device__ inline SlotCore slot_core(const Slots& sl, int i) {
  SlotCore c;
  const uint32_t meta = (uint32_t)sl.lane(L_META, i);
  c.i = i;
  c.mask = (int)(meta & 0xFFFFu);
  c.type = (int)((meta >> 16) & 7u);
  c.elem0 = (int)((meta >> 19) & 0xFFu) - 1;
  c.sid = sl.lane(L_SID, i);
  c.bits = (uint32_t)sl.lane(L_BITS, i);
  return c;
}

// ---- stage 2 for one (check row, slot): eval.py:239-358. The value test
// is computed for the row's operator alone; the operator is the same in
// every lane of a warp when a group takes 32 or more resources.

struct SlotEval {
  bool leaf_present, value_ok, slot_ok, guard_pass;
  int first_absent;
};

__device__ inline SlotEval eval_slot(const Row& ck, int op, const SlotCore& s,
                                     const Slots& sl, int V,
                                     const uint8_t* __restrict__ match_nv) {
  const int guard = ck[CK_GUARD];
  const int leaf_bit = 1 << ck[CK_PLEN];
  const int absent_bits = (~s.mask) & ((leaf_bit << 1) - 2);
  const int first_absent = absent_bits & (-absent_bits);
  const bool leaf_present = absent_bits == 0;
  const bool guard_pass = (first_absent & guard) != 0;
  const bool nbrk = s.has(SB_NBRK);
  const bool nil_like = s.type == T_NULL || (!leaf_present && !nbrk);
  const bool numok = s.has(SB_NUMOK);
  const bool numok_n = numok || nil_like;

  bool value_ok = false, eval_on_nil = false;
  switch (op) {
    case STR_EQ:
    case STR_NE:
      if (ck[CK_NUMFB]) {
        const bool eq = lex_eq(sl.lane(L_NUMH, s.i), sl.lane(L_NUML, s.i),
                               ck[CK_LO_H], ck[CK_LO_L]);
        value_ok = numok_n && (op == STR_EQ ? eq : !eq);
        eval_on_nil = true;
      } else {
        const bool stringy =
            s.type == T_STR || s.type == T_BOOL || s.type == T_NUM;
        const bool hit = s.sid >= 0 && ck[CK_HAS_NFA] &&
                         match_nv[(long long)ck[CK_NFA] * V + s.sid];
        value_ok = stringy && (op == STR_EQ ? hit : !hit);
      }
      break;
    case NUM_EQ:
    case NUM_NE: {
      const bool lit = ck[CK_NUMMODE] == 1 ? s.has(SB_NINT) : s.has(SB_NPLAIN);
      const bool ok = numok && (s.type == T_NUM || (s.type == T_STR && lit));
      const bool eq = lex_eq(sl.lane(L_NUMH, s.i), sl.lane(L_NUML, s.i),
                             ck[CK_LO_H], ck[CK_LO_L]);
      value_ok = ok && (op == NUM_EQ ? eq : !eq);
      break;
    }
    case NUM_GT:
    case NUM_GE:
    case NUM_LT:
    case NUM_LE:
    case NUM_IN_RANGE:
    case NUM_NOT_IN_RANGE: {
      const int nh = sl.lane(L_NUMH, s.i), nl = sl.lane(L_NUML, s.i);
      const int lo_h = ck[CK_LO_H], lo_l = ck[CK_LO_L];
      const bool lt_lo = lex_lt(nh, nl, lo_h, lo_l);
      const bool gt_lo = lex_lt(lo_h, lo_l, nh, nl);
      bool r;
      if (op == NUM_GT) r = gt_lo;
      else if (op == NUM_GE) r = !lt_lo;
      else if (op == NUM_LT) r = lt_lo;
      else if (op == NUM_LE) r = !gt_lo;
      else {
        const bool in = !lt_lo && !lex_lt(ck[CK_HI_H], ck[CK_HI_L], nh, nl);
        r = op == NUM_IN_RANGE ? in : !in;
      }
      value_ok = numok_n && r;
      eval_on_nil = true;
      break;
    }
    case BOOL_EQ:
      value_ok = s.type == T_BOOL && s.has(SB_BOOLV) == (ck[CK_BOOL] != 0);
      break;
    case IS_NULL: {
      const bool zero = s.type == T_NUM && numok &&
                        sl.lane(L_NUMH, s.i) == 0 && sl.lane(L_NUML, s.i) == 0;
      value_ok = nil_like || (s.type == T_BOOL && !s.has(SB_BOOLV)) || zero ||
                 (s.type == T_STR && s.has(SB_EMPTY));
      eval_on_nil = true;
      break;
    }
    case EXISTS_OBJECT: value_ok = s.type == T_OBJ; break;
    case EXISTS_NONNIL: value_ok = leaf_present && s.type != T_NULL; break;
    case EXISTS_LIST: value_ok = s.type == T_LIST; break;
    case ABSENT: value_ok = true; break;
    default: break;
  }

  bool slot_ok;
  if (op == ABSENT) {
    slot_ok = !leaf_present && !nbrk &&
              ((first_absent & (guard | leaf_bit)) != 0);
  } else {
    const bool nil_leaf = !leaf_present && !nbrk && !guard_pass &&
                          first_absent == leaf_bit;
    slot_ok = (leaf_present || (nil_leaf && eval_on_nil))
                  ? value_ok : (guard_pass && !nbrk);
  }
  SlotEval r;
  r.leaf_present = leaf_present;
  r.value_ok = value_ok;
  r.slot_ok = slot_ok;
  r.guard_pass = guard_pass;
  r.first_absent = first_absent;
  return r;
}

// ---- phase 2: gate_open word of (gate, bi), eval.py:365-378. An absent
// key or an invalid slot keeps it open; AND over no groups is open.
__device__ inline uint32_t gate_word(const Sec& S, int gate, int bi,
                                     const Slots& sl, int V,
                                     const uint8_t* __restrict__ match_nv) {
  uint32_t word = 0xFFFFFFFFu;
  for (int gi = S.gate_ptr[gate]; gi < S.gate_ptr[gate + 1]; ++gi) {
    const int g = S.gate_grp[gi];
    uint32_t gw = 0;                           // OR over no rows: closed
    for (int ri = S.grp_ptr[g]; ri < S.grp_ptr[g + 1]; ++ri) {
      const Row ck{S.chk + S.grp_row[ri], S.C};
      if (!ck[CK_IS_GATE]) continue;
      const int op = ck[CK_OP], path = ck[CK_PATH];
      for (int e = 0; e < sl.E; ++e) {
        const SlotCore s = slot_core(sl, sl.at(path, e, bi));
        const SlotEval ev = eval_slot(ck, op, s, sl, V, match_nv);
        if (!ev.leaf_present || ev.value_ok || !s.has(SB_VALID)) gw |= 1u << e;
      }
    }
    word &= gw;
  }
  return word;
}

// ---- phase 3a: the flags of (check row c, bi) and, for a condition row,
// its three E-bit words (eval.py:380-463, 535-547). What a row does not
// use (existence, anchor tracking, condition words, gate structure) is
// skipped by a branch on the row, the same in every lane of its group.
constexpr uint32_t kCondRow = 16;   // beside the CF_ bits: a condition row

__device__ inline uint32_t check_row(const Sec& S, int c, int bi, int GS,
                                     const Slots& sl, int V,
                                     const uint8_t* __restrict__ match_nv,
                                     const uint32_t* sgate, uint32_t* words) {
  const Row ck{S.chk + c, S.C};
  const int E = sl.E;
  const int op = ck[CK_OP];
  const int path = ck[CK_PATH];
  const int gate = ck[CK_GATE];
  const int track = ck[CK_TRACK];
  const bool is_gate = ck[CK_IS_GATE] != 0;
  const bool is_cond = ck[CK_IS_COND] != 0;
  const bool exist = ck[CK_EXIST] != 0;
  const bool value_check = !(op == ABSENT || op == EXISTS_OBJECT ||
                             op == EXISTS_NONNIL || op == EXISTS_LIST);
  const int tr_bit = 1 << max(track, 0);
  const int tr_lo = max(track - 1, 0);
  const int tr_hi = max(track, 0);
  const int cond_bit = is_cond ? 1 << max(ck[CK_COND_DEPTH], 0) : 0;
  const uint32_t gword = gate >= 0 ? sgate[gate * GS + bi] : 0u;

  bool and_ok = true, or_ok = false, exist_all = true, valid_any = false;
  bool tr_reg = false, tr_pres = false, key_absent = false, brk = false;
  bool list_any = false;
  uint32_t okw = 0, kpw = 0, chw = 0;
  for (int e = 0; e < E; ++e) {
    const SlotCore s = slot_core(sl, sl.at(path, e, bi));
    const SlotEval ev = eval_slot(ck, op, s, sl, V, match_nv);
    const bool valid = s.has(SB_VALID), nbrk = s.has(SB_NBRK);
    bool slot_ok = ev.slot_ok;
    if (gate >= 0 && s.elem0 >= 0) {
      const int e0 = min(s.elem0, E - 1);
      if (!((gword >> e0) & 1u)) slot_ok = true;   // gate closed: skip
    }
    and_ok = and_ok && (slot_ok || !valid);
    or_ok = or_ok || (slot_ok && valid && ev.leaf_present);
    if (exist) {
      const bool clean_miss =
          (ev.first_absent == tr_bit || ev.guard_pass) && !nbrk;
      exist_all = exist_all && (clean_miss || !valid);
      valid_any = valid_any || valid;
    }
    if (is_cond) {
      if (ev.leaf_present && ev.value_ok) okw |= 1u << e;
      if ((s.mask & cond_bit) != 0 && valid) kpw |= 1u << e;
      const bool chain =
          (ev.first_absent != 0 && ev.first_absent < cond_bit &&
           !(ev.guard_pass && !nbrk) && valid) ||
          (nbrk && ev.first_absent == cond_bit && valid);
      if (chain) chw |= 1u << e;
    }
    if (track >= 0) {
      const bool break_at_tr = nbrk && ev.first_absent == tr_bit;
      tr_reg = tr_reg || (((s.mask >> tr_lo) & 1) && valid && !break_at_tr);
      tr_pres = tr_pres || (((s.mask >> tr_hi) & 1) && valid);
    }
    if (is_gate) {
      key_absent = key_absent || (!ev.leaf_present && valid && s.elem0 >= 0);
      brk = brk || (nbrk && valid);
    }
    if (value_check)
      list_any = list_any || (s.type == T_LIST && ev.leaf_present && valid);
  }
  const bool check_ok = exist ? (or_ok || (exist_all && valid_any)) : and_ok;
  const bool anchor_missing = track >= 0 && tr_reg && !tr_pres;
  const bool unc = (is_gate && key_absent) || list_any;
  const bool gate_struct = is_gate && brk;
  words[0] = okw;
  words[1] = kpw;
  words[2] = chw;
  return (check_ok ? CF_OK : 0u) | (anchor_missing ? CF_MISSING : 0u) |
         (unc ? CF_UNC : 0u) | (gate_struct ? CF_STRUCT : 0u) |
         (is_cond ? kCondRow : 0u);
}

// rel4 of eval.py: the four relations GT, GE, LT, LE from base
__device__ inline bool rel4(int op, int base, bool lt, bool gt) {
  return (op == base && gt) || (op == base + 1 && !lt) ||
         (op == base + 2 && lt) || (op == base + 3 && !gt);
}

// ---- phase 3b: the flags of (aux row x, bi) on slot 0 (eval.py:571-761).
// A row with no path and a constant operator reads no slot.
__device__ inline uint8_t aux_row(const Sec& S, int x, int bi, uint32_t bmeta,
                                  const Slots& sl, int V,
                                  const uint8_t* __restrict__ match_nv) {
  const Row ax{S.aux + x, S.X};
  const int op = ax[AX_OP];
  const int kind = ax[AX_KIND];
  const bool kind_ok = kind < 0 || (int)(bmeta & 0xFFFFu) - 1 == kind;
  const bool has_p = ax[AX_HAS_PATH] != 0;
  if (!has_p && (op == A_TRUE || op == A_FALSE))
    return (op == A_TRUE && kind_ok) ? XF_ROW : 0;

  const SlotCore s = slot_core(sl, sl.at(ax[AX_PATH], 0, bi));
  const int leafb = 1 << ax[AX_PLEN];
  const bool nbrk = s.has(SB_NBRK), nint = s.has(SB_NINT);
  const bool presx = ((~s.mask) & ((leafb << 1) - 2)) == 0;
  const bool nullx = (presx && s.type == T_NULL) || (!presx && nbrk);
  const bool absx = !presx && !nbrk;
  const bool strk = s.type == T_STR, numk = s.type == T_NUM;
  const bool boolk = s.type == T_BOOL;
  auto globx = [&]() {
    return s.sid >= 0 && ax[AX_HAS_NFA] &&
           match_nv[(long long)ax[AX_NFA] * V + s.sid];
  };

  bool op_val = false;
  switch (op) {
    case A_TRUE: op_val = true; break;
    case A_GLOB: op_val = (strk || (numk && nint)) && globx(); break;
    case A_EXISTS: op_val = presx; break;
    case A_NOT_EXISTS: op_val = !presx; break;
    case A_CIN_ITEM:
    case A_CIN_GLOB:
      op_val = (strk || (numk && ax[AX_ALLOW_NUM] && nint)) && globx();
      break;
    case A_CEQ: {
      const bool numok = s.has(SB_NUMOK);
      const bool o_str = ax[AX_IS_OSTR], o_num = ax[AX_IS_ONUM];
      const bool o_quant = ax[AX_IS_OQUANT];
      const bool dur_pair = s.has(SB_DUROK) && (ax[AX_IS_ODUR] || o_num);
      const int nh = sl.lane(L_NUMH, s.i), nl = sl.lane(L_NUML, s.i);
      const bool n_eq_q = lex_eq(nh, nl, ax[AX_Q_H], ax[AX_Q_L]);
      if (boolk) {
        op_val = ax[AX_IS_OBOOL] && s.has(SB_BOOLV) == (ax[AX_OBOOL] != 0);
      } else if (numk) {
        op_val = numok && o_quant && n_eq_q &&
                 (o_num || (o_str && ((nint && ax[AX_IS_OINT]) ||
                                      (!nint && ax[AX_IS_OFLOAT]))));
      } else if (strk) {
        if (dur_pair)
          op_val = lex_eq(sl.lane(L_DURH, s.i), sl.lane(L_DURL, s.i),
                          ax[AX_S_H], ax[AX_S_L]);
        else if (numok)
          op_val = o_str && o_quant && n_eq_q;
        else
          op_val = o_str && globx();
      }
      break;
    }
    case A_CGT:
    case A_CGE:
    case A_CLT:
    case A_CLE: {
      const int nh = sl.lane(L_NUMH, s.i), nl = sl.lane(L_NUML, s.i);
      const int qh = ax[AX_Q_H], ql = ax[AX_Q_L];
      const int sh = ax[AX_S_H], sl_ = ax[AX_S_L];
      const bool o_str = ax[AX_IS_OSTR], o_num = ax[AX_IS_ONUM];
      const bool o_dur = ax[AX_IS_ODUR];
      const bool cmp_q = rel4(op, A_CGT, lex_lt(nh, nl, qh, ql),
                              lex_lt(qh, ql, nh, nl));
      const bool cmp_ns = rel4(op, A_CGT, lex_lt(nh, nl, sh, sl_),
                               lex_lt(sh, sl_, nh, nl));
      const bool numkey_cmp =
          (o_num && cmp_q) || (!o_num && o_str && o_dur && cmp_ns) ||
          (!o_num && o_str && !o_dur && ax[AX_IS_OFLOAT] && cmp_q);
      const bool dur_pair = s.has(SB_DUROK) && (o_dur || o_num);
      if (numk) {
        op_val = numkey_cmp;
      } else if (strk && dur_pair) {
        const int dh = sl.lane(L_DURH, s.i), dl = sl.lane(L_DURL, s.i);
        op_val = rel4(op, A_CGT, lex_lt(dh, dl, sh, sl_), lex_lt(sh, sl_, dh, dl));
      } else if (strk && s.has(SB_NPLAIN)) {
        op_val = numkey_cmp;
      } else if (strk) {
        op_val = s.has(SB_NUMOK) && o_str && ax[AX_IS_OQUANT] && cmp_q;
      }
      break;
    }
    case A_DGT:
    case A_DGE:
    case A_DLT:
    case A_DLE: {
      const int sh = ax[AX_S_H], sl_ = ax[AX_S_L];
      if (numk) {
        const int nh = sl.lane(L_NUMH, s.i), nl = sl.lane(L_NUML, s.i);
        op_val = rel4(op, A_DGT, lex_lt(nh, nl, sh, sl_), lex_lt(sh, sl_, nh, nl));
      } else if (strk && s.has(SB_DURANY)) {
        const int dh = sl.lane(L_DURH, s.i), dl = sl.lane(L_DURL, s.i);
        op_val = rel4(op, A_DGT, lex_lt(dh, dl, sh, sl_), lex_lt(sh, sl_, dh, dl));
      }
      break;
    }
    default: break;
  }

  bool rowv = op_val;
  bool errx = false;
  if (has_p) {
    const bool absres = ax[AX_ABSENT];
    if (ax[AX_IS_MK]) {
      const bool is_exist_op = op == A_EXISTS || op == A_NOT_EXISTS;
      const bool pres_nonnull = presx && s.type != T_NULL;
      rowv = is_exist_op ? op_val : (pres_nonnull ? op_val : absres);
    } else if (ax[AX_IS_DENY]) {
      rowv = !nullx && (presx ? op_val : absres);
    } else {
      rowv = (presx && !nullx) ? op_val : absres;
    }
    errx = ax[AX_ERR] && (absx || nullx);
  }
  rowv = rowv && kind_ok;
  bool unc = false;
  if (op == A_CIN_ITEM || op == A_CIN_GLOB)
    unc = s.type == T_LIST || s.type == T_OBJ || (ax[AX_NEGATED] && boolk) ||
          (numk && ax[AX_ALLOW_NUM] && !nint) ||
          (ax[AX_KEY_PAT] && strk && s.has(SB_KEYGLOB));
  else if (op == A_GLOB)
    unc = presx && !(strk || (numk && nint) || s.type == T_NULL);
  unc = unc && kind_ok;
  return (uint8_t)((rowv ? XF_ROW : 0) | (unc ? XF_UNC : 0) |
                   (errx ? XF_ERR : 0));
}

// ---- phase 4: the verdicts of rule r for every resource of the group,
// stages 4-6 (eval.py:465-863), as bit-slices: bit i of word w of a mask
// is resource 32 w + i of the group, and the verdict is three bit-planes
// of its code. One walk of a rule's entry lists serves all K words.

// A mask over a group: K words of 32 resources.
template <int K>
struct Mask {
  uint32_t w[K];
  __device__ static Mask fill(uint32_t v) {
    Mask m;
#pragma unroll
    for (int k = 0; k < K; ++k) m.w[k] = v;
    return m;
  }
  __device__ Mask operator~() const {
    Mask m;
#pragma unroll
    for (int k = 0; k < K; ++k) m.w[k] = ~w[k];
    return m;
  }
  __device__ Mask operator&(const Mask& o) const {
    Mask m;
#pragma unroll
    for (int k = 0; k < K; ++k) m.w[k] = w[k] & o.w[k];
    return m;
  }
  __device__ Mask operator|(const Mask& o) const {
    Mask m;
#pragma unroll
    for (int k = 0; k < K; ++k) m.w[k] = w[k] | o.w[k];
    return m;
  }
  __device__ Mask& operator|=(const Mask& o) { return *this = *this | o; }
  __device__ bool any() const {
    uint32_t a = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) a |= w[k];
    return a != 0;
  }
};

// K consecutive words of shared memory, 4 K-byte aligned: one vector load
template <int K>
__device__ inline Mask<K> load_mask(const uint32_t* p) {
  Mask<K> m;
  if constexpr (K == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    m.w[0] = v.x; m.w[1] = v.y; m.w[2] = v.z; m.w[3] = v.w;
  } else if constexpr (K == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    m.w[0] = v.x; m.w[1] = v.y;
  } else {
    m.w[0] = p[0];
  }
  return m;
}

// The group's flags in shared memory: per check row the masks of CF_OK,
// CF_MISSING, CF_UNC and CF_STRUCT; per aux row those of XF_ROW, XF_UNC
// and XF_ERR; per condition slot, j (ok, key present, chain) and element
// e, the mask of bit e of word j. Each mask is K words.
template <int K>
struct Flags {
  const uint32_t *chk, *aux, *cond;
  int E;
  __device__ Mask<K> c(int row, int k) const {
    return load_mask<K>(chk + (row * SM_CHECK_MASKS + k) * K);
  }
  __device__ Mask<K> x(int row, int k) const {
    return load_mask<K>(aux + (row * SM_AUX_MASKS + k) * K);
  }
  __device__ Mask<K> w(int slot, int j, int e) const {
    return load_mask<K>(cond + ((slot * SM_COND_WORDS + j) * E + e) * K);
  }
};

template <int K>
struct Planes {
  Mask<K> p0 = Mask<K>::fill(0), p1 = Mask<K>::fill(0),
          p2 = Mask<K>::fill(0);
  // resources in m take verdict code v
  __device__ void set(const Mask<K>& m, int v) {
    const Mask<K> keep = ~m, none = Mask<K>::fill(0);
    p0 = (p0 & keep) | ((v & 1) ? m : none);
    p1 = (p1 & keep) | ((v & 2) ? m : none);
    p2 = (p2 & keep) | ((v & 4) ? m : none);
  }
  // the resources whose verdict is v
  __device__ Mask<K> is(int v) const {
    return ((v & 1) ? p0 : ~p0) & ((v & 2) ? p1 : ~p1) & ((v & 4) ? p2 : ~p2);
  }
};

// The condition groups of an alternative: for each element, the OR over
// the group's condition rows of each word; a key present where the check
// failed skips the alternative, any chain failure fails it.
template <int K>
__device__ inline void cond_group(const Sec& S, const Flags<K>& F, int j0,
                                  int j1, Mask<K>& skip, Mask<K>& chain) {
  for (int e = 0; e < F.E; ++e) {
    Mask<K> ok = Mask<K>::fill(0), kp = ok, ch = ok;
    for (int j = j0; j < j1; ++j) {
      const int ent = S.pat[j];
      if (!(ent & PE_COND)) continue;
      const int slot = S.chk[CK_COND_SLOT * S.C + (ent >> PE_SHIFT)];
      ok |= F.w(slot, 0, e);
      kp |= F.w(slot, 1, e);
      ch |= F.w(slot, 2, e);
    }
    skip |= kp & ~ok;
    chain |= ch;
  }
}

// rkind: per host-only rule, the mask of the group's resources whose kind
// its prefilter names (phase 3)
template <int K>
__device__ inline Planes<K> verdict_planes(
    const Sec& S, int r, const Flags<K>& F, bool has_checks, bool has_aux,
    const uint32_t* rkind, const Mask<K>& host_m, const Mask<K>& live_m) {
  using M = Mask<K>;
  const M ALL = M::fill(0xFFFFFFFFu), NONE = M::fill(0);
  const int rflags = S.rule_flags[r];
  const bool covered = rflags & RF_COVERED;
  const bool host = rflags & RF_HOST;
  const bool deny = rflags & RF_DENY;
  Planes<K> v;

  // ---- stage 4: pattern verdict. A rule has one alternative (whose
  // verdict it takes) or several (it passes where one passes). A rule
  // without alternatives keeps the INT_MIN of its segment_max, which
  // stage 6 overwrites whatever the rule's flags.
  if (has_checks) {
    M unc = NONE, st = NONE, pass = NONE;
    M alt_bad = NONE, skip = NONE, chain = NONE, miss = NONE, g_or = NONE;
    bool has_plain = false, has_cond = false, multi = false;
    int g0 = S.pat_ptr[r];
#pragma unroll 1
    for (int j = S.pat_ptr[r]; j < S.pat_ptr[r + 1]; ++j) {
      const int ent = S.pat[j];
      if (!(ent & PE_NOROW)) {
        const int c = ent >> PE_SHIFT;
        if (ent & PE_PLAIN) {
          has_plain = true;
          g_or |= F.c(c, 0);
        }
        if (ent & PE_TRACKED) miss |= F.c(c, 1);
        unc |= F.c(c, 2);
        st |= F.c(c, 3);
        has_cond = has_cond || (ent & PE_COND);
        if (ent & PE_GROUP_END) {
          if (has_plain) alt_bad |= ~g_or;
          if (has_cond) cond_group(S, F, g0, j + 1, skip, chain);
          g_or = NONE;
          has_plain = has_cond = false;
          g0 = j + 1;
        }
      } else {
        g0 = j + 1;
      }
      if (ent & PE_ALT_END) {
        const M ok = ~(alt_bad | chain);
        if (ent & PE_MULTI) {
          multi = true;
          pass |= ~skip & ok;
        } else {
          v.set(ALL, V_FAIL);
          v.set(~skip & ~ok & miss, V_HOST);
          v.set(~skip & ok, V_PASS);
          v.set(skip, V_SKIP);
          v.set(skip & ~ok, V_HOST);           // ambiguous
        }
        alt_bad = skip = chain = miss = NONE;
      }
    }
    if (multi) {
      v.set(ALL, V_FAIL);
      v.set(pass, V_PASS);
    }
    v.set(unc & (v.is(V_FAIL) | v.is(V_ERROR) | v.is(V_SKIP)), V_HOST);
    v.set(st, V_HOST);
  } else {
    v.set(ALL, covered ? V_PASS : V_NA);
  }

  // ---- stage 5: aux programs. A group's value is its rows' OR, XOR its
  // negate bit (eval.py:765-767); filters AND their groups. Every OR
  // starts empty and every AND full: the *_n masks hold negated ANDs.
  M applicable = ALL, precond_ok = ALL, deny_match = NONE;
  M deny_err = NONE, match_unc = NONE, cond_unc = NONE;
  if (has_aux) {
    const int32_t* is_mk = S.aux + AX_IS_MK * S.X;
    M m_or = NONE, m_n = NONE, e_or = NONE, e_n = NONE, f_n = NONE;
    M pre_n = NONE, pre_any = NONE, den_n = NONE, den_any = NONE;
#pragma unroll 1
    for (int j = S.auxp_ptr[r]; j < S.auxp_ptr[r + 1]; ++j) {
      const int ent = S.auxp[j];
      if (!(ent & AE_NOGROUP)) {
        const int g = ent >> AE_SHIFT;
        M any = NONE;
#pragma unroll 1
        for (int i = S.axg_ptr[g]; i < S.axg_ptr[g + 1]; ++i) {
          const int row = S.axg_row[i];
          any |= F.x(row, 0);
          const M u = F.x(row, 1);
          if (u.any()) {
            if (is_mk[row]) match_unc |= u;
            else cond_unc |= u;
          }
          deny_err |= F.x(row, 2);
        }
        const int info = S.axg_info[g];
        const M gv = (info & AG_NEGATE) ? ~any : any;
        const int klass = info >> AG_KLASS_SHIFT;
        if (klass == AUX_PRECOND) {
          if (info & AG_ANY) pre_any |= gv; else pre_n |= ~gv;
        } else if (klass == AUX_DENY) {
          if (info & AG_ANY) den_any |= gv; else den_n |= ~gv;
        }
        if (ent & AE_FILTER) f_n |= ~gv;
      }
      if (ent & AE_FILT_END) {
        if (ent & AE_FILT_EX) {
          e_or |= ~f_n;
          e_n |= f_n;
        } else {
          m_or |= ~f_n;
          m_n |= f_n;
        }
        f_n = NONE;
      }
    }
    const M match_ok = ((rflags & RF_MATCH_ANY) ? m_or : ~m_n) |
                       ((rflags & RF_HAS_MATCH) ? NONE : ALL);
    const M exclude_hit = ((rflags & RF_EXCLUDE_ALL) ? ~e_n : e_or) &
                          ((rflags & RF_HAS_EXCLUDE) ? ALL : NONE);
    applicable = match_ok & ~exclude_hit;
    precond_ok = ~pre_n & (pre_any | ((rflags & RF_PRECOND_ANY) ? NONE : ALL));
    deny_match = ~den_n & (den_any | ((rflags & RF_DENY_ANY) ? NONE : ALL));
  }

  // ---- stage 6: composition, in the TPU program's order (eval.py:823-856)
  if (deny) {
    v.set(ALL, V_PASS);
    v.set(deny_match, V_FAIL);
    v.set(deny_err, V_ERROR);
  }
  if (!covered && !host && !deny) v.set(ALL, V_NA);
  v.set(~precond_ok, V_SKIP);
  if (!host) {
    v.set(cond_unc, V_HOST);
    v.set(~applicable, V_NA);
    v.set(match_unc, V_HOST);
  } else {
    const M kind_hit = (rflags & RF_ALL_KINDS)
        ? ALL : load_mask<K>(rkind + r * SM_RULE_MASKS * K);
    v.set(ALL, V_HOST);
    v.set(~kind_hit, V_NA);
  }
  v.set(host_m, V_HOST);
  v.set(~live_m, V_NA);
  return v;
}

// The scan form's outputs: the masks of one buffer (ops/eval.py
// eval_rules_scan), fail [G, R], pass [G, R], host [n_tiles, G].
struct ScanOut {
  uint32_t *fail, *pass, *host;
  int G;
  size_t words;    // of the buffer, from fail: 2 G R + n_tiles G
};

// The counts form's output: fails [live] then passes [live] in one int32
// buffer; c is null in the plain matrix form and in the scan form.
struct Counts {
  int* c;
  int live;
};

// Store bits 0 .. TB-1 of m at bit sh of *word (sh a multiple of TB), for
// a group of TB <= 32 resources. A group of 8 or more owns whole bytes
// and stores them; the last group of the batch also stores the bytes
// after its own, up to the word's end, so that no byte of the masks is
// left unwritten. Smaller groups share bytes: atomicOr into the zeroed
// masks.
__device__ inline void put_bits(uint32_t* word, uint32_t m, int sh, int TB,
                                bool last) {
  if (TB < 8) {
    if (m) atomicOr(word, m << sh);
  } else if (TB == 32) {
    *word = m;
  } else {
    uint8_t* bytes = (uint8_t*)word;
    const int k0 = sh >> 3, n = last ? 4 - k0 : TB >> 3;
    for (int k = 0; k < n; ++k) bytes[k0 + k] = (uint8_t)(m >> (8 * k));
  }
}

// Bits 0 .. n-1 of each word of a group's mask set, n counted from the
// group's first resource.
template <int K>
__device__ inline Mask<K> first_bits(int n) {
  Mask<K> m;
#pragma unroll
  for (int w = 0; w < K; ++w) {
    const int b = n - 32 * w;
    m.w[w] = b >= 32 ? 0xFFFFFFFFu : (b <= 0 ? 0u : (1u << b) - 1u);
  }
  return m;
}

// Grid (blocks a tile, rule tiles). A block stages its tile's section
// once, then walks the groups blockIdx.x, blockIdx.x + gridDim.x, ... of
// GS = TB * K resources each: TB lanes take one row for TB resources
// (TB <= 32; 32 where K > 1), and each of them evaluates it for K
// resources, 32 apart.
template <bool kScan, int K>
__global__ void __launch_bounds__(kThreads, K == 1 ? 3 : 2)
rules_kernel(const int32_t* __restrict__ plan, Blob bl,
             const uint8_t* __restrict__ match_nv, int tb_shift,
             int n_groups, int8_t* __restrict__ out, ScanOut so, Counts cn) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ uint32_t host_or[K];       // scan form: the tile's HOST resources
  __shared__ uint32_t host_live[2 * K];
  const int TB = 1 << tb_shift, GS = TB * K;
  const int kshift = K == 4 ? 2 : K == 2 ? 1 : 0;
  const int gs_shift = tb_shift + kshift;
  const int E = bl.E, V = bl.V;
  const int32_t* tt = plan + plan[H_TILES] + blockIdx.y * TT_NCOLS;
  const TileDims td = tile_dims(tt);
  const Layout L = layout(td, E, GS);
  const int tid = threadIdx.x;
  // thread -> (lane bi of a task, first task); one pass of the block
  // covers blockDim.x / TB tasks, so a warp holds one task for up to 32
  // lanes
  const int bi = tid & (TB - 1);
  const int row0 = tid >> tb_shift;
  const int rows_per_pass = blockDim.x >> tb_shift;
  const int lane = tid & 31;
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int group_lane = lane & ~(TB - 1);          // the row's first lane
  const uint32_t low = TB == 32 ? 0xFFFFFFFFu : (1u << TB) - 1u;
  const int32_t* gsec = plan + tt[TT_OFF];
  int32_t* sec = (int32_t*)(smem + L.plan);
  const Slots sl{(uint32_t*)(smem + L.slots), td.paths * E * GS, E, GS};
  uint32_t* sbm = (uint32_t*)(smem + L.bmeta);
  uint32_t* sgate = (uint32_t*)(smem + L.gate);
  uint32_t* scw = (uint32_t*)(smem + L.cond);
  uint32_t* scf = (uint32_t*)(smem + L.cflags);
  uint32_t* sxf = (uint32_t*)(smem + L.xflags);
  uint32_t* skind = (uint32_t*)(smem + L.rkind);
  const Flags<K> F{scf, sxf, scw, E};
  const bool has_checks = plan[H_C] > 0;
  const bool has_aux = plan[H_X] > 0;
  const int kmax = plan[H_KMAX];
  const long long R = plan[H_R];
  const int r0 = tt[TT_R0];
  const int32_t* gpaths = gsec + gsec[TS_PATHS];
  const int n_pe = td.paths * E;

  // ---- 1. stage the tile's section once; the first group's slots are
  // decoded meanwhile
  if (tid == 0) barrier_init(&bar);
  __syncthreads();
  if (tid == 0) bulk_copy(sec, gsec, (uint32_t)tt[TT_WORDS] * 4u, &bar);
  bool staged = false;

#pragma unroll 1
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int b0 = grp * GS;
    const int nb = min(GS, bl.B - b0);
    for (int i = tid; i < (n_pe << gs_shift); i += blockDim.x) {
      const int pe = i >> gs_shift, bj = i & (GS - 1);
      if (bj < nb) {
        const int lp = pe / E;
        sl.put(i, load_slot(bl, b0 + bj, gpaths[lp], pe - lp * E));
      }
    }
    for (int i = tid; i < GS; i += blockDim.x)
      sbm[i] = i < nb ? bl.bmeta[b0 + i] : 0u;
    if (kScan && tid < K) host_or[tid] = 0;
    if (!staged) {
      barrier_wait(&bar);
      staged = true;
    }
    __syncthreads();

    const Sec S = section(sec);

    // ---- 2-3. gates, then check rows, then aux rows, each (row, word of
    // the group) a task: the row's TB lanes evaluate it for the word's
    // resources (resource bi + 32 k of the group for word k), and for
    // flags the warp's ballots turn them into the word's masks, which the
    // row's first lane stores. Every lane takes part in every ballot (a
    // pass covers the same tasks in each warp).
    for (int t = row0; t < (S.ngates << kshift); t += rows_per_pass) {
      const int g = t >> kshift, bk = bi + 32 * (t & (K - 1));
      if (bk < nb) sgate[g * GS + bk] = gate_word(S, g, bk, sl, V, match_nv);
    }
    __syncthreads();

    for (int base = 0; base < (S.C << kshift); base += rows_per_pass) {
      const int t = base + row0, c = t >> kshift, k = t & (K - 1);
      const int bk = bi + 32 * k;
      const bool row = c < S.C;
      uint32_t words[3] = {0u, 0u, 0u};
      const uint32_t f = (bk < nb && row)
          ? check_row(S, c, bk, GS, sl, V, match_nv, sgate, words) : 0u;
#pragma unroll
      for (int q = 0; q < SM_CHECK_MASKS; ++q) {
        const uint32_t m =
            (__ballot_sync(0xFFFFFFFFu, (f >> q) & 1u) >> group_lane) & low;
        if (bi == 0 && row) scf[(c * SM_CHECK_MASKS + q) * K + k] = m;
      }
      if (__any_sync(0xFFFFFFFFu, f & kCondRow)) {
        const int slot = (bi == 0 && (f & kCondRow))
            ? S.chk[CK_COND_SLOT * S.C + c] : -1;
        for (int e = 0; e < E; ++e) {
#pragma unroll
          for (int j = 0; j < SM_COND_WORDS; ++j) {
            const uint32_t w =
                (__ballot_sync(0xFFFFFFFFu, (words[j] >> e) & 1u)
                 >> group_lane) & low;
            if (slot >= 0) scw[((slot * SM_COND_WORDS + j) * E + e) * K + k] = w;
          }
        }
      }
    }
    for (int base = 0; base < (S.X << kshift); base += rows_per_pass) {
      const int t = base + row0, x = t >> kshift, k = t & (K - 1);
      const int bk = bi + 32 * k;
      const uint32_t f = (bk < nb && x < S.X)
          ? aux_row(S, x, bk, sbm[bk], sl, V, match_nv) : 0u;
#pragma unroll
      for (int q = 0; q < SM_AUX_MASKS; ++q) {
        const uint32_t m =
            (__ballot_sync(0xFFFFFFFFu, (f >> q) & 1u) >> group_lane) & low;
        if (bi == 0 && x < S.X) sxf[(x * SM_AUX_MASKS + q) * K + k] = m;
      }
    }
    // host-only rules' kind prefilter: a warp takes 32 rules at a time
    // and each host-only one among them for all the group's resources, a
    // resource a lane. rule_kind_ids pads with -1, and an unknown kind is
    // -1 too, so it hits every host-only rule's prefilter, as in the TPU
    // program
    for (int base = warp * 32; base < S.R; base += 32 * nwarps) {
      uint32_t hr = __ballot_sync(
          0xFFFFFFFFu,
          base + lane < S.R && (S.rule_flags[base + lane] & RF_HOST));
      while (hr) {
        const int r = base + __ffs(hr) - 1;
        hr &= hr - 1;
        const int32_t* kinds = S.rule_kinds + r * kmax;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int bk = lane + 32 * k;
          bool hit = false;
          if (bk < nb) {
            const int kind_id = (int)(sbm[bk] & 0xFFFFu) - 1;
            for (int q = 0; q < kmax; ++q) hit = hit || kinds[q] == kind_id;
          }
          const uint32_t m = __ballot_sync(0xFFFFFFFFu, hit);
          if (lane == 0) skind[r * SM_RULE_MASKS * K + k] = m;
        }
      }
    }
    if (tid < 32 * K) {
      // warp w: word w of the group's HOST and live rows
      const uint32_t bm = tid < nb ? sbm[tid] : 0u;
      const uint32_t hm = __ballot_sync(0xFFFFFFFFu, (bm >> 16) & 1u);
      const uint32_t lm = __ballot_sync(0xFFFFFFFFu, (bm >> 17) & 1u);
      if (lane == 0) {
        host_live[2 * (tid >> 5)] = hm;
        host_live[2 * (tid >> 5) + 1] = lm;
      }
    }
    __syncthreads();

    // ---- 4. verdicts: one thread per rule, for all the group's resources
    Mask<K> host_m, live_m;
#pragma unroll
    for (int w = 0; w < K; ++w) {
      host_m.w[w] = host_live[2 * w];
      live_m.w[w] = host_live[2 * w + 1];
    }
    const Mask<K> cut = first_bits<K>(nb);
    if (kScan) {
      // ---- 4-5, scan form: masks from each rule's planes, in registers
      const int g = b0 >> 5, sh = b0 & 31;
      const bool last = b0 + GS >= bl.B;
      Mask<K> hm = Mask<K>::fill(0);
      for (int r = tid; r < S.R; r += blockDim.x) {
        const Planes<K> v = verdict_planes<K>(S, r, F, has_checks, has_aux,
                                              skind, host_m, live_m);
        const Mask<K> fm = v.p1 & ~v.p0 & ~v.p2 & cut;
        const Mask<K> pm = v.p0 & ~v.p1 & ~v.p2 & cut;
        hm |= v.p0 & ~v.p1 & v.p2 & cut;
        const long long at = (long long)g * R + r0 + r;
        if (K == 1) {
          put_bits(so.fail + at, fm.w[0], sh, TB, last);
          put_bits(so.pass + at, pm.w[0], sh, TB, last);
        } else {
#pragma unroll
          for (int w = 0; w < K; ++w)
            if (32 * w < nb) {
              so.fail[at + w * R] = fm.w[w];
              so.pass[at + w * R] = pm.w[w];
            }
        }
      }
#pragma unroll
      for (int w = 0; w < K; ++w) {
        const uint32_t h = __reduce_or_sync(0xFFFFFFFFu, hm.w[w]);
        if (lane == 0 && h) atomicOr(&host_or[w], h);
      }
      __syncthreads();
      uint32_t* host = so.host + (long long)blockIdx.y * so.G + g;
      if (K == 1) {
        if (tid == 0) put_bits(host, host_or[0], sh, TB, last);
      } else if (tid < K && 32 * tid < nb) {
        host[tid] = host_or[tid];
      }
      continue;
    }
    // ---- 4-5, matrix and counts forms: each rule's verdict bytes from its
    // planes in registers, a warp's stores one resource's consecutive
    // rules
    for (int r = tid; r < S.R; r += blockDim.x) {
      const Planes<K> v = verdict_planes<K>(S, r, F, has_checks, has_aux,
                                            skind, host_m, live_m);
      int8_t* o = out + (long long)b0 * R + r0 + r;
#pragma unroll
      for (int w = 0; w < K; ++w) {
        const uint32_t q0 = v.p0.w[w], q1 = v.p1.w[w], q2 = v.p2.w[w];
        const int n = min(32, nb - 32 * w);
        for (int i = 0; i < n; ++i)
          o[(long long)(32 * w + i) * R] =
              (int8_t)(((q0 >> i) & 1u) | (((q1 >> i) & 1u) << 1) |
                       (((q2 >> i) & 1u) << 2));
      }
      // counts form: the group's FAIL and PASS cells of a live rule
      if (cn.c != nullptr && r0 + r < cn.live) {
        int nf = 0, np = 0;
#pragma unroll
        for (int w = 0; w < K; ++w) {
          nf += __popc(v.p1.w[w] & ~v.p0.w[w] & ~v.p2.w[w] & cut.w[w]);
          np += __popc(v.p0.w[w] & ~v.p1.w[w] & ~v.p2.w[w] & cut.w[w]);
        }
        if (nf) atomicAdd(cn.c + r0 + r, nf);
        if (np) atomicAdd(cn.c + cn.live + r0 + r, np);
      }
    }
    // the next group's decode writes only the slots and bmeta, which
    // phase 4 does not read; its flags wait for the barrier after it
  }
}

// One instance a form and words a mask.
template <bool kScan>
using KernelFn = void (*)(const int32_t*, Blob, const uint8_t*, int, int,
                          int8_t*, ScanOut, Counts);

template <bool kScan>
KernelFn<kScan> kernel_for(int K) {
  return K == 4 ? rules_kernel<kScan, 4>
                : K == 2 ? rules_kernel<kScan, 2> : rules_kernel<kScan, 1>;
}

constexpr int kMaxK = 4;         // words a mask: groups of up to 128

// Device limits, read once on the first device that launches: the dynamic
// shared memory a block may take and the number of SMs (a mesh's cards are
// one model).
int g_smem_room = -1;
int g_sms = 0;
// each instance's dynamic shared memory limit, as set on each device (a
// function attribute belongs to the device that was current when it was
// set), by words a mask (1, 2, 4 at 0, 1, 2)
constexpr int kMaxDevices = 64;
template <bool kScan> int g_smem_set[kMaxDevices][3] = {};

int device_limits() {
  if (g_smem_room < 0) {
    int dev = 0, optin = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    size_t stat = 0;
    for (int K = 1; K <= kMaxK && err == cudaSuccess; K *= 2) {
      cudaFuncAttributes fa, fs;
      err = cudaFuncGetAttributes(&fa, kernel_for<false>(K));
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&fs, kernel_for<true>(K));
      if (err == cudaSuccess)
        stat = std::max({stat, fa.sharedSizeBytes, fs.sharedSizeBytes});
    }
    if (err != cudaSuccess) return (int)err;
    g_sms = sms;
    g_smem_room = optin - (int)stat;
  }
  return 0;
}

int k_slot(int K) { return K == 4 ? 2 : K == 2 ? 1 : 0; }

template <bool kScan>
int set_smem(int K, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& set = g_smem_set<kScan>[dev][k_slot(K)];
  if (bytes > set) {
    err = cudaFuncSetAttribute(kernel_for<kScan>(K),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    set = bytes;
  }
  return 0;
}

// The shared memory a launch of groups of gs resources asks for: that of
// its largest tile.
int launch_bytes(const int32_t* tiles, int64_t n_tiles, int E, int gs) {
  int most = 0;
  for (int64_t k = 0; k < n_tiles; ++k)
    most = std::max(most, layout(tile_dims(tiles + k * TT_NCOLS), E, gs).total);
  return most;
}

// Blocks of a launch of groups of gs resources that an SM holds at once,
// after setting the instance's shared memory; 0 where none fits.
template <bool kScan>
int blocks_per_sm(int gs, int bytes, int* per_sm) {
  const int K = gs > kMaxTB ? gs / kMaxTB : 1;
  *per_sm = 0;
  int err = set_smem<kScan>(K, bytes);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel_for<kScan>(K), kThreads, bytes);
}

// Resources a group: the largest of 128 and 64 whose groups, over every
// tile, fill the card's resident blocks at two blocks an SM or more (a
// group of more words walks each rule and row once for more resources,
// but a batch of fewer groups leaves SMs idle), else of 32, 16 and 8
// whose groups give every SM a block, else 8; smaller only where 8 does
// not fit (an E above the flattener's 16), halving down to 1. 0 if not
// even one resource fits.
template <bool kScan>
int choose_gs(const int32_t* tiles, int64_t n_tiles, int E, int64_t B) {
  for (int gs = kMaxK * kMaxTB; gs >= 1; gs /= 2) {
    const int bytes = launch_bytes(tiles, n_tiles, E, gs);
    if (bytes > g_smem_room) continue;
    if (gs <= 8) return gs;
    int per_sm = 0;
    if (blocks_per_sm<kScan>(gs, bytes, &per_sm) != 0 || per_sm == 0)
      continue;
    const int64_t groups = (B + gs - 1) / gs * n_tiles;
    if (gs > kMaxTB && per_sm < 2) continue;
    const int64_t need = gs > kMaxTB ? (int64_t)per_sm * g_sms : g_sms;
    if (groups >= need) return gs;
  }
  return 0;
}

// One launch of stages 2-6 in either form (see the entries below). info
// receives the geometry: resources a group, dynamic shared memory a
// block, blocks in all, blocks an SM.
template <bool kScan>
int launch(int64_t plan, int64_t blob, int64_t B, int64_t P, int64_t E,
           int64_t V, int64_t match_nv, int64_t tiles, int64_t n_tiles,
           int64_t info, int8_t* out, ScanOut so, Counts cn,
           cudaStream_t stream) {
  int err = device_limits();
  if (err != 0) return err;
  const int32_t* tt = (const int32_t*)tiles;
  const int gs = choose_gs<kScan>(tt, n_tiles, (int)E, B);
  if (gs == 0) return (int)cudaErrorInvalidConfiguration;
  const int bytes = launch_bytes(tt, n_tiles, (int)E, gs);
  int per_sm = 0;
  if ((err = blocks_per_sm<kScan>(gs, bytes, &per_sm)) != 0) return err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int K = gs > kMaxTB ? gs / kMaxTB : 1;
  const int tb = gs / K;
  int tb_shift = 0;
  while ((1 << tb_shift) < tb) ++tb_shift;
  const int64_t n_groups = (B + gs - 1) / gs;
  // One tile: persistent blocks, as many as the SMs hold at once, each
  // staging the section once for all its groups (0.0449 against 0.0465 ms
  // a block a group at 100k; PERF.md §6). Several tiles: a block a group
  // and tile, which the card's block scheduler balances where the tiles'
  // work differs (the wide corpus: 0.4405 against 0.6902 ms split evenly).
  const int grid_x = n_tiles == 1
      ? (int)std::min(n_groups, (int64_t)per_sm * g_sms) : (int)n_groups;
  int32_t* in = (int32_t*)info;
  in[0] = gs;
  in[1] = bytes;
  in[2] = grid_x * (int)n_tiles;
  in[3] = per_sm;
  if (kScan && gs < 8) {
    // blocks share the masks' bytes: they atomicOr into zeroed words
    const cudaError_t e = cudaMemsetAsync(so.fail, 0, so.words * 4, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (cn.c != nullptr && cn.live > 0) {
    // blocks add into the counts
    const cudaError_t e =
        cudaMemsetAsync(cn.c, 0, (size_t)cn.live * 2 * 4, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const Blob bl = make_blob((const uint32_t*)blob, (int)B, (int)P, (int)E,
                            (int)V);
  const dim3 grid((unsigned)grid_x, (unsigned)n_tiles);
  kernel_for<kScan>(K)<<<grid, kThreads, bytes, stream>>>(
      (const int32_t*)plan, bl, (const uint8_t*)match_nv, tb_shift,
      (int)n_groups, out, so, cn);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of stages 2-6. tiles: the plan's tile table [n_tiles,
// TT_NCOLS] in host memory; info: host int32[4] that receives the
// launch's geometry (resources a group, dynamic shared memory a block,
// blocks in all, blocks an SM).
extern "C" int ktpu_eval_rules(int64_t plan, int64_t blob, int64_t B,
                               int64_t P, int64_t E, int64_t V,
                               int64_t match_nv, int64_t tiles,
                               int64_t n_tiles, int64_t info, int64_t out,
                               int64_t stream) {
  return launch<false>(plan, blob, B, P, E, V, match_nv, tiles, n_tiles,
                       info, (int8_t*)out, ScanOut{nullptr, nullptr, nullptr, 0, 0},
                       Counts{nullptr, 0}, (cudaStream_t)stream);
}

// The counts form: the verdicts into out as ktpu_eval_rules writes them,
// and counts (int32 [2, live], fails then passes, 0 <= live <= R) zeroed,
// then the FAIL and PASS cells of each rule r < live over every resource.
extern "C" int ktpu_eval_rules_counts(int64_t plan, int64_t blob, int64_t B,
                                      int64_t P, int64_t E, int64_t V,
                                      int64_t match_nv, int64_t tiles,
                                      int64_t n_tiles, int64_t info,
                                      int64_t out, int64_t live,
                                      int64_t counts, int64_t stream) {
  return launch<false>(plan, blob, B, P, E, V, match_nv, tiles, n_tiles,
                       info, (int8_t*)out, ScanOut{nullptr, nullptr, nullptr, 0, 0},
                       Counts{(int*)counts, (int)live}, (cudaStream_t)stream);
}

// The scan form: masks (uint32) is one buffer of fail_m [G, R], pass_m
// [G, R] and host_m [n_tiles, G] in that order, G = ceil(B / 32). R is the
// last tile's TT_R1.
extern "C" int ktpu_eval_rules_scan(int64_t plan, int64_t blob, int64_t B,
                                    int64_t P, int64_t E, int64_t V,
                                    int64_t match_nv, int64_t tiles,
                                    int64_t n_tiles, int64_t info,
                                    int64_t masks, int64_t stream) {
  const int32_t* tt = (const int32_t*)tiles;
  const long long R = tt[(n_tiles - 1) * TT_NCOLS + TT_R1];
  const long long G = (B + 31) / 32;
  uint32_t* m = (uint32_t*)masks;
  const ScanOut so{m, m + G * R, m + 2 * G * R, (int)G,
                   (size_t)(2 * G * R + n_tiles * G)};
  return launch<true>(plan, blob, B, P, E, V, match_nv, tiles, n_tiles, info,
                      nullptr, so, Counts{nullptr, 0}, (cudaStream_t)stream);
}
