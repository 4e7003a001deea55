// Shared layout of the device plan and the packed batch blob.
//
// The plan is one int32 buffer built once per compiled policy set
// (kyverno_tpu_torch/ops/eval.py::build_plan). It starts with a header:
// H_C .. H_KMAX are sizes, H_CHK .. H_FILT_EX are offsets (in int32
// words from the start of the buffer) of the arrays below. The CSR lists
// ("*_PTR" [n+1] offsets into "*_<ITEM>" ids) replace the TPU program's
// segment scatters: a kernel walks a rule's alternatives, groups and rows
// instead of reducing over segment ids. The numbers here must equal the
// constants of the same names in ops/eval.py (a CPU test compares them).

#pragma once
#include <cstdint>

namespace ktpu {

// ---- plan header
enum Header {
  H_C = 0, H_X = 1, H_G = 2, H_A = 3, H_R = 4, H_NGATES = 5, H_NCOND = 6,
  H_GX = 7, H_FX = 8, H_KMAX = 9,
  H_CHK = 10, H_AUX = 11, H_GATE_PTR = 12, H_GATE_GRP = 13, H_GRP_PTR = 14,
  H_GRP_ROW = 15, H_ALT_PTR = 16, H_ALT_GRP = 17, H_ALT_MULTI = 18,
  H_RULE_PTR = 19, H_RULE_ALT = 20, H_RULE_FLAGS = 21, H_RULE_KINDS = 22,
  H_RAXG_PTR = 23, H_RAXG_GRP = 24, H_AXG_PTR = 25, H_AXG_ROW = 26,
  H_AXG_INFO = 27, H_RF_PTR = 28, H_RF_FILT = 29, H_FG_PTR = 30,
  H_FG_GRP = 31, H_FILT_EX = 32, H_NHEADER = 33,
};

// ---- check table: [C, CK_NCOLS] int32, one row per check
enum CheckCol {
  CK_PATH = 0, CK_OP = 1, CK_PLEN = 2, CK_GUARD = 3, CK_NFA = 4,
  CK_HAS_NFA = 5, CK_LO_H = 6, CK_LO_L = 7, CK_HI_H = 8, CK_HI_L = 9,
  CK_BOOL = 10, CK_NUMFB = 11, CK_NUMMODE = 12, CK_GATE = 13,
  CK_IS_GATE = 14, CK_IS_COND = 15, CK_EXIST = 16, CK_TRACK = 17,
  CK_COND_DEPTH = 18, CK_COND_SLOT = 19, CK_NCOLS = 20,
};

// ---- aux table: [X, AX_NCOLS] int32, one row per aux primitive
enum AuxCol {
  AX_PATH = 0, AX_HAS_PATH = 1, AX_PLEN = 2, AX_OP = 3, AX_KIND = 4,
  AX_NFA = 5, AX_HAS_NFA = 6, AX_ABSENT = 7, AX_ERR = 8, AX_ALLOW_NUM = 9,
  AX_KEY_PAT = 10, AX_OBOOL = 11, AX_IS_OBOOL = 12, AX_IS_OSTR = 13,
  AX_IS_ONUM = 14, AX_IS_ODUR = 15, AX_IS_OFLOAT = 16, AX_IS_OINT = 17,
  AX_IS_OQUANT = 18, AX_Q_H = 19, AX_Q_L = 20, AX_S_H = 21, AX_S_L = 22,
  AX_IS_MK = 23, AX_IS_DENY = 24, AX_NEGATED = 25, AX_NCOLS = 26,
};

// ---- per-rule flag bits (RULE_FLAGS)
enum RuleFlag {
  RF_COVERED = 1 << 0, RF_HOST = 1 << 1, RF_DENY = 1 << 2,
  RF_DENY_ANY = 1 << 3, RF_PRECOND_ANY = 1 << 4, RF_MATCH_ANY = 1 << 5,
  RF_HAS_MATCH = 1 << 6, RF_HAS_EXCLUDE = 1 << 7, RF_EXCLUDE_ALL = 1 << 8,
  RF_ALL_KINDS = 1 << 9,
};

// ---- per-aux-group info bits (AXG_INFO): negate, any-block, klass << 4
enum AuxGroupInfo { AG_NEGATE = 1, AG_ANY = 2, AG_KLASS_SHIFT = 4 };

// ---- per-(b, c) check flags and per-(b, x) aux flags, written by
// eval_checks and read by eval_verdict
enum CheckFlag { CF_OK = 1, CF_MISSING = 2, CF_UNC = 4, CF_STRUCT = 8 };
enum AuxFlag { XF_ROW = 1, XF_UNC = 2, XF_ERR = 4 };

// ---- enums of the IR (kyverno_tpu_torch/models/ir.py)
enum CheckOp {
  STR_EQ = 0, STR_NE = 1, NUM_EQ = 2, NUM_NE = 3, NUM_GT = 4, NUM_GE = 5,
  NUM_LT = 6, NUM_LE = 7, NUM_IN_RANGE = 8, NUM_NOT_IN_RANGE = 9,
  BOOL_EQ = 10, IS_NULL = 11, EXISTS_OBJECT = 12, ABSENT = 13,
  EXISTS_NONNIL = 14, EXISTS_LIST = 15,
};
enum AuxOp {
  A_TRUE = 0, A_FALSE = 1, A_GLOB = 2, A_EXISTS = 3, A_NOT_EXISTS = 4,
  A_CEQ = 5, A_CIN_ITEM = 6, A_CIN_GLOB = 7, A_CGT = 8, A_CGE = 9,
  A_CLT = 10, A_CLE = 11, A_DGT = 12, A_DGE = 13, A_DLT = 14, A_DLE = 15,
};
enum AuxKlass { AUX_MATCH = 0, AUX_EXCLUDE = 1, AUX_PRECOND = 2, AUX_DENY = 3 };
enum TypeTag { T_ABSENT = 0, T_NULL = 1, T_BOOL = 2, T_NUM = 3, T_STR = 4,
               T_OBJ = 5, T_LIST = 6 };
enum VerdictCode { V_NA = 0, V_PASS = 1, V_FAIL = 2, V_SKIP = 3, V_ERROR = 4,
                   V_HOST = 5 };

constexpr int kStrLen = 64;  // bytes per dictionary string (4 x 16 words)

// Offsets of the blob's parts (kyverno_tpu_torch/models/flatten.py
// _assemble_blob): cells [B,P,E,2], bmeta [B], dictv [V,5], str words.
struct Blob {
  const uint32_t* cells;
  const uint32_t* bmeta;
  const uint32_t* dictv;
  const uint8_t* str_bytes;
  int B, P, E, V;
};

__host__ __device__ inline Blob make_blob(const uint32_t* base, int B, int P,
                                          int E, int V) {
  Blob bl;
  const long long o0 = (long long)B * P * E * 2;
  bl.cells = base;
  bl.bmeta = base + o0;
  bl.dictv = base + o0 + B;
  bl.str_bytes = (const uint8_t*)(base + o0 + B + (long long)V * 5);
  bl.B = B; bl.P = P; bl.E = E; bl.V = V;
  return bl;
}

// One decoded slot: the 16 per-cell lanes of flatten.unpack_batch,
// gathered from the dictionary row the cell names.
struct Slot {
  int mask, type, sid, elem0;
  bool valid, nbrk, nint;
  int numh, numl, durh, durl;
  bool numok, nplain, durok, durany, boolv;
};

__device__ inline Slot load_slot(const Blob& bl, int b, int p, int e) {
  Slot s;
  const long long idx = (((long long)b * bl.P + p) * bl.E + e) * 2;
  const uint32_t w0 = bl.cells[idx];
  const uint32_t meta = bl.cells[idx + 1];
  s.sid = (int)w0 - 1;
  s.mask = (int)(meta & 0xFFFFu);
  s.type = (int)((meta >> 16) & 7u);
  s.valid = (meta >> 19) & 1u;
  s.nbrk = (meta >> 20) & 1u;
  const bool nint_raw = (meta >> 21) & 1u;
  s.elem0 = (int)((meta >> 22) & 0xFFu) - 1;
  const bool present = s.sid >= 0;
  const bool numlike = s.type == T_NUM || s.type == T_STR;
  const bool is_str = s.type == T_STR;
  const bool is_bool = s.type == T_BOOL;
  uint32_t d0 = 0, d1 = 0, d2 = 0, d3 = 0, d4 = 0;
  if (present) {
    const uint32_t* d = bl.dictv + (long long)s.sid * 5;
    d0 = d[0]; d1 = d[1]; d2 = d[2]; d3 = d[3]; d4 = d[4];
  }
  s.numok = ((d0 >> 31) & 1u) && present && numlike;
  s.numl = s.numok ? (int)(d0 & 0x7FFFFFFFu) : 0;
  s.numh = s.numok ? (int)d1 : 0;
  s.nplain = ((d4 >> 10) & 1u) && present && numlike;
  s.durany = ((d4 >> 9) & 1u) && present && is_str;
  s.durok = ((d2 >> 31) & 1u) && present && is_str;
  s.durl = s.durany ? (int)(d2 & 0x7FFFFFFFu) : 0;
  s.durh = s.durany ? (int)d3 : 0;
  s.boolv = ((d4 >> 8) & 1u) && present && is_bool;
  s.nint = nint_raw && numlike;
  return s;
}

// (hi, lo) limb compares: lexicographic order equals int64 order
__device__ inline bool lex_lt(int ah, int al, int bh, int bl) {
  return ah < bh || (ah == bh && al < bl);
}
__device__ inline bool lex_eq(int ah, int al, int bh, int bl) {
  return ah == bh && al == bl;
}

}  // namespace ktpu
