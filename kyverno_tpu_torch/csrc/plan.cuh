// Shared layout of the device plan and the packed batch blob.
//
// The plan is one int32 buffer built once per compiled policy set
// (kyverno_tpu_torch/ops/plan.py::Plan). It starts with a global header
// (H_*), then a tile table [H_NTILES, TT_NCOLS] of global ids, then one
// section per tile. A tile is a range of consecutive rules; its section
// holds everything a block needs to evaluate those rules, with ids local
// to the tile: a section header (TS_C .. TS_NPATH are counts, TS_CHK ..
// TS_AXG_INFO offsets in int32 words from the section's start), the check
// table and the aux table column-major (column k of the check table is
// [k * TS_C, (k + 1) * TS_C)), the global ids of the paths the tile reads
// (CK_PATH and AX_PATH index this list), and CSR lists ("*_PTR" [n+1]
// offsets into "*_<ITEM>" ids) that replace the TPU program's segment
// scatters: gate -> groups -> rows, aux group -> aux rows, and per rule
// one flat list of pattern entries and one of aux-group entries. Sections
// start and end on 16 bytes, so one bulk copy stages a section in shared
// memory. The numbers here must equal the constants of the same names in
// ops/plan.py (a CPU test compares them).

#pragma once
#include <cstdint>

namespace ktpu {

// ---- global header
enum Header {
  H_C = 0, H_X = 1, H_R = 2, H_KMAX = 3, H_NTILES = 4, H_TILES = 5,
  H_NHEADER = 6,
};

// ---- tile table: [NTILES, TT_NCOLS] int32, global ids; [lo, hi) ranges;
// TT_NCHK and TT_NAUX count the section's distinct check and aux rows
enum TileCol {
  TT_R0 = 0, TT_R1 = 1, TT_C0 = 2, TT_C1 = 3, TT_X0 = 4, TT_X1 = 5,
  TT_GATE0 = 6, TT_GATE1 = 7, TT_SLOT0 = 8, TT_SLOT1 = 9, TT_NPATH = 10,
  TT_OFF = 11, TT_WORDS = 12, TT_NCHK = 13, TT_NAUX = 14, TT_NCOLS = 15,
};

// ---- a block's shared memory: per resolved slot SM_SLOT_LANES words per
// resource; per check row SM_CHECK_MASKS masks, per aux row SM_AUX_MASKS,
// per condition slot SM_COND_WORDS masks per element, per rule
// SM_RULE_MASKS (a host-only rule's kind prefilter); a mask is one 32-bit
// word per 32 resources of the group; each array starts on SM_ALIGN bytes
// (layout() below; ops/plan.py tile_bytes mirrors it)
enum SmemLayout {
  SM_SLOT_LANES = 7, SM_CHECK_MASKS = 4, SM_AUX_MASKS = 3, SM_COND_WORDS = 3,
  SM_RULE_MASKS = 1, SM_ALIGN = 16,
};

// ---- tile section header
enum Section {
  TS_C = 0, TS_X = 1, TS_R = 2, TS_NGATES = 3, TS_NPATH = 4,
  TS_CHK = 5, TS_AUX = 6, TS_PATHS = 7, TS_GATE_PTR = 8, TS_GATE_GRP = 9,
  TS_GRP_PTR = 10, TS_GRP_ROW = 11, TS_PAT_PTR = 12, TS_PAT = 13,
  TS_RULE_FLAGS = 14, TS_RULE_KINDS = 15, TS_AUXP_PTR = 16, TS_AUXP = 17,
  TS_AXG_PTR = 18, TS_AXG_ROW = 19, TS_AXG_INFO = 20, TS_NHEADER = 21,
};

// ---- a rule's pattern entries (TS_PAT), in alternative then group order:
// (local check row << PE_SHIFT) | bits. The last row of a group carries
// PE_GROUP_END, the last entry of an alternative PE_ALT_END (and PE_MULTI
// if the rule has several alternatives); an alternative with no rows is
// one PE_NOROW entry. A group with no rows adds nothing and has no entry.
enum PatEntry {
  PE_PLAIN = 1, PE_COND = 2, PE_TRACKED = 4, PE_GROUP_END = 8,
  PE_ALT_END = 16, PE_MULTI = 32, PE_NOROW = 64, PE_SHIFT = 8,
};

// ---- a rule's aux-group entries (TS_AUXP): (local aux group << AE_SHIFT)
// | bits, each of the rule's groups once, its filters' groups first, filter
// by filter. The last group of a filter carries AE_FILT_END (and
// AE_FILT_EX for an exclude filter); a filter with no groups is one
// AE_NOGROUP entry.
enum AuxEntry {
  AE_FILTER = 1, AE_FILT_END = 2, AE_FILT_EX = 4, AE_NOGROUP = 8,
  AE_SHIFT = 8,
};

// ---- check table columns: one row per check
enum CheckCol {
  CK_PATH = 0, CK_OP = 1, CK_PLEN = 2, CK_GUARD = 3, CK_NFA = 4,
  CK_HAS_NFA = 5, CK_LO_H = 6, CK_LO_L = 7, CK_HI_H = 8, CK_HI_L = 9,
  CK_BOOL = 10, CK_NUMFB = 11, CK_NUMMODE = 12, CK_GATE = 13,
  CK_IS_GATE = 14, CK_IS_COND = 15, CK_EXIST = 16, CK_TRACK = 17,
  CK_COND_DEPTH = 18, CK_COND_SLOT = 19, CK_NCOLS = 20,
};

// ---- aux table columns: one row per aux primitive
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

// ---- per-(b, c) check flags and per-(b, x) aux flags: what stages 2-3
// hand to stages 4-6 (in shared memory in the kernel; returned by the
// plain versions)
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

// The sizes of one rule tile (one row of the tile table) that set its
// block's shared memory: checks and aux count the distinct rows.
struct TileDims {
  int words, paths, checks, aux, rules, gates, cond;
};

__host__ __device__ inline TileDims tile_dims(const int32_t* tt) {
  TileDims d;
  d.words = tt[TT_WORDS];
  d.paths = tt[TT_NPATH];
  d.checks = tt[TT_NCHK];
  d.aux = tt[TT_NAUX];
  d.rules = tt[TT_R1] - tt[TT_R0];
  d.gates = tt[TT_GATE1] - tt[TT_GATE0];
  d.cond = tt[TT_SLOT1] - tt[TT_SLOT0];
  return d;
}

// Byte offsets of a block's arrays in dynamic shared memory, for a tile
// of these sizes, E slots per path and groups of tb resources (a mask of
// tb <= 32 resources is one word, of more tb / 32 words).
struct Layout {
  int plan, slots, bmeta, gate, cond, cflags, xflags, rkind, total;
};

__host__ __device__ inline int align_smem(int n) {
  return (n + SM_ALIGN - 1) & ~(SM_ALIGN - 1);
}

__host__ __device__ inline Layout layout(const TileDims& d, int E, int tb) {
  Layout L;
  const int w = (tb + 31) / 32;
  int o = 0;
  L.plan = o;   o += align_smem(d.words * 4);
  L.slots = o;  o += align_smem(SM_SLOT_LANES * d.paths * E * tb * 4);
  L.bmeta = o;  o += align_smem(tb * 4);
  L.gate = o;   o += align_smem(d.gates * tb * 4);
  L.cond = o;   o += align_smem(d.cond * SM_COND_WORDS * E * w * 4);
  L.cflags = o; o += align_smem(d.checks * SM_CHECK_MASKS * w * 4);
  L.xflags = o; o += align_smem(d.aux * SM_AUX_MASKS * w * 4);
  L.rkind = o;  o += align_smem(d.rules * SM_RULE_MASKS * w * 4);
  L.total = o;
  return L;
}

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

// One decoded slot: the per-cell lanes of flatten.unpack_batch, gathered
// from the dictionary row the cell names, plus the two dictionary bits
// the checks and aux rows read (empty string, key holds a glob).
struct Slot {
  int mask, type, sid, elem0;
  bool valid, nbrk, nint;
  int numh, numl, durh, durl;
  bool numok, nplain, durok, durany, boolv, empty, keyglob;
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
  s.empty = present && (d4 & 0x7Fu) == 0;
  s.keyglob = present && ((d4 >> 7) & 1u);
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
