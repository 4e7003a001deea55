"""Resource batch -> leaf tensors.

For every path in the compiled dictionary, enumerate the resource's slots
(the wildcard expansion of the path), recording per slot:

- ``mask``      prefix-presence bits (bit k = first k segments present on
                this chain). ``leaf present`` is bit len(segments).
- a *phantom slot* marks a broken chain (some map key absent): this is what
  distinguishes "missing key -> pattern FAIL" from "empty array -> vacuous
  PASS" (validate.go DefaultHandler vs validateArrayOfMaps over []).
- value features: type tag, interned string id (values stringify the Go way
  for wildcard comparison, pattern.go:309), i64 micro-units for anything
  quantity-parseable, plain-float/int flags and duration micro-seconds for
  the condition operators (variables/operator/*.go), bool value, and the
  top-level element index for gate alignment.

Paths rooted at ir.REQ_MARK resolve against the per-resource *request
envelope* (operation, namespace, userInfo — admission context) instead of
the resource body; ir.NSEFF_MARK resolves to the effective namespace
(resource name for Namespace kinds, utils.go checkNamespace).

Strings are interned into a per-batch dictionary; the NFA kernel matches
patterns against the *dictionary* once and verdicts gather by id — the
dedup that makes the string path cheap on device.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

import numpy as np

from ..runtime import featureplane
from ..utils.duration import DurationError, parse_duration
from ..utils.gofmt import value_to_string_for_equality
from ..utils.quantity import QuantityError, parse_quantity
from .compiler import STR_LEN, PolicyTensors
from .ir import NSEFF_MARK, NUM_MAX, NUM_SCALE, REQ_MARK, SEP

# type tags
T_ABSENT, T_NULL, T_BOOL, T_NUM, T_STR, T_OBJ, T_LIST = range(7)

# Canonical lane order. BATCH_ARRAYS are [B, ...]; DICT_ARRAYS are
# per-batch string-dictionary tables. Bucket padding and the unpacked lane
# tuple both derive from these two tuples — one source of truth.
BATCH_ARRAYS = (
    "mask", "slot_valid", "null_break", "type_tag", "str_id",
    "num_hi", "num_lo", "num_ok", "num_plain", "num_int",
    "dur_hi", "dur_lo", "dur_ok", "dur_any", "bool_val",
    "elem0", "kind_id", "host_flag", "live",
)
DICT_ARRAYS = ("str_bytes", "str_len", "str_has_glob")

# Packed transfer format. The 16 per-cell lanes compress into two uint32
# words per cell, because every *value* lane (num/dur/bool) is a pure
# function of the interned string: those move to a [V, 5] dictionary table
# gathered back by str_id on device. The per-cell words:
#   word0: str_id + 1                     (0 = no interned string)
#   word1: mask(16) | type_tag(3)<<16 | slot_valid<<19 | null_break<<20
#          | num_int<<21 | (elem0 + 1)<<22   (8 bits; > ELEM0_CAP -> host)
# and one uint32 per resource:
#   bmeta: (kind_id + 1)(16) | host_flag<<16 | live<<17
# The dictionary value table [V, 5] uint32:
#   d0: num_lo(31) | num_ok<<31        d1: num_hi (two's complement)
#   d2: dur_lo(31) | dur_ok<<31        d3: dur_hi (two's complement)
#   d4: str_len(7) | has_glob<<7 | bool_val<<8 | dur_any<<9 | num_plain<<10
# About 8 bytes a cell over 4 arrays instead of ~35 over 19: the packed
# blob is what crosses to the card, and the check kernel decodes it in
# place (ops/eval.py).
ELEM0_CAP = 254  # largest representable first-element index

# Pad fill-value table for batch padding. Lanes that encode ids as row
# indices pad with -1 ("no entry"); everything else pads with the natural
# zero (dead slot / not live).
PAD_FILL = {"kind_id": -1, "str_id": -1, "elem0": -1}


def pad_fill(name: str) -> int:
    """Fill value for padding lane ``name`` (BATCH_ARRAYS / DICT_ARRAYS /
    num_val); unlisted lanes zero-fill."""
    return PAD_FILL.get(name, 0)


def _assemble_blob(cells, bmeta, str_bytes, dictv):
    """Concatenate the packed arrays into one uint32 transfer buffer.
    ops.eval._split_blob is the device-side inverse."""
    B, P, E = cells.shape[:3]
    V = int(dictv.shape[0])
    sw = np.ascontiguousarray(str_bytes).view(np.uint32)
    blob = np.concatenate([
        cells.reshape(-1), bmeta.reshape(-1),
        dictv.reshape(-1), sw.reshape(-1),
    ])
    return blob, (B, P, E, V)


@dataclass
class FlatBatch:
    n: int                    # batch size
    e: int                    # slots per path
    mask: np.ndarray          # [B, P, E] uint16 prefix bits
    slot_valid: np.ndarray    # [B, P, E] bool
    null_break: np.ndarray    # [B, P, E] bool — chain broke at a non-dict
                              # node (null/scalar/list parent): JMESPath
                              # field access yields null, NOT a missing-key
                              # error (engine/jmespath/interpreter._field)
    type_tag: np.ndarray      # [B, P, E] int8
    str_id: np.ndarray        # [B, P, E] int32 (-1 none)
    num_val: np.ndarray       # [B, P, E] int64 (host-side reference)
    num_hi: np.ndarray        # [B, P, E] int32 high limb (value >> 31)
    num_lo: np.ndarray        # [B, P, E] int32 low limb (value & 0x7FFFFFFF)
    num_ok: np.ndarray        # [B, P, E] bool (k8s-quantity-parseable)
    num_plain: np.ndarray     # [B, P, E] bool (plain strconv float)
    num_int: np.ndarray       # [B, P, E] bool (python/Go int value)
    dur_hi: np.ndarray        # [B, P, E] int32 duration micro-seconds limbs
    dur_lo: np.ndarray        # [B, P, E] int32
    dur_ok: np.ndarray        # [B, P, E] bool (duration-parseable, not "0")
    dur_any: np.ndarray       # [B, P, E] bool (duration-parseable incl "0")
    bool_val: np.ndarray      # [B, P, E] bool
    elem0: np.ndarray         # [B, P, E] int32 top-level element index (-1)
    kind_id: np.ndarray       # [B] int32 (-1 unknown kind)
    host_flag: np.ndarray     # [B] bool — needs the CPU oracle
    live: np.ndarray          # [B] bool — real resource (False = pad row;
                              # a real resource may legitimately have zero
                              # valid slots when every path crosses an
                              # empty array, so liveness is explicit)
    # string dictionary
    str_bytes: np.ndarray     # [V, STR_LEN] uint8
    str_len: np.ndarray       # [V] int32
    str_has_glob: np.ndarray  # [V] bool ('*' or '?' byte present)
    strings: list[str]

    def packed_args(self) -> tuple:
        """(cells, bmeta, str_bytes, dictv) — the transfer-thin form (see
        the packed transfer format above). Cached: repeated evaluations of
        one FlatBatch pack once."""
        packed = getattr(self, "_packed", None)
        if packed is None:
            packed = pack_batch(self)
            object.__setattr__(self, "_packed", packed)
        return packed

    def packed_blob(self) -> tuple[np.ndarray, tuple[int, int, int, int]]:
        """One contiguous uint32 buffer + (B, P, E, V) shape: the single
        host->device copy the device evaluation reads (ops/eval.py)."""
        blob = getattr(self, "_blob", None)
        if blob is None:
            blob = _assemble_blob(*self.packed_args())
            object.__setattr__(self, "_blob", blob)
        return blob

    def to_flat(self) -> "FlatBatch":
        return self


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_to_buckets(batch: FlatBatch) -> tuple["FlatBatch", int]:
    """Pad the data-dependent axes (batch B, slots-per-path E, dictionary V)
    up to powers of two, so batches of nearby sizes share one shape
    *bucket*. Padded batch rows carry
    ``live=False``; padded slots carry ``slot_valid=False`` (the natural
    encoding for unused slots); padded dictionary rows are never gathered
    because no slot references their ids. Returns (padded, original_n)."""
    from dataclasses import replace

    b, e = batch.n, batch.e
    v = int(batch.str_len.shape[0])
    b2, e2, v2 = _next_pow2(b), _next_pow2(e), _next_pow2(v)
    if (b2, e2, v2) == (b, e, v):
        return batch, b

    updates: dict = {"n": b2, "e": e2}
    for name in BATCH_ARRAYS + ("num_val",):
        x = getattr(batch, name)
        width = [(0, b2 - b)] + [(0, 0)] * (x.ndim - 1)
        if x.ndim == 3:
            width[2] = (0, e2 - e)
        updates[name] = np.pad(x, width, constant_values=pad_fill(name))
    for name in DICT_ARRAYS:
        x = getattr(batch, name)
        width = [(0, v2 - v)] + [(0, 0)] * (x.ndim - 1)
        updates[name] = np.pad(x, width, constant_values=0)
    return replace(batch, **updates), b


def pack_batch(batch: FlatBatch) -> tuple:
    """Compress a FlatBatch into the packed transfer form
    (cells uint32 [B,P,E,2], bmeta uint32 [B], str_bytes, dictv uint32 [V,5]).

    The dictionary value rows are scattered from the cell lanes rather than
    re-analyzed from the strings: within one batch every cell referencing a
    dictionary row agrees on that row's value lanes for its type class
    (num lanes are shared by T_NUM/T_STR referents — a JSON number and the
    equal string intern the same text and micro value; dur lanes are set
    only by T_STR cells; bool only by T_BOOL), so last-write-wins is exact.
    Rows referenced by no cell of a class leave that class's bits zero, and
    the device unpack gates each class by type_tag, so the bits are never
    read. Resources whose elem0 exceeds ELEM0_CAP take the host lane (the
    oracle re-walks the original document, so capping is correct)."""
    u32 = np.uint32
    sid_w = (batch.str_id.astype(np.int64) + 1).astype(u32)
    e0 = batch.elem0.astype(np.int64)
    e0_over = e0 > ELEM0_CAP - 1
    e0_w = np.minimum(e0 + 1, 255).astype(u32)
    meta = (
        batch.mask.astype(u32)
        | (batch.type_tag.astype(u32) << 16)
        | (batch.slot_valid.astype(u32) << 19)
        | (batch.null_break.astype(u32) << 20)
        | (batch.num_int.astype(u32) << 21)
        | (e0_w << 22)
    )
    cells = np.stack([sid_w, meta], axis=-1)

    # a numeric/duration value on a string too long to intern has no
    # dictionary row to carry it — route the resource to the CPU oracle
    # (mirrors ktpu_flatten_packed's long-text handling)
    lost = ((batch.num_ok | batch.dur_any) & (batch.str_id < 0)).any(axis=(1, 2))
    host = batch.host_flag | e0_over.any(axis=(1, 2)) | lost
    bmeta = (
        (batch.kind_id.astype(np.int64) + 1).astype(u32)
        | (host.astype(u32) << 16)
        | (batch.live.astype(u32) << 17)
    )

    V = int(batch.str_len.shape[0])
    d = np.zeros((V, 5), dtype=u32)
    sid = batch.str_id.ravel()
    tag = batch.type_tag.ravel()
    ref = sid >= 0

    numsel = ref & ((tag == T_NUM) | (tag == T_STR))
    i = sid[numsel]
    d[i, 0] = (batch.num_lo.ravel()[numsel].astype(np.int64) & 0x7FFFFFFF).astype(u32) \
        | (batch.num_ok.ravel()[numsel].astype(u32) << 31)
    d[i, 1] = batch.num_hi.ravel()[numsel].astype(u32)
    plain = np.zeros(V, dtype=u32)
    plain[i] = batch.num_plain.ravel()[numsel].astype(u32)

    dursel = ref & (tag == T_STR)
    i = sid[dursel]
    d[i, 2] = (batch.dur_lo.ravel()[dursel].astype(np.int64) & 0x7FFFFFFF).astype(u32) \
        | (batch.dur_ok.ravel()[dursel].astype(u32) << 31)
    d[i, 3] = batch.dur_hi.ravel()[dursel].astype(u32)
    durany = np.zeros(V, dtype=u32)
    durany[i] = batch.dur_any.ravel()[dursel].astype(u32)

    boolv = np.zeros(V, dtype=u32)
    boolsel = ref & (tag == T_BOOL)
    i = sid[boolsel]
    boolv[i] = batch.bool_val.ravel()[boolsel].astype(u32)

    d[:, 4] = (
        batch.str_len.astype(u32)
        | (batch.str_has_glob.astype(u32) << 7)
        | (boolv << 8)
        | (durany << 9)
        | (plain << 10)
    )
    return cells, bmeta, batch.str_bytes, d


def unpack_batch(cells, bmeta, str_bytes, dictv, xp=np):
    """Inverse of pack_batch: reconstruct the 22 evaluation lanes on the
    host (numpy). On the card the same decode is fused into the check
    kernel's loads (ops/eval.py)."""
    w0 = cells[..., 0]
    meta = cells[..., 1]
    str_id = w0.astype(xp.int32) - 1
    mask = (meta & 0xFFFF).astype(xp.uint16)
    type_tag = ((meta >> 16) & 7).astype(xp.int8)
    slot_valid = ((meta >> 19) & 1).astype(bool)
    null_break = ((meta >> 20) & 1).astype(bool)
    num_int = ((meta >> 21) & 1).astype(bool)
    elem0 = ((meta >> 22) & 0xFF).astype(xp.int32) - 1

    sid_safe = xp.maximum(str_id, 0)
    present = str_id >= 0
    tag_i = type_tag.astype(xp.int32)
    is_numlike = (tag_i == T_NUM) | (tag_i == T_STR)
    is_str = tag_i == T_STR
    is_bool = tag_i == T_BOOL

    def gather(col):
        return xp.take(dictv[:, col], sid_safe)

    d0, d1, d2, d3, d4 = (gather(c) for c in range(5))
    num_ok = ((d0 >> 31) & 1).astype(bool) & present & is_numlike
    num_lo = xp.where(num_ok, (d0 & 0x7FFFFFFF).astype(xp.int32), 0)
    num_hi = xp.where(num_ok, d1.astype(xp.int32), 0)
    num_plain = ((d4 >> 10) & 1).astype(bool) & present & is_numlike
    dur_any = ((d4 >> 9) & 1).astype(bool) & present & is_str
    dur_ok = ((d2 >> 31) & 1).astype(bool) & present & is_str
    dur_lo = xp.where(dur_any, (d2 & 0x7FFFFFFF).astype(xp.int32), 0)
    dur_hi = xp.where(dur_any, d3.astype(xp.int32), 0)
    bool_val = ((d4 >> 8) & 1).astype(bool) & present & is_bool
    num_int = num_int & is_numlike

    kind_id = (bmeta & 0xFFFF).astype(xp.int32) - 1
    host_flag = ((bmeta >> 16) & 1).astype(bool)
    live = ((bmeta >> 17) & 1).astype(bool)
    str_len = (dictv[:, 4] & 0x7F).astype(xp.int32)
    str_has_glob = ((dictv[:, 4] >> 7) & 1).astype(bool)
    return (mask, slot_valid, null_break, type_tag, str_id, num_hi, num_lo,
            num_ok, num_plain, num_int, dur_hi, dur_lo, dur_ok, dur_any,
            bool_val, elem0, kind_id, host_flag, live,
            str_bytes, str_len, str_has_glob)


@dataclass
class PackedBatch:
    """Flattened batch in the packed transfer form (cells [B,P,E,2]
    uint32, bmeta [B] uint32, str_bytes [V,STR_LEN] uint8, dictv [V,5]
    uint32) — the native flattener's direct output (ktpu_flatten_packed)
    and what ``convert.batch_from_numpy`` hands to the engine. Carries
    exactly what the device kernels consume; the 22 unpacked lanes and
    the decoded string list materialize lazily for oracle/debug
    consumers."""

    n: int
    e: int
    cells: np.ndarray         # [B, P, E, 2] uint32
    bmeta: np.ndarray         # [B] uint32
    str_bytes: np.ndarray     # [V, STR_LEN] uint8
    dictv: np.ndarray         # [V, 5] uint32

    def packed_args(self) -> tuple:
        return (self.cells, self.bmeta, self.str_bytes, self.dictv)

    def packed_blob(self) -> tuple[np.ndarray, tuple[int, int, int, int]]:
        blob = getattr(self, "_blob", None)
        if blob is None:
            blob = _assemble_blob(*self.packed_args())
            object.__setattr__(self, "_blob", blob)
        return blob

    @property
    def strings(self) -> list[str]:
        out = getattr(self, "_strings", None)
        if out is None:
            lens = self.dictv[:, 4] & 0x7F
            out = [
                bytes(self.str_bytes[i, : lens[i]]).decode(
                    "utf-8", "surrogateescape")
                for i in range(int(self.dictv.shape[0]))
            ]
            object.__setattr__(self, "_strings", out)
        return out

    def to_flat(self) -> "FlatBatch":
        """Unpack into the eager lane form (tests, host-side consumers)."""
        flat = getattr(self, "_flat", None)
        if flat is None:
            lanes = unpack_batch(self.cells, self.bmeta, self.str_bytes,
                                 self.dictv, xp=np)
            kw = dict(zip(BATCH_ARRAYS + DICT_ARRAYS, lanes))
            num_val = (kw["num_hi"].astype(np.int64) << 31) | kw["num_lo"]
            flat = FlatBatch(n=self.n, e=self.e, num_val=num_val,
                             strings=self.strings, **kw)
            object.__setattr__(self, "_flat", flat)
        return flat


def pad_packed(cells: np.ndarray, bmeta: np.ndarray,
               multiple: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad the packed batch axis to a multiple of ``multiple``. Zero fill
    is the natural dead encoding: sid word 0 = no string, meta 0 = invalid
    slot, bmeta 0 = unknown kind + not live."""
    b = cells.shape[0]
    padded = (b + multiple - 1) // multiple * multiple
    if padded == b:
        return cells, bmeta, b
    pad = padded - b
    cells = np.pad(cells, [(0, pad)] + [(0, 0)] * (cells.ndim - 1))
    bmeta = np.pad(bmeta, (0, pad))
    return cells, bmeta, b


def pad_to_buckets_packed(batch: PackedBatch) -> tuple[PackedBatch, int]:
    """Power-of-two bucket padding for the packed form (zero fill = dead
    rows/slots/strings). Returns (padded, original_n)."""
    B, P, E, _ = batch.cells.shape
    V = int(batch.dictv.shape[0])
    b2, e2, v2 = _next_pow2(B), _next_pow2(E), _next_pow2(max(1, V))
    if (b2, e2, v2) == (B, E, V):
        return batch, B
    cells = np.pad(batch.cells, [(0, b2 - B), (0, 0), (0, e2 - E), (0, 0)])
    bmeta = np.pad(batch.bmeta, (0, b2 - B))
    dictv = np.pad(batch.dictv, [(0, v2 - V), (0, 0)])
    str_bytes = np.pad(batch.str_bytes, [(0, v2 - V), (0, 0)])
    return PackedBatch(n=b2, e=e2, cells=cells, bmeta=bmeta,
                       str_bytes=str_bytes, dictv=dictv), B


def pipeline_enabled() -> bool:
    """KTPU_FLATTEN_PIPELINE=0 kill-switch: read dynamically at every use
    site so an operator (or a test monkeypatching os.environ) can drop the
    admission flush (its row memo) and the scan pipeline back to the
    serial dataflow without a restart."""
    return featureplane.enabled("KTPU_FLATTEN_PIPELINE")


def merge_packed(chunks: list[PackedBatch]) -> PackedBatch:
    """Concatenate independently-flattened PackedBatches (the chunked
    multi-worker native flatten) into one batch: slot axes pad up to the
    widest chunk and the per-chunk string tables re-intern into a shared
    one keyed by (bytes, length), OR-merging the dictionary rows."""
    if len(chunks) == 1:
        return chunks[0]
    B = sum(int(c.n) for c in chunks)
    P = int(chunks[0].cells.shape[1])
    E = max(1, max(int(c.e) for c in chunks))
    cells = np.zeros((B, P, E, 2), dtype=np.uint32)
    bmeta = np.zeros(B, dtype=np.uint32)
    index: dict[tuple[bytes, int], int] = {}
    sb_rows: list[np.ndarray] = []
    dv_rows: list[np.ndarray] = []
    at = 0
    for c in chunks:
        c_sb, c_dv = np.asarray(c.str_bytes), np.asarray(c.dictv)
        v = int(c_dv.shape[0])
        lut = np.zeros(v + 1, dtype=np.uint32)
        for i in range(v):
            key = (c_sb[i].tobytes(), int(c_dv[i, 4] & 0x7F))
            j = index.get(key)
            if j is None:
                j = len(sb_rows)
                index[key] = j
                sb_rows.append(c_sb[i])
                dv_rows.append(c_dv[i].copy())
            else:
                dv_rows[j] |= c_dv[i]
            lut[i + 1] = j + 1
        cc = np.asarray(c.cells)
        n, e = int(c.n), int(cc.shape[2])
        cells[at:at + n, :, :e, 0] = lut[cc[:n, :, :, 0]]
        cells[at:at + n, :, :e, 1] = cc[:n, :, :, 1]
        bmeta[at:at + n] = np.asarray(c.bmeta)[:n]
        at += n
    str_bytes = np.stack(sb_rows).astype(np.uint8) if sb_rows else \
        np.zeros((1, STR_LEN), dtype=np.uint8)
    dictv = np.stack(dv_rows).astype(np.uint32) if dv_rows else \
        np.zeros((1, 5), dtype=np.uint32)
    return PackedBatch(n=B, e=E, cells=cells, bmeta=bmeta,
                       str_bytes=str_bytes, dictv=dictv)


# ------------------------------------------------------------ row memo
#
# The flatten-row memo of the admission batcher and the delta scanner:
# a batch splits into per-resource rows on private string tables, rows
# are memoized with the dictionary coordinates they were cut at, and a
# flush splices memo hits with a fresh flatten of the misses. The
# continuous lane grafts late arrivals into a padded batch's headroom.


@dataclass
class PackedRow:
    """One resource's slice of a PackedBatch, rebased onto a private
    string table — the unit of the flatten-row memo (runtime/resourcecache
    FlattenRowCache). ``cells`` is trimmed to the row's own slot count and
    ``str_bytes``/``dictv`` keep only the rows this resource references,
    so a memoized row costs O(own content), not O(original batch)."""

    cells: np.ndarray       # [P, e_row, 2] uint32, w0 rebased to local ids
    bmeta: int              # uint32 scalar
    str_bytes: np.ndarray   # [v, STR_LEN] uint8 (may be empty)
    dictv: np.ndarray       # [v, 5] uint32

    @property
    def nbytes(self) -> int:
        return self.cells.nbytes + self.str_bytes.nbytes + self.dictv.nbytes


@dataclass
class MemoRow:
    """Epoch-keyed flatten-row memo entry: a PackedRow plus the dictionary
    coordinates it was flattened at. Rows compiled at epoch *e* over
    ``n_paths`` paths remain spliceable at any epoch *e' >= e* of the same
    lineage because the dictionary only appends — the row is a valid
    prefix, and :func:`refresh_packed_row` flattens just the appended
    paths and concatenates. This is what lets a policy edit keep the
    flatten work for every cached resource instead of evicting it."""

    row: PackedRow
    n_paths: int              # path-dictionary length at flatten time
    epoch: int                # TensorDictionary.epoch at flatten time


class _PathSlice:
    """Minimal tensors view for :func:`flatten_batch`: the appended tail
    of the path dictionary plus the (full, append-only) kind index."""

    __slots__ = ("paths", "kind_index")

    def __init__(self, paths: list[str], kind_index: dict[str, int]):
        self.paths = paths
        self.kind_index = kind_index

    @property
    def n_paths(self) -> int:
        return len(self.paths)


def _extend_row(row: PackedRow, delta: PackedRow) -> PackedRow:
    """Concatenate a row's cells with a delta-flattened tail along the
    path axis, re-interning the delta's private string table into the
    row's (same (bytes, length) key + OR-merge as splice_packed_rows).
    The delta's bmeta wins the kind bits (computed against the current
    kind index) and ORs its host flag — host conditions are per-slot ORs,
    so the union over path subsets equals the full-flatten flag."""
    p0, e0 = int(row.cells.shape[0]), int(row.cells.shape[1])
    p1, e1 = int(delta.cells.shape[0]), int(delta.cells.shape[1])
    E = max(e0, e1)
    cells = np.zeros((p0 + p1, E, 2), dtype=np.uint32)
    cells[:p0, :e0] = row.cells

    index: dict[tuple[bytes, int], int] = {}
    v0 = int(row.dictv.shape[0])
    sb_rows = [row.str_bytes[i] for i in range(v0)]
    dv_rows = [row.dictv[i].copy() for i in range(v0)]
    for i in range(v0):
        index[(row.str_bytes[i].tobytes(), int(row.dictv[i, 4] & 0x7F))] = i
    v1 = int(delta.dictv.shape[0])
    lut = np.zeros(v1 + 1, dtype=np.uint32)
    for i in range(v1):
        key = (delta.str_bytes[i].tobytes(), int(delta.dictv[i, 4] & 0x7F))
        j = index.get(key)
        if j is None:
            j = len(sb_rows)
            index[key] = j
            sb_rows.append(delta.str_bytes[i])
            dv_rows.append(delta.dictv[i].copy())
        else:
            dv_rows[j] |= delta.dictv[i]
        lut[i + 1] = j + 1
    cells[p0:, :e1, 0] = lut[delta.cells[..., 0]]
    cells[p0:, :e1, 1] = delta.cells[..., 1]

    old_host = (row.bmeta >> 16) & 1
    old_live = (row.bmeta >> 17) & 1
    bmeta = int((delta.bmeta & 0x1FFFF) | ((old_host | old_live << 1) << 16))
    if sb_rows:
        str_bytes = np.stack(sb_rows).astype(np.uint8)
        dictv = np.stack(dv_rows).astype(np.uint32)
    else:
        str_bytes = np.zeros((0, STR_LEN), dtype=np.uint8)
        dictv = np.zeros((0, 5), dtype=np.uint32)
    return PackedRow(cells=np.ascontiguousarray(cells), bmeta=bmeta,
                     str_bytes=str_bytes, dictv=dictv)


def flatten_one_row(resource: dict, tensors, request: dict | None = None,
                    max_slots: int = 16) -> PackedRow:
    """Flatten one resource against ``tensors`` (any object with paths /
    kind_index / n_paths) straight to a PackedRow — the pure-Python
    single-row path used by memo refresh and the delta scanner."""
    fb = flatten_batch([resource], tensors, max_slots=max_slots,
                       requests=[request] if request is not None else None)
    cells, bmeta, str_bytes, dictv = pack_batch(fb)
    return split_packed_rows(PackedBatch(
        n=1, e=fb.e, cells=cells, bmeta=bmeta,
        str_bytes=str_bytes, dictv=dictv))[0]


def refresh_packed_row(memo: MemoRow, resource: dict,
                       tensors: PolicyTensors,
                       request: dict | None = None) -> tuple[MemoRow | None, bool]:
    """Revalidate a memoized flatten row against the current tensor set
    of its lineage. Returns ``(memo_row, extended)``:

    - exact epoch/path match -> the memo unchanged, ``extended=False``;
    - dictionary appended since the row was cut -> flatten only the
      appended paths, concatenate, recompute the kind bits against the
      current kind index, return the refreshed entry with
      ``extended=True`` (still a survival — the per-path work for the old
      prefix was not redone);
    - the memo is from a *longer* dictionary (foreign lineage, or a
      lineage reset) -> ``(None, False)``: caller re-flattens."""
    n_new = tensors.n_paths
    if memo.epoch == tensors.dict_epoch and memo.n_paths == n_new:
        return memo, False
    if memo.n_paths > n_new:
        return None, False
    row = memo.row
    if n_new > memo.n_paths:
        delta = flatten_one_row(
            resource,
            _PathSlice(tensors.paths[memo.n_paths:], tensors.kind_index),
            request=request)
        row = _extend_row(row, delta)
    else:
        # only the kind index appended: recompute the kind bits (the id
        # of a previously-unknown kind may exist now); host/live keep
        kind = (resource.get("kind") or "") if isinstance(resource, dict) else ""
        kid = tensors.kind_index.get(kind, -1)
        bmeta = int((row.bmeta & ~np.uint32(0xFFFF)) | np.uint32(kid + 1))
        row = PackedRow(cells=row.cells, bmeta=bmeta,
                        str_bytes=row.str_bytes, dictv=row.dictv)
    return MemoRow(row=row, n_paths=n_new, epoch=tensors.dict_epoch), True


def split_packed_rows(batch: PackedBatch) -> list[PackedRow]:
    """Decompose a freshly-flattened PackedBatch into per-resource rows.

    Per row the trailing all-zero slot columns are trimmed (zero fill is
    the dead encoding, so they are pure padding) and word0 string ids are
    rebased through a per-row LUT onto a compact private table. The
    inverse is splice_packed_rows; split→splice of every row reproduces
    the batch's verdicts exactly (dictionary value lanes are pure
    functions of the interned string and class-gated on read, so the
    re-merged table can only differ in lanes the kernels never read)."""
    from ..runtime import tracing

    _t0 = time.perf_counter()
    cells, bmeta = np.asarray(batch.cells), np.asarray(batch.bmeta)
    str_bytes, dictv = np.asarray(batch.str_bytes), np.asarray(batch.dictv)
    rows: list[PackedRow] = []
    for b in range(int(batch.n)):
        rc = cells[b]                             # [P, E, 2]
        used = rc.any(axis=2).any(axis=0)         # [E] slot columns in use
        e_row = int(np.max(np.nonzero(used)[0]) + 1) if used.any() else 0
        rc = rc[:, :e_row, :]
        w0 = rc[..., 0]
        ids = np.unique(w0)
        ids = (ids[ids > 0] - 1).astype(np.int64)
        lut = np.zeros(int(dictv.shape[0]) + 1, dtype=np.uint32)
        lut[ids + 1] = np.arange(1, len(ids) + 1, dtype=np.uint32)
        rc = np.stack([lut[w0], rc[..., 1]], axis=-1)
        rows.append(PackedRow(
            cells=np.ascontiguousarray(rc),
            bmeta=int(bmeta[b]),
            str_bytes=np.ascontiguousarray(str_bytes[ids]),
            dictv=np.ascontiguousarray(dictv[ids]),
        ))
    tracing.recorder().add_span(
        tracing.current(), "row_split", _t0, time.perf_counter(),
        rows=len(rows))
    return rows


def splice_packed_rows(rows: list[PackedRow]) -> PackedBatch:
    """Reassemble memoized PackedRows into one PackedBatch: re-intern each
    row's private string table into a shared batch table and remap word0
    through the resulting LUT. Strings are keyed by (padded bytes, length)
    — the length disambiguates texts whose UTF-8 ends in NUL bytes —
    and duplicate dictionary rows merge by elementwise OR, which is exact
    because value lanes are pure functions of the string (lanes set by two
    rows agree; lanes set by neither stay zero)."""
    from ..runtime import tracing

    _t0 = time.perf_counter()
    B = len(rows)
    P = int(rows[0].cells.shape[0]) if B else 0
    E = max([int(r.cells.shape[1]) for r in rows], default=0)
    E = max(E, 1)
    index: dict[tuple[bytes, int], int] = {}
    sb_rows: list[np.ndarray] = []
    dv_rows: list[np.ndarray] = []
    cells = np.zeros((B, P, E, 2), dtype=np.uint32)
    bmeta = np.zeros(B, dtype=np.uint32)
    for b, row in enumerate(rows):
        v = int(row.dictv.shape[0])
        lut = np.zeros(v + 1, dtype=np.uint32)
        for i in range(v):
            key = (row.str_bytes[i].tobytes(), int(row.dictv[i, 4] & 0x7F))
            j = index.get(key)
            if j is None:
                j = len(sb_rows)
                index[key] = j
                sb_rows.append(row.str_bytes[i])
                dv_rows.append(row.dictv[i].copy())
            else:
                dv_rows[j] |= row.dictv[i]
            lut[i + 1] = j + 1
        e_row = int(row.cells.shape[1])
        cells[b, :, :e_row, 0] = lut[row.cells[..., 0]]
        cells[b, :, :e_row, 1] = row.cells[..., 1]
        bmeta[b] = row.bmeta
    V = len(sb_rows)
    if V:
        str_bytes = np.stack(sb_rows).astype(np.uint8)
        dictv = np.stack(dv_rows).astype(np.uint32)
    else:
        str_bytes = np.zeros((1, STR_LEN), dtype=np.uint8)
        dictv = np.zeros((1, 5), dtype=np.uint32)
    tracing.recorder().add_span(
        tracing.current(), "row_splice", _t0, time.perf_counter(), rows=B)
    return PackedBatch(n=B, e=E, cells=cells, bmeta=bmeta,
                       str_bytes=str_bytes, dictv=dictv)


# ---------------------------------------------------------------- wire codec
#
# Columnar wire format of the streaming admission plane
# (runtime/stream_server.py): clients ship pre-tokenized rows and blocks
# in the packed transfer layout, so the server splices them ready for
# the card without parsing JSON or walking the resource again. Integers
# are little-endian; arrays travel as raw C-contiguous buffers in the
# dtypes the kernels read. The bytes are the JAX package's: a frame
# written by either package decodes in the other.

_ROW_HDR = struct.Struct("<IIII")      # P, e_row, v, bmeta
_BLOCK_HDR = struct.Struct("<IIII")    # B, P, E, V


def encode_packed_row(row: PackedRow) -> bytes:
    """Serialize one PackedRow for the stream wire. Inverse of
    :func:`decode_packed_row`; round-trips bit-exactly."""
    p, e = (int(row.cells.shape[0]), int(row.cells.shape[1]))
    v = int(row.dictv.shape[0])
    return b"".join((
        _ROW_HDR.pack(p, e, v, int(row.bmeta) & 0xFFFFFFFF),
        np.ascontiguousarray(row.cells, dtype="<u4").tobytes(),
        np.ascontiguousarray(row.str_bytes, dtype=np.uint8).tobytes(),
        np.ascontiguousarray(row.dictv, dtype="<u4").tobytes(),
    ))


def decode_packed_row(buf, offset: int = 0) -> tuple[PackedRow, int]:
    """Deserialize one PackedRow; returns ``(row, next_offset)``. The
    arrays are read-only views of the input buffer (no copy): every
    consumer (splice, graft) only reads them."""
    p, e, v, bmeta = _ROW_HDR.unpack_from(buf, offset)
    o = offset + _ROW_HDR.size
    cells = np.frombuffer(buf, "<u4", p * e * 2, o).reshape(p, e, 2)
    o += p * e * 2 * 4
    str_bytes = np.frombuffer(buf, np.uint8, v * STR_LEN, o).reshape(
        v, STR_LEN)
    o += v * STR_LEN
    dictv = np.frombuffer(buf, "<u4", v * 5, o).reshape(v, 5)
    o += v * 5 * 4
    return PackedRow(cells=cells, bmeta=int(bmeta), str_bytes=str_bytes,
                     dictv=dictv), o


def encode_packed_block(batch: PackedBatch) -> bytes:
    """Serialize a whole spliced PackedBatch (the wire unit that needs no
    re-intern: the server pads and dispatches it without touching the
    string table)."""
    B, P, E = (int(batch.cells.shape[0]), int(batch.cells.shape[1]),
               int(batch.cells.shape[2]))
    V = int(batch.dictv.shape[0])
    return b"".join((
        _BLOCK_HDR.pack(B, P, E, V),
        np.ascontiguousarray(batch.cells, dtype="<u4").tobytes(),
        np.ascontiguousarray(batch.bmeta, dtype="<u4").tobytes(),
        np.ascontiguousarray(batch.str_bytes, dtype=np.uint8).tobytes(),
        np.ascontiguousarray(batch.dictv, dtype="<u4").tobytes(),
    ))


def decode_packed_block(buf, offset: int = 0) -> tuple[PackedBatch, int]:
    """Inverse of :func:`encode_packed_block`; read-only views of
    ``buf``, no copy."""
    B, P, E, V = _BLOCK_HDR.unpack_from(buf, offset)
    o = offset + _BLOCK_HDR.size
    cells = np.frombuffer(buf, "<u4", B * P * E * 2, o).reshape(B, P, E, 2)
    o += B * P * E * 2 * 4
    bmeta = np.frombuffer(buf, "<u4", B, o)
    o += B * 4
    str_bytes = np.frombuffer(buf, np.uint8, V * STR_LEN, o).reshape(
        V, STR_LEN)
    o += V * STR_LEN
    dictv = np.frombuffer(buf, "<u4", V * 5, o).reshape(V, 5)
    o += V * 5 * 4
    return PackedBatch(n=B, e=E, cells=cells, bmeta=bmeta,
                       str_bytes=str_bytes, dictv=dictv), o


def grow_dict_headroom(batch: PackedBatch,
                       min_free: int = 1) -> PackedBatch:
    """Pad the string table to the next power of two that leaves at
    least ``min_free`` unused rows past the current table size — the
    headroom continuous batching needs so a late-joining row whose
    strings aren't all interned yet can still graft. Zero rows are the
    natural dead encoding (same fill pad_to_buckets_packed uses), so
    the extra slots are invisible to the kernels."""
    from dataclasses import replace

    v = int(batch.dictv.shape[0])
    target = _next_pow2(v + max(1, min_free))
    if target == v:
        return batch
    return replace(
        batch,
        dictv=np.pad(batch.dictv, [(0, target - v), (0, 0)]),
        str_bytes=np.pad(batch.str_bytes, [(0, target - v), (0, 0)]))


def graft_packed_rows(batch: PackedBatch, rows: list[PackedRow],
                      at: int, v_used: int) -> int:
    """Continuous-batching late-join: write ``rows`` into the padding
    slots of an already-padded batch, in place, starting at row ``at``.

    Safe only because padded row slots are fresh zero fill (np.pad always
    copies) and the batch is flush-private. Each row's private string
    table re-interns into the batch dictionary with the same
    (bytes, length) key + elementwise OR-merge as splice_packed_rows
    (exact: value lanes are pure functions of the interned string);
    strings the batch doesn't know yet take free dictionary rows above
    ``v_used`` — the live table size before bucket padding.

    Returns how many leading rows were grafted; stops at the first row
    that doesn't fit (slot width, path count, or dictionary capacity) so
    the caller re-queues the rest in arrival order. Must be called
    before the batch's blob/flat caches materialize."""
    cells = batch.cells
    B, P, E = int(cells.shape[0]), int(cells.shape[1]), int(cells.shape[2])
    V = int(batch.dictv.shape[0])
    index = getattr(batch, "_graft_index", None)
    if index is None:
        index = {}
        for i in range(v_used):
            index[(batch.str_bytes[i].tobytes(),
                   int(batch.dictv[i, 4] & 0x7F))] = i
        object.__setattr__(batch, "_graft_index", index)
    else:
        v_used = getattr(batch, "_graft_vused", v_used)
    grafted = 0
    for row in rows:
        b = at + grafted
        if b >= B:
            break
        p, e_row = int(row.cells.shape[0]), int(row.cells.shape[1])
        if p != P or e_row > E:
            break
        # two-phase intern: count the new strings first so a row that
        # overflows the dictionary leaves the batch untouched
        v = int(row.dictv.shape[0])
        keys = [(row.str_bytes[i].tobytes(), int(row.dictv[i, 4] & 0x7F))
                for i in range(v)]
        fresh = [k for k in keys if k not in index]
        # dict.fromkeys: a row may reference the same new string twice
        fresh = list(dict.fromkeys(fresh))
        if v_used + len(fresh) > V:
            break
        lut = np.zeros(v + 1, dtype=np.uint32)
        for i, key in enumerate(keys):
            j = index.get(key)
            if j is None:
                j = v_used
                index[key] = j
                batch.str_bytes[j] = row.str_bytes[i]
                batch.dictv[j] = row.dictv[i]
                v_used += 1
            else:
                batch.dictv[j] |= row.dictv[i]
            lut[i + 1] = j + 1
        cells[b, :, :e_row, 0] = lut[row.cells[..., 0]]
        cells[b, :, :e_row, 1] = row.cells[..., 1]
        batch.bmeta[b] = np.uint32(int(row.bmeta) & 0xFFFFFFFF)
        grafted += 1
    object.__setattr__(batch, "_graft_vused", v_used)
    # any lazily-built views of the pre-graft content are now stale
    for attr in ("_blob", "_flat", "_strings", "_packed"):
        if getattr(batch, attr, None) is not None:
            object.__delattr__(batch, attr)
    return grafted


class _Interner:
    def __init__(self):
        self.index: dict[str, int] = {}
        self.strings: list[str] = []

    def intern(self, s: str) -> int:
        i = self.index.get(s)
        if i is None:
            i = len(self.strings)
            self.index[s] = i
            self.strings.append(s)
        return i


def _value_to_micro(value) -> int | None:
    try:
        if isinstance(value, bool):
            return None
        if isinstance(value, float):
            # decode the shortest decimal repr (the JSON token) rather than
            # the exact binary double: "0.1" means 100000 micro, and repr
            # artifacts like 0.30000000000000004 take the host lane — the
            # same decision the native flattener makes from the token text
            micro = parse_quantity(repr(value)) * NUM_SCALE
        elif isinstance(value, int):
            from fractions import Fraction

            micro = Fraction(value) * NUM_SCALE
        elif isinstance(value, str):
            micro = parse_quantity(value) * NUM_SCALE
        else:
            return None
    except (QuantityError, ValueError, OverflowError):
        return None
    if micro.denominator != 1 or abs(micro.numerator) > NUM_MAX:
        return None
    return int(micro)


def _digit_capped(s: str) -> bool:
    """True when the leading number part has more than 36 digits — beyond
    the native flattener's exact __int128 range. Mirrors the counting loop
    in ktpu_flatten.cpp quantity_to_micro: ASCII-trim, optional sign, then
    digits with a single embedded dot."""
    s = s.strip(" \t\n\r\f\v")
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    n = 0
    seen_dot = False
    for ch in s[i:]:
        if "0" <= ch <= "9":
            n += 1
            if n > 36:
                return True
        elif ch == "." and not seen_dot:
            seen_dot = True
        else:
            break
    return False


def _needs_host_parse(s: str) -> bool:
    """True when the string could parse differently under unicode-aware
    rules (str.strip(), regex \\d, float()) than under the ASCII grammar
    the device lanes and the native flattener implement: any unicode
    whitespace/decimal digit, or the \\x1c-\\x1f controls str.isspace()
    accepts. Such leaves route the resource to the CPU oracle."""
    import unicodedata

    for ch in s:
        o = ord(ch)
        if 0x1C <= o <= 0x1F:
            return True
        if o > 0x7F and (ch.isspace() or unicodedata.category(ch) == "Nd"):
            return True
    return False


def _duration_micro(value: str) -> int | None:
    """Go-duration parse -> micro-seconds. ``dur_ok`` (strict) additionally
    excludes the literal "0" (operator.go:82 parseDuration); ``dur_any``
    keeps it (duration.go's deprecated Duration* handlers accept it)."""
    try:
        secs = parse_duration(value)
    except DurationError:
        return None
    micro = round(secs * 1_000_000)
    if abs(micro) > NUM_MAX:
        return None
    return micro


def _effective_namespace(resource: dict) -> str:
    meta = resource.get("metadata") or {}
    if resource.get("kind") == "Namespace":
        return meta.get("name") or ""
    return meta.get("namespace") or ""


def _enumerate_slots(resource, segments: list[str], request: dict,
                     ns_eff: str):
    """Yield (mask, elem0, leaf_value_or_None, leaf_present, null_break)
    for every chain of ``segments`` through the resource (or the request
    envelope / the effective-namespace synthetic). A phantom slot (leaf None
    + short mask) marks a broken chain; ``null_break`` records that the
    break happened at a node that exists but is not a map — the JMESPath
    fork resolves such a path to null instead of raising NotFound
    (interpreter._field), which conditions treat as a null key, not an
    unresolved variable. Empty arrays yield nothing."""
    if segments and segments[0] == NSEFF_MARK:
        return [(0b11, -1, ns_eff, True, False)]
    if segments and segments[0] == REQ_MARK:
        root = request
        segments = segments[1:]
        base_mask = 0b11 if request else 0b1
        if not segments:
            return [(base_mask, -1, None, False, False)]
        offset = 1
    else:
        root = resource
        base_mask = 0b1
        offset = 0

    out = []

    def walk(node, i: int, mask: int, elem0: int):
        if i == len(segments):
            out.append((mask, elem0, node, True, False))
            return
        seg = segments[i]
        bit = 1 << (i + 1 + offset)
        if seg == "*":
            if not isinstance(node, list):
                # a list pattern over an existing non-list node is a
                # structural mismatch (validateResourceElement array case)
                out.append((mask, elem0, None, False, True))
                return
            for idx, el in enumerate(node):
                walk(el, i + 1, mask | bit, idx if elem0 < 0 else elem0)
        else:
            if not isinstance(node, dict):
                out.append((mask, elem0, None, False, True))
                return
            if seg not in node:
                out.append((mask, elem0, None, False, False))
                return
            walk(node[seg], i + 1, mask | bit, elem0)

    if root is None or (offset == 1 and not request):
        return [(base_mask, -1, None, False, False)]
    walk(root, 0, base_mask, -1)  # bit 0: the root itself
    return out


def flatten_batch(resources: list[dict], tensors: PolicyTensors,
                  max_slots: int = 16,
                  requests: list[dict] | None = None) -> FlatBatch:
    """``requests`` optionally supplies per-resource admission envelopes
    (operation/namespace/userInfo) backing REQ_MARK paths; a background
    scan passes none and request.* condition keys resolve as absent, the
    same way the oracle's scan context leaves them unresolved."""
    B, P = len(resources), tensors.n_paths
    path_segments = [p.split(SEP) for p in tensors.paths]
    envelopes = requests if requests is not None else [{}] * B

    # first pass: find E
    all_slots: list[list] = []
    e_needed = 1
    host_flag = np.zeros(B, dtype=bool)
    for b, resource in enumerate(resources):
        row = []
        ns_eff = _effective_namespace(resource) if isinstance(resource, dict) else ""
        env = envelopes[b] or {}
        for segs in path_segments:
            slots = _enumerate_slots(resource, segs, env, ns_eff)
            if len(slots) > max_slots:
                host_flag[b] = True
                slots = slots[:max_slots]
            e_needed = max(e_needed, len(slots))
            row.append(slots)
        all_slots.append(row)
    E = e_needed

    interner = _Interner()
    mask = np.zeros((B, P, E), dtype=np.uint16)
    slot_valid = np.zeros((B, P, E), dtype=bool)
    null_break = np.zeros((B, P, E), dtype=bool)
    type_tag = np.full((B, P, E), T_ABSENT, dtype=np.int8)
    str_id = np.full((B, P, E), -1, dtype=np.int32)
    num_val = np.zeros((B, P, E), dtype=np.int64)
    num_ok = np.zeros((B, P, E), dtype=bool)
    num_plain = np.zeros((B, P, E), dtype=bool)
    num_int = np.zeros((B, P, E), dtype=bool)
    dur_val = np.zeros((B, P, E), dtype=np.int64)
    dur_ok = np.zeros((B, P, E), dtype=bool)
    dur_any = np.zeros((B, P, E), dtype=bool)
    bool_val = np.zeros((B, P, E), dtype=bool)
    elem0 = np.full((B, P, E), -1, dtype=np.int32)
    kind_id = np.full(B, -1, dtype=np.int32)

    for b, resource in enumerate(resources):
        kind = (resource.get("kind") or "") if isinstance(resource, dict) else ""
        kind_id[b] = tensors.kind_index.get(kind, -1)
        for p in range(P):
            for e, (m, e0, value, leaf, nbrk) in enumerate(all_slots[b][p]):
                mask[b, p, e] = m
                slot_valid[b, p, e] = True
                null_break[b, p, e] = nbrk
                elem0[b, p, e] = e0
                if not leaf:
                    continue
                if value is None:
                    type_tag[b, p, e] = T_NULL
                elif isinstance(value, bool):
                    type_tag[b, p, e] = T_BOOL
                    bool_val[b, p, e] = value
                    str_id[b, p, e] = interner.intern("true" if value else "false")
                elif isinstance(value, (int, float)):
                    type_tag[b, p, e] = T_NUM
                    num_int[b, p, e] = isinstance(value, int)
                    s = value_to_string_for_equality(value)
                    if len(s) <= STR_LEN:
                        str_id[b, p, e] = interner.intern(s)
                    n = _value_to_micro(value)
                    if n is not None:
                        num_val[b, p, e] = n
                        num_ok[b, p, e] = True
                        num_plain[b, p, e] = True
                    else:
                        host_flag[b] = True
                elif isinstance(value, str):
                    type_tag[b, p, e] = T_STR
                    if len(value.encode("utf-8")) <= STR_LEN:
                        str_id[b, p, e] = interner.intern(value)
                    else:
                        host_flag[b] = True
                    if _needs_host_parse(value):
                        # unicode-sensitive parse: leave the numeric lanes
                        # empty and let the oracle evaluate this resource
                        host_flag[b] = True
                        continue
                    if _digit_capped(value):
                        # >36-digit number part: exact range exceeded
                        host_flag[b] = True
                        continue
                    try:
                        int(value, 10)
                        num_int[b, p, e] = True  # strconv.ParseInt-able
                    except ValueError:
                        pass
                    n = _value_to_micro(value)
                    if n is not None:
                        num_val[b, p, e] = n
                        num_ok[b, p, e] = True
                        try:
                            float(value)
                            num_plain[b, p, e] = True
                        except ValueError:
                            pass
                    d = _duration_micro(value)
                    if d is not None:
                        dur_val[b, p, e] = d
                        dur_any[b, p, e] = True
                        dur_ok[b, p, e] = value != "0"
                elif isinstance(value, dict):
                    type_tag[b, p, e] = T_OBJ
                else:
                    type_tag[b, p, e] = T_LIST

    num_hi = (num_val >> 31).astype(np.int32)
    num_lo = (num_val & 0x7FFFFFFF).astype(np.int32)
    dur_hi = (dur_val >> 31).astype(np.int32)
    dur_lo = (dur_val & 0x7FFFFFFF).astype(np.int32)

    V = max(1, len(interner.strings))
    str_bytes = np.zeros((V, STR_LEN), dtype=np.uint8)
    str_len = np.zeros(V, dtype=np.int32)
    str_has_glob = np.zeros(V, dtype=bool)
    for i, s in enumerate(interner.strings):
        bs = s.encode("utf-8")[:STR_LEN]
        str_bytes[i, : len(bs)] = np.frombuffer(bs, dtype=np.uint8)
        str_len[i] = len(bs)
        str_has_glob[i] = "*" in s or "?" in s

    return FlatBatch(
        n=B, e=E, mask=mask, slot_valid=slot_valid, null_break=null_break,
        type_tag=type_tag,
        str_id=str_id, num_val=num_val, num_hi=num_hi, num_lo=num_lo,
        num_ok=num_ok, num_plain=num_plain, num_int=num_int,
        dur_hi=dur_hi, dur_lo=dur_lo, dur_ok=dur_ok, dur_any=dur_any,
        bool_val=bool_val,
        elem0=elem0, kind_id=kind_id, host_flag=host_flag,
        live=np.ones(B, dtype=bool),
        str_bytes=str_bytes, str_len=str_len, str_has_glob=str_has_glob,
        strings=interner.strings,
    )
