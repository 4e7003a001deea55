"""Cross-layer certification of compiled policy tensors (KT4xx).

Proves, per compiled rule, that the device tensor program and the host
IR walk agree on every state of a finite abstract resource domain. The
two sides are deliberately built from *different* sources:

- the **device program** is reconstructed purely from the assembled
  ``PolicyTensors`` arrays (check rows, aux rows, group/alt wiring, NFA
  state tables) — exactly what ``ops/eval.py`` reads;
- the **host program** is built from the ``RuleIR`` objects — the
  compiler's input contract, re-deriving depth/anchor bookkeeping
  independently of ``compile_segment``.

Both programs are then run through one shared abstract evaluator that
mirrors the ``ops/eval.py`` dataflow (stages 2-6). Any disagreement
means the tensor encoding does not preserve the IR semantics — the bug
classes this catches are row rebasing/splicing corruption, NFA
mis-encodes, wrong group/alt wiring and stale flag stamps. Grounding of
the *shared* semantics against the real engine + CPU oracle is done by
the differential fuzz harness in :mod:`.difffuzz`.

Codes emitted (catalog in ANALYSIS.md):

- **KT401** (ERROR)  device/host verdict divergence, with a concrete
  witness assignment, or a structural tensor-wiring violation.
- **KT402** (WARNING) a host-escalated rule whose escalation is
  dischargeable: recompiling the rule with the host flag cleared yields
  a device program that certifies cleanly.
- **KT403** (WARNING) device-decided rule whose failure message cannot
  be reproduced verbatim by the device lane (variable substitution, or
  anyPattern message composition).
- **KT404** (INFO)   certification incomplete: the rule uses a
  construct outside the abstract domain (wildcard paths, element
  gates, existence anchors, ...) or exceeds the state-space cap.
  Counted, never silently dropped.

The abstract domain: every path referenced by either program gets a
small set of concrete candidate leaf values (absent, null, pattern
witnesses, boundary numerics, type pokes); ancestors of a referenced
leaf are always present, so absence happens only at the leaf. The
product of candidate sets (x the kind domain) is enumerated
exhaustively up to ``STATE_CAP``.

This module is deliberately torch-free (like the rest of
``kyverno_tpu_torch.analysis``) so ``kyverno-tpu lint --certify`` runs
without an accelerator runtime.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field

from ..models.compiler import (
    STR_LEN,
    PolicyTensors,
    TensorDictionary,
    assemble_tensors,
    compile_segment,
)
from ..models.flatten import _duration_micro, _value_to_micro
from ..models.ir import (
    AUX_DENY,
    AUX_EXCLUDE,
    AUX_MATCH,
    AUX_PRECOND,
    NUM_SCALE,
    SEP,
    AuxOp,
    CheckAnchor,
    CheckOp,
    RuleIR,
)
from ..utils.gofmt import value_to_string_for_equality
from ..utils.wildcard import wildcard_match
from .diagnostics import Diagnostic, make

V_NOT_APPLICABLE, V_PASS, V_FAIL, V_SKIP, V_ERROR, V_HOST = range(6)
_VNAME = ("NOT_APPLICABLE", "PASS", "FAIL", "SKIP", "ERROR", "HOST")

T_ABSENT, T_NULL, T_BOOL, T_NUM, T_STR, T_OBJ, T_LIST = range(7)

# exhaustive-enumeration budget per rule; beyond it the rule is counted
# as KT404 certification-incomplete rather than silently sampled
STATE_CAP = 8192
# candidate leaf values per path (after dedup)
PATH_CAND_CAP = 12
# divergence witnesses reported per rule before bailing
_WITNESS_CAP = 3
# structural diagnostics reported per tensor set
_STRUCT_CAP = 12


class _Marker:
    """Identity-compared sentinel for non-scalar abstract values."""

    __slots__ = ("label",)

    def __init__(self, label: str) -> None:
        self.label = label

    def __repr__(self) -> str:
        return self.label


ABSENT = _Marker("<absent>")
LIST_VAL = _Marker("<list>")
OBJ_VAL = _Marker("<obj>")

_OTHER_KIND = "~other-kind"


# ---------------------------------------------------------------------------
# value lanes — mirrors the leaf tagging loop in models/flatten.py


@dataclass(frozen=True)
class _ValInfo:
    present: bool
    type: int
    s: str | None            # interned string form (glob subject)
    num_ok: bool             # k8s-quantity parseable
    micro: int               # quantity micro-units (0 unless num_ok)
    num_plain: bool          # strconv.ParseFloat-able
    num_int: bool            # strconv.ParseInt-able / python int
    dur_any: bool            # Go-duration parseable incl "0"
    dur_ok: bool             # Go-duration parseable excl "0"
    dmicro: int              # duration micro-seconds (0 unless dur_any)
    bool_val: bool


_ABSENT_INFO = _ValInfo(False, T_ABSENT, None, False, 0, False, False,
                        False, False, 0, False)
_NULL_INFO = _ValInfo(True, T_NULL, None, False, 0, False, False,
                      False, False, 0, False)
_LIST_INFO = _ValInfo(True, T_LIST, None, False, 0, False, False,
                      False, False, 0, False)
_OBJ_INFO = _ValInfo(True, T_OBJ, None, False, 0, False, False,
                     False, False, 0, False)


def _lanes(v) -> _ValInfo:
    if v is ABSENT:
        return _ABSENT_INFO
    if v is None:
        return _NULL_INFO
    if v is LIST_VAL:
        return _LIST_INFO
    if v is OBJ_VAL:
        return _OBJ_INFO
    if isinstance(v, bool):
        return _ValInfo(True, T_BOOL, "true" if v else "false",
                        False, 0, False, False, False, False, 0, v)
    if isinstance(v, (int, float)):
        s = value_to_string_for_equality(v)
        if s is not None and len(s) > STR_LEN:
            s = None
        n = _value_to_micro(v)
        ok = n is not None
        return _ValInfo(True, T_NUM, s, ok, n if ok else 0, ok,
                        isinstance(v, int), False, False, 0, False)
    # str
    s = v if len(v.encode("utf-8")) <= STR_LEN else None
    try:
        int(v, 10)
        nint = True
    except ValueError:
        nint = False
    n = _value_to_micro(v)
    nplain = False
    if n is not None:
        try:
            float(v)
            nplain = True
        except ValueError:
            pass
    d = _duration_micro(v)
    return _ValInfo(True, T_STR, s, n is not None,
                    n if n is not None else 0, nplain, nint,
                    d is not None, d is not None and v != "0",
                    d if d is not None else 0, False)


# ---------------------------------------------------------------------------
# glob matchers


def _match_tokens(tokens, text: str) -> bool:
    """Wildcard DP over the byte-level token program reconstructed from
    the NFA state tables — the device-side matcher semantics."""
    b = text.encode("utf-8")
    if len(b) > STR_LEN:
        return False  # the flattener never interns such strings
    n = len(tokens)
    dp = [True] + [False] * n
    for j, (k, c) in enumerate(tokens):
        dp[j + 1] = dp[j] and k == "*"
    for ch in b:
        nxt = [False] * (n + 1)
        for j, (k, c) in enumerate(tokens):
            if k == "*":
                nxt[j + 1] = nxt[j] or dp[j + 1] or dp[j]
            elif k == "?" or c == ch:
                nxt[j + 1] = dp[j]
        dp = nxt
    return dp[n]


def _device_matcher(tensors: PolicyTensors, nfa: int):
    chars = tensors.nfa_char[nfa]
    stars = tensors.nfa_is_star[nfa]
    qs = tensors.nfa_is_q[nfa]
    tokens = []
    for i in range(int(tensors.nfa_len[nfa])):
        if stars[i]:
            tokens.append(("*", 0))
        elif qs[i]:
            tokens.append(("?", 0))
        else:
            tokens.append(("c", int(chars[i])))
    tokens = tuple(tokens)
    return lambda s: _match_tokens(tokens, s)


def _host_matcher(pattern: str, literal: bool):
    if literal:
        return lambda s: s == pattern
    return lambda s: wildcard_match(pattern, s)


def _glob_witnesses(pattern: str) -> list[str]:
    """Concrete strings exercising both accept and reject paths of a
    glob pattern."""
    out = [pattern]
    if "*" in pattern or "?" in pattern:
        out.append(pattern.replace("*", "").replace("?", "x"))
        out.append(pattern.replace("*", "ab").replace("?", "x"))
    if pattern:
        out.append(pattern[:-1])  # near-miss prefix
    return [w for w in out if len(w.encode("utf-8")) <= STR_LEN]


def _device_tokens_witness(tensors: PolicyTensors, nfa: int) -> list[str]:
    parts = []
    for i in range(int(tensors.nfa_len[nfa])):
        if tensors.nfa_is_star[nfa][i]:
            parts.append("*")
        elif tensors.nfa_is_q[nfa][i]:
            parts.append("?")
        else:
            parts.append(chr(int(tensors.nfa_char[nfa][i])))
    return _glob_witnesses("".join(parts))


def _micro_str(m: int) -> str:
    sign = "-" if m < 0 else ""
    whole, frac = divmod(abs(m), NUM_SCALE)
    if frac:
        return f"{sign}{whole}.{frac:06d}".rstrip("0")
    return f"{sign}{whole}"


def _num_witnesses(micro: int) -> list:
    out = []
    for m in (micro - 1, micro, micro + 1):
        if m % NUM_SCALE == 0:
            out.append(m // NUM_SCALE)
        out.append(_micro_str(m))
    if micro % (NUM_SCALE // 1000) == 0:
        # quantity-only spelling ("250m"): parses as a quantity but not
        # as a plain float — exercises the num_plain/num_lit branches
        out.append(f"{micro // (NUM_SCALE // 1000)}m")
    return out


def _dur_witnesses(smicro: int) -> list:
    out = [f"{smicro}us", f"{smicro + 1}us", "0"]
    out.extend(_num_witnesses(smicro))
    return out


# ---------------------------------------------------------------------------
# unified rule programs


@dataclass
class _ChkRow:
    path: str
    plen: int
    op: int
    guard: int
    lo: int
    hi: int
    bool_val: bool
    numfb: bool
    nummode: int
    match: object            # callable(str) -> bool, or None
    alt: int                 # rule-local alternative id
    group: int               # rule-local group id
    is_cond: bool
    cond_depth: int
    track: int
    is_gate: bool
    gate: int
    existence: bool
    witnesses: list = field(default_factory=list)
    ascii_ok: bool = True


@dataclass
class _AuxRow:
    path: str | None
    plen: int
    op: int
    klass: int
    group: int
    kindok: object           # callable(str) -> bool
    match: object
    absent_res: bool
    err_absent: bool
    allow_num: bool
    key_pat: bool
    obool: bool
    o_bool: bool
    o_str: bool
    o_num: bool
    o_dur: bool
    o_float: bool
    o_int: bool
    o_quant: bool
    q: int
    s: int
    negated: bool            # owning group's negate flag
    witnesses: list = field(default_factory=list)
    ascii_ok: bool = True


@dataclass
class _AuxGroup:
    negate: bool
    klass: int
    any_block: bool
    filt: int


@dataclass
class _Prog:
    host_only: bool
    is_deny: bool
    covered: bool
    multi: bool
    n_alts: int
    n_gates: int
    group_alt: dict
    chk: list
    aux: list
    aux_groups: dict
    filters: dict            # fid -> is_exclude
    match_any: bool
    has_match: bool
    has_exclude: bool
    exclude_all: bool
    precond_any: bool
    deny_any: bool
    kind_strs: set

    def paths(self) -> set:
        out = {r.path for r in self.chk}
        out |= {r.path for r in self.aux if r.path}
        return out


_EXIST_OPS = frozenset(
    (int(CheckOp.EXISTS_OBJECT), int(CheckOp.EXISTS_NONNIL),
     int(CheckOp.EXISTS_LIST)))

_NUMFAM_LO = int(CheckOp.NUM_GT)
_NUMFAM_HI = int(CheckOp.NUM_NOT_IN_RANGE)


def _chk_witnesses(op: int, pattern_witness: list, lo: int, hi: int,
                   bool_val: bool, numfb: bool) -> list:
    out = list(pattern_witness)
    if op in (int(CheckOp.STR_EQ), int(CheckOp.STR_NE)) and numfb:
        out.extend(_num_witnesses(lo))
    if int(CheckOp.NUM_EQ) <= op <= _NUMFAM_HI:
        out.extend(_num_witnesses(lo))
        if op in (int(CheckOp.NUM_IN_RANGE), int(CheckOp.NUM_NOT_IN_RANGE)):
            out.extend(_num_witnesses(hi))
    if op == int(CheckOp.BOOL_EQ):
        out.extend((True, False))
    if op == int(CheckOp.IS_NULL):
        out.extend(("", 0, False))
    return out


def _aux_witnesses(row: _AuxRow) -> list:
    out = list(row.witnesses)
    op = row.op
    if row.o_bool:
        out.extend((True, False))
    if row.o_quant or row.o_num or row.o_float or row.o_int:
        out.extend(_num_witnesses(row.q))
    if row.o_dur or op in (int(AuxOp.DGT), int(AuxOp.DGE),
                           int(AuxOp.DLT), int(AuxOp.DLE)):
        out.extend(_dur_witnesses(row.s))
    return out


def _device_prog(tensors: PolicyTensors, row: int, diags: list,
                 ctx: dict) -> _Prog | None:
    """Reconstruct a rule's program purely from the tensor arrays.
    Emits structural KT401s (bad wiring) and returns None on them."""
    T = tensors
    alts = [a for a in range(T.n_alts) if int(T.alt_rule[a]) == row]
    alt_local = {a: i for i, a in enumerate(alts)}
    group_alt: dict = {}
    chk_rows: list = []
    wiring_bad = False

    def bad(msg: str) -> None:
        nonlocal wiring_bad
        wiring_bad = True
        diags.append(make(
            "KT401", f"tensor wiring violation: {msg}",
            component="certify", **ctx))

    gid_local: dict = {}
    for i in range(len(T.chk_rule)):
        if int(T.chk_rule[i]) != row:
            continue
        a = int(T.chk_alt_gid[i])
        g = int(T.chk_group_gid[i])
        if a not in alt_local:
            bad(f"chk row {i} alt {a} not wired to rule row {row}")
            continue
        if not (0 <= g < T.n_groups) or int(T.group_alt[g]) != a:
            bad(f"chk row {i} group {g} not wired to alt {a}")
            continue
        if g not in gid_local:
            gid_local[g] = len(gid_local)
            group_alt[gid_local[g]] = alt_local[a]
        nfa = int(T.chk_nfa[i])
        match = None
        witnesses: list = []
        ascii_ok = True
        if nfa >= 0:
            if nfa >= len(T.nfa_len):
                bad(f"chk row {i} nfa id {nfa} out of range")
                continue
            match = _device_matcher(T, nfa)
            witnesses = _device_tokens_witness(T, nfa)
            ascii_ok = all(int(c) < 128
                           for c in T.nfa_char[nfa][:int(T.nfa_len[nfa])])
        path = T.paths[int(T.chk_path[i])]
        op = int(T.chk_op[i])
        lo = int(T.chk_num_lo[i])
        hi = int(T.chk_num_hi[i])
        numfb = bool(T.chk_num_fallback[i])
        chk_rows.append(_ChkRow(
            path=path, plen=len(path.split(SEP)), op=op,
            guard=int(T.chk_guard[i]), lo=lo, hi=hi,
            bool_val=bool(T.chk_bool[i]), numfb=numfb,
            nummode=int(T.chk_num_mode[i]), match=match,
            alt=alt_local[a], group=gid_local[g],
            is_cond=bool(T.chk_is_cond[i]),
            cond_depth=int(T.chk_cond_depth[i]),
            track=int(T.chk_track_depth[i]),
            is_gate=bool(T.chk_is_gate_row[i]), gate=int(T.chk_gate[i]),
            existence=bool(T.chk_existence[i]),
            witnesses=_chk_witnesses(op, witnesses, lo, hi,
                                     bool(T.chk_bool[i]), numfb),
            ascii_ok=ascii_ok))

    # aux program
    groups = [g for g in range(T.n_aux_groups) if int(T.axg_rule[g]) == row]
    axg_local = {g: i for i, g in enumerate(groups)}
    filts = [f for f in range(T.n_aux_filters) if int(T.axf_rule[f]) == row]
    axf_local = {f: i for i, f in enumerate(filts)}
    aux_groups: dict = {}
    for g in groups:
        f = int(T.axg_filt[g])
        klass = int(T.axg_klass[g])
        if klass in (AUX_MATCH, AUX_EXCLUDE):
            if f not in axf_local:
                bad(f"aux group {g} filter {f} not wired to rule row {row}")
                continue
            if bool(T.axf_is_exclude[f]) != (klass == AUX_EXCLUDE):
                bad(f"aux filter {f} exclude flag contradicts group "
                    f"{g} klass")
                continue
            lfilt = axf_local[f]
        else:
            if f != -1:
                bad(f"aux group {g} (klass {klass}) carries filter {f}")
                continue
            lfilt = -1
        aux_groups[axg_local[g]] = _AuxGroup(
            negate=bool(T.axg_negate[g]), klass=klass,
            any_block=bool(T.axg_any[g]), filt=lfilt)

    kind_index = T.kind_index
    kind_strs: set = set()
    rev_kind = {v: k for k, v in kind_index.items()}
    aux_rows: list = []
    for i in range(len(T.ax_rule)):
        if int(T.ax_rule[i]) != row:
            continue
        g = int(T.ax_group[i])
        if g not in axg_local or axg_local[g] not in aux_groups:
            bad(f"aux row {i} group {g} not wired to rule row {row}")
            continue
        nfa = int(T.ax_nfa[i])
        match = None
        witnesses = []
        ascii_ok = True
        if nfa >= 0:
            if nfa >= len(T.nfa_len):
                bad(f"aux row {i} nfa id {nfa} out of range")
                continue
            match = _device_matcher(T, nfa)
            witnesses = _device_tokens_witness(T, nfa)
            ascii_ok = all(int(c) < 128
                           for c in T.nfa_char[nfa][:int(T.nfa_len[nfa])])
        kreq = int(T.ax_kind_req[i])
        if kreq >= 0:
            kind_strs.add(rev_kind.get(kreq, f"~kid{kreq}"))

        def kindok(kind, _k=kreq, _idx=kind_index):
            return _k < 0 or _idx.get(kind, -1) == _k

        pid = int(T.ax_path[i])
        path = T.paths[pid] if pid >= 0 else None
        q = (int(T.ax_q_hi[i]) << 31) | int(T.ax_q_lo[i])
        s = (int(T.ax_s_hi[i]) << 31) | int(T.ax_s_lo[i])
        r = _AuxRow(
            path=path, plen=int(T.ax_plen[i]), op=int(T.ax_op[i]),
            klass=int(T.axg_klass[g]), group=axg_local[g],
            kindok=kindok, match=match,
            absent_res=bool(T.ax_absent[i]),
            err_absent=bool(T.ax_err_absent[i]),
            allow_num=bool(T.ax_allow_num[i]),
            key_pat=bool(T.ax_key_pat[i]), obool=bool(T.ax_obool[i]),
            o_bool=bool(T.ax_is_obool[i]), o_str=bool(T.ax_is_ostr[i]),
            o_num=bool(T.ax_is_onum[i]), o_dur=bool(T.ax_is_odur[i]),
            o_float=bool(T.ax_is_ofloat[i]), o_int=bool(T.ax_is_oint[i]),
            o_quant=bool(T.ax_is_oquant[i]), q=q, s=s,
            negated=bool(T.axg_negate[g]),
            witnesses=witnesses, ascii_ok=ascii_ok)
        r.witnesses = _aux_witnesses(r)
        aux_rows.append(r)

    if wiring_bad:
        return None
    return _Prog(
        host_only=bool(T.rule_host_only[row]),
        is_deny=bool(T.rule_is_deny[row]),
        covered=bool(alts), multi=len(alts) > 1, n_alts=len(alts),
        n_gates=sum(1 for r in chk_rows if r.is_gate or r.gate >= 0),
        group_alt=group_alt, chk=chk_rows, aux=aux_rows,
        aux_groups=aux_groups,
        filters={axf_local[f]: bool(T.axf_is_exclude[f]) for f in filts},
        match_any=bool(T.rule_match_any[row]),
        has_match=bool(T.rule_has_match[row]),
        has_exclude=bool(T.rule_has_exclude[row]),
        exclude_all=bool(T.rule_exclude_all[row]),
        precond_any=bool(T.rule_precond_any[row]),
        deny_any=bool(T.rule_deny_any[row]),
        kind_strs=kind_strs)


def _host_prog(ir: RuleIR) -> _Prog:
    """Build the reference program from the IR, re-deriving the depth
    and anchor bookkeeping independently of compile_segment."""
    group_local: dict = {}
    group_alt: dict = {}
    chk_rows: list = []
    for c in ir.checks:
        key = (c.alt, c.group)
        if key not in group_local:
            group_local[key] = len(group_local)
            group_alt[group_local[key]] = c.alt
        segments = c.path.split(SEP)
        is_gate = c.anchor is CheckAnchor.ELEMENT_GATE
        is_cond = c.anchor in (CheckAnchor.CONDITION, CheckAnchor.GLOBAL)
        if is_cond:
            track = c.cond_depth
        elif c.existence:
            track = (len(segments) - 1 - segments[::-1].index("*")
                     if "*" in segments else len(segments))
        elif is_gate or c.op is CheckOp.ABSENT:
            track = len(segments)
        else:
            track = -1
        op = int(c.op)
        match = None
        witnesses: list = []
        ascii_ok = True
        if op in (int(CheckOp.STR_EQ), int(CheckOp.STR_NE)):
            match = _host_matcher(c.pattern_str, literal=False)
            witnesses = _glob_witnesses(c.pattern_str)
            ascii_ok = c.pattern_str.isascii()
        chk_rows.append(_ChkRow(
            path=c.path, plen=len(segments), op=op, guard=c.guard_mask,
            lo=c.num_lo, hi=c.num_hi, bool_val=c.bool_val,
            numfb=c.num_fallback, nummode=c.num_mode, match=match,
            alt=c.alt, group=group_local[key], is_cond=is_cond,
            cond_depth=c.cond_depth, track=track, is_gate=is_gate,
            gate=c.gate, existence=c.existence,
            witnesses=_chk_witnesses(op, witnesses, c.num_lo, c.num_hi,
                                     c.bool_val, c.num_fallback),
            ascii_ok=ascii_ok))

    filt_local: dict = {}
    axg_local: dict = {}
    aux_groups: dict = {}
    filters: dict = {}
    aux_rows: list = []
    kind_strs: set = set()
    for a in ir.aux_rows:
        if a.klass in (AUX_MATCH, AUX_EXCLUDE):
            fkey = (a.klass, a.filt)
            if fkey not in filt_local:
                filt_local[fkey] = len(filt_local)
                filters[filt_local[fkey]] = a.klass == AUX_EXCLUDE
            lfilt = filt_local[fkey]
        else:
            lfilt = -1
        if a.group not in axg_local:
            axg_local[a.group] = len(axg_local)
            aux_groups[axg_local[a.group]] = _AuxGroup(
                negate=a.group_negate, klass=a.klass,
                any_block=a.any_block, filt=lfilt)
        match = None
        witnesses = []
        ascii_ok = True
        if a.op in (AuxOp.GLOB, AuxOp.CIN_ITEM, AuxOp.CIN_GLOB) or (
                a.op is AuxOp.CEQ and a.o_is_str):
            match = _host_matcher(a.pattern, a.literal)
            witnesses = ([a.pattern] if a.literal
                         else _glob_witnesses(a.pattern))
            ascii_ok = a.pattern.isascii()
        if a.kind_req:
            kind_strs.add(a.kind_req)

        def kindok(kind, _req=a.kind_req or None):
            return _req is None or kind == _req

        r = _AuxRow(
            path=a.path or None,
            plen=len(a.path.split(SEP)) if a.path else 0,
            op=int(a.op), klass=a.klass, group=axg_local[a.group],
            kindok=kindok, match=match, absent_res=a.absent_res,
            err_absent=a.err_on_absent and bool(a.path),
            allow_num=a.allow_num_key, key_pat=a.key_is_pattern,
            obool=a.o_bool, o_bool=a.o_is_bool, o_str=a.o_is_str,
            o_num=a.o_is_num, o_dur=a.o_is_dur, o_float=a.o_is_float,
            o_int=a.o_is_int, o_quant=a.o_is_quant,
            q=a.o_qmicro, s=a.o_smicro, negated=a.group_negate,
            witnesses=witnesses, ascii_ok=ascii_ok)
        r.witnesses = _aux_witnesses(r)
        aux_rows.append(r)

    return _Prog(
        host_only=ir.host_only, is_deny=ir.is_deny,
        covered=not ir.host_only, multi=ir.n_alts > 1, n_alts=ir.n_alts,
        n_gates=ir.n_gates, group_alt=group_alt, chk=chk_rows,
        aux=aux_rows, aux_groups=aux_groups, filters=filters,
        match_any=ir.match_any, has_match=ir.n_match_filters > 0,
        has_exclude=ir.n_exclude_filters > 0, exclude_all=ir.exclude_all,
        precond_any=ir.precond_has_any, deny_any=ir.deny_has_any,
        kind_strs=kind_strs)


# ---------------------------------------------------------------------------
# shared abstract evaluator — mirrors ops/eval.py stages 2-6 over one
# abstract state (only leaves can be absent; chains never null-break)


def _chk_value_ok(r: _ChkRow, vi: _ValInfo) -> bool:
    present = vi.present
    nil_like = vi.type == T_NULL or not present
    micro = vi.micro
    numok_n = vi.num_ok or nil_like
    eq_lo = micro == r.lo
    gt_lo = micro > r.lo
    stringy = vi.type in (T_STR, T_BOOL, T_NUM)
    str_hit = (vi.s is not None and r.match is not None and r.match(vi.s))
    op = r.op
    if op == int(CheckOp.STR_EQ):
        return (numok_n and eq_lo) if r.numfb else (stringy and str_hit)
    if op == int(CheckOp.STR_NE):
        return (numok_n and not eq_lo) if r.numfb \
            else (stringy and not str_hit)
    if op in (int(CheckOp.NUM_EQ), int(CheckOp.NUM_NE)):
        lit_str_ok = vi.num_int if r.nummode == 1 else vi.num_plain
        num_lit_ok = vi.num_ok and (vi.type == T_NUM
                                    or (vi.type == T_STR and lit_str_ok))
        return num_lit_ok and (eq_lo if op == int(CheckOp.NUM_EQ)
                               else not eq_lo)
    if op == int(CheckOp.NUM_GT):
        return numok_n and gt_lo
    if op == int(CheckOp.NUM_GE):
        return numok_n and micro >= r.lo
    if op == int(CheckOp.NUM_LT):
        return numok_n and micro < r.lo
    if op == int(CheckOp.NUM_LE):
        return numok_n and not gt_lo
    if op == int(CheckOp.NUM_IN_RANGE):
        return numok_n and r.lo <= micro <= r.hi
    if op == int(CheckOp.NUM_NOT_IN_RANGE):
        return numok_n and not (r.lo <= micro <= r.hi)
    if op == int(CheckOp.BOOL_EQ):
        return vi.type == T_BOOL and vi.bool_val == r.bool_val
    if op == int(CheckOp.IS_NULL):
        return (nil_like
                or (vi.type == T_BOOL and not vi.bool_val)
                or (vi.type == T_NUM and vi.num_ok and micro == 0)
                or (vi.type == T_STR and vi.s == ""))
    if op == int(CheckOp.EXISTS_OBJECT):
        return vi.type == T_OBJ
    if op == int(CheckOp.EXISTS_NONNIL):
        return present and vi.type != T_NULL
    if op == int(CheckOp.EXISTS_LIST):
        return vi.type == T_LIST
    return False


def _slot_eval(r: _ChkRow, vi: _ValInfo) -> tuple[bool, bool, bool]:
    """(slot_ok, value_ok, leaf_present) for one check row. In this
    domain ancestors are always present, so first_absent is either 0 or
    the leaf bit and null-breaks never occur."""
    present = vi.present
    if r.op == int(CheckOp.ABSENT):
        return (not present), False, present
    value_ok = _chk_value_ok(r, vi)
    leaf_bit = 1 << r.plen
    guard_pass = (not present) and bool(leaf_bit & r.guard)
    eval_on_nil = (
        (_NUMFAM_LO <= r.op <= _NUMFAM_HI)
        or r.op == int(CheckOp.IS_NULL)
        or (r.op in (int(CheckOp.STR_EQ), int(CheckOp.STR_NE))
            and r.numfb))
    nil_leaf = (not present) and not guard_pass
    if present or (nil_leaf and eval_on_nil):
        return value_ok, value_ok, present
    return guard_pass, value_ok, present


def _aux_row_eval(r: _AuxRow, vi: _ValInfo,
                  kind: str) -> tuple[bool, bool, bool]:
    """(row_value, uncertain, deny_error) for one aux row."""
    presx = vi.present
    nullx = presx and vi.type == T_NULL
    absx = not presx
    strk = vi.type == T_STR
    numk = vi.type == T_NUM
    boolk = vi.type == T_BOOL
    listk = vi.type == T_LIST
    globx = vi.s is not None and r.match is not None and r.match(vi.s)
    keyglob = vi.s is not None and ("*" in vi.s or "?" in vi.s)

    nmic = vi.micro
    dmic = vi.dmicro
    op = r.op
    dur_pair = vi.dur_ok and (r.o_dur or r.o_num)
    ceq = (
        (boolk and r.o_bool and vi.bool_val == r.obool)
        or (numk and vi.num_ok and r.o_quant and nmic == r.q
            and (r.o_num or (r.o_str and ((vi.num_int and r.o_int)
                                          or (not vi.num_int
                                              and r.o_float)))))
        or (strk and ((dur_pair and dmic == r.s)
                      or (not dur_pair and vi.num_ok and r.o_str
                          and r.o_quant and nmic == r.q)
                      or (not dur_pair and not vi.num_ok and r.o_str
                          and globx))))

    def rel4(base: int, lt: bool, gt: bool) -> bool:
        return ((op == base and gt) or (op == base + 1 and not lt)
                or (op == base + 2 and lt) or (op == base + 3 and not gt))

    cmp_q = rel4(int(AuxOp.CGT), nmic < r.q, nmic > r.q)
    cmp_ns = rel4(int(AuxOp.CGT), nmic < r.s, nmic > r.s)
    cmp_ds = rel4(int(AuxOp.CGT), dmic < r.s, dmic > r.s)
    numkey_cmp = ((r.o_num and cmp_q)
                  or (not r.o_num and r.o_str and r.o_dur and cmp_ns)
                  or (not r.o_num and r.o_str and not r.o_dur
                      and r.o_float and cmp_q))
    cnum = (
        (numk and numkey_cmp)
        or (strk and dur_pair and cmp_ds)
        or (strk and not dur_pair and vi.num_plain and numkey_cmp)
        or (strk and not dur_pair and not vi.num_plain and vi.num_ok
            and r.o_str and r.o_quant and cmp_q))
    dnum = rel4(int(AuxOp.DGT), nmic < r.s, nmic > r.s)
    ddur = rel4(int(AuxOp.DGT), dmic < r.s, dmic > r.s)
    cdur = (numk and dnum) or (strk and vi.dur_any and ddur)
    in_keyish = strk or (numk and r.allow_num and vi.num_int)
    cin = in_keyish and globx

    is_cinop = op in (int(AuxOp.CIN_ITEM), int(AuxOp.CIN_GLOB))
    if op == int(AuxOp.TRUE):
        op_val = True
    elif op == int(AuxOp.GLOB):
        op_val = (strk or (numk and vi.num_int)) and globx
    elif op == int(AuxOp.EXISTS):
        op_val = presx
    elif op == int(AuxOp.NOT_EXISTS):
        op_val = not presx
    elif op == int(AuxOp.CEQ):
        op_val = ceq
    elif is_cinop:
        op_val = cin
    elif int(AuxOp.CGT) <= op <= int(AuxOp.CLE):
        op_val = cnum
    elif int(AuxOp.DGT) <= op <= int(AuxOp.DLE):
        op_val = cdur
    else:
        op_val = False

    is_exist_op = op in (int(AuxOp.EXISTS), int(AuxOp.NOT_EXISTS))
    if r.path is None:
        rowv = op_val
    elif r.klass in (AUX_MATCH, AUX_EXCLUDE):
        if is_exist_op:
            rowv = op_val
        else:
            pres_nonnull = presx and vi.type != T_NULL
            rowv = op_val if pres_nonnull else r.absent_res
    elif r.klass == AUX_DENY:
        rowv = (not nullx) and ((presx and op_val)
                                or (not presx and r.absent_res))
    else:  # AUX_PRECOND
        rowv = ((presx and not nullx and op_val)
                or ((not presx or nullx) and r.absent_res))
    kind_ok = r.kindok(kind)
    rowv = rowv and kind_ok

    unc = is_cinop and (
        listk or vi.type == T_OBJ or (r.negated and boolk)
        or (numk and r.allow_num and not vi.num_int)
        or (r.key_pat and strk and keyglob))
    unc = unc or (op == int(AuxOp.GLOB) and presx
                  and not (strk or (numk and vi.num_int)
                           or vi.type == T_NULL))
    unc = unc and kind_ok

    errx = r.err_absent and (absx or nullx) and r.path is not None
    return rowv, unc, errx


def _eval_prog(prog: _Prog, state: dict, kind: str) -> int:
    """Abstract verdict of one program on one state — the ops/eval.py
    stage 2-6 dataflow specialized to the single-slot domain."""
    if prog.host_only:
        return V_HOST

    # ---- pattern stage
    group_or: dict = {}
    group_has_plain: set = set()
    cond_state: dict = {}
    anchor_missing_alts: set = set()
    list_unc = False
    for r in prog.chk:
        vi = state.get(r.path, _ABSENT_INFO)
        ok, value_ok, present = _slot_eval(r, vi)
        if r.is_cond:
            st = cond_state.setdefault(r.group, [False, False])
            st[0] = st[0] or (present and value_ok)
            kp = present if r.cond_depth == r.plen else True
            st[1] = st[1] or kp
        elif not r.is_gate:
            group_or[r.group] = group_or.get(r.group, False) or ok
            group_has_plain.add(r.group)
        if r.track >= 0 and r.track == r.plen and not present:
            anchor_missing_alts.add(r.alt)
        if (r.op not in _EXIST_OPS and r.op != int(CheckOp.ABSENT)
                and vi.type == T_LIST and present):
            list_unc = True

    alt_verdicts = []
    for a in range(prog.n_alts):
        galts = [g for g, aa in prog.group_alt.items() if aa == a]
        ok = all(group_or.get(g, False)
                 for g in galts if g in group_has_plain)
        skip = any(
            cond_state[g][1] and not cond_state[g][0]
            for g in galts if g in cond_state)
        missing = a in anchor_missing_alts
        ambig = skip and not ok and not prog.multi
        if ambig:
            v = V_HOST
        elif skip:
            v = V_SKIP
        elif ok:
            v = V_PASS
        elif missing:
            v = V_HOST
        else:
            v = V_FAIL
        alt_verdicts.append(v)
    if prog.multi:
        pattern_v = (V_PASS if any(v == V_PASS for v in alt_verdicts)
                     else V_FAIL)
    elif alt_verdicts:
        pattern_v = alt_verdicts[0]
    else:
        pattern_v = V_NOT_APPLICABLE
    if list_unc and pattern_v in (V_FAIL, V_ERROR, V_SKIP):
        pattern_v = V_HOST

    # ---- aux stage
    grp_or: dict = {}
    unc_m = unc_c = err_any = False
    for r in prog.aux:
        vi = state.get(r.path, _ABSENT_INFO) if r.path else _ABSENT_INFO
        rowv, unc, errx = _aux_row_eval(r, vi, kind)
        grp_or[r.group] = grp_or.get(r.group, False) or rowv
        if unc:
            if r.klass in (AUX_MATCH, AUX_EXCLUDE):
                unc_m = True
            else:
                unc_c = True
        err_any = err_any or errx
    grp = {}
    for g, meta in prog.aux_groups.items():
        v = grp_or.get(g, False)
        grp[g] = (not v) if meta.negate else v
    filt_ok = {}
    for f in prog.filters:
        filt_ok[f] = all(grp[g] for g, meta in prog.aux_groups.items()
                         if meta.filt == f)
    m_filts = [f for f, is_ex in prog.filters.items() if not is_ex]
    e_filts = [f for f, is_ex in prog.filters.items() if is_ex]
    m_or = any(filt_ok[f] for f in m_filts)
    m_and = all(filt_ok[f] for f in m_filts)
    match_ok = ((m_or if prog.match_any else m_and)
                or not prog.has_match)
    e_or = any(filt_ok[f] for f in e_filts)
    e_and = all(filt_ok[f] for f in e_filts)
    exclude_hit = ((e_and if prog.exclude_all else e_or)
                   and prog.has_exclude)
    applicable = match_ok and not exclude_hit

    def cond_reduce(klass: int, has_any: bool) -> bool:
        all_ok = all(grp[g] for g, m in prog.aux_groups.items()
                     if m.klass == klass and not m.any_block)
        any_ok = any(grp[g] for g, m in prog.aux_groups.items()
                     if m.klass == klass and m.any_block)
        return all_ok and (any_ok or not has_any)

    precond_ok = cond_reduce(AUX_PRECOND, prog.precond_any)
    deny_match = cond_reduce(AUX_DENY, prog.deny_any)

    # ---- stage 6 composition (exact ops/eval.py order)
    if prog.is_deny:
        v = V_ERROR if err_any else (V_FAIL if deny_match else V_PASS)
    else:
        v = pattern_v
    if not prog.covered and not prog.is_deny:
        v = V_NOT_APPLICABLE
    if not precond_ok:
        v = V_SKIP
    if unc_c:
        v = V_HOST
    if not applicable:
        v = V_NOT_APPLICABLE
    if unc_m:
        v = V_HOST
    return v


# ---------------------------------------------------------------------------
# abstract domain construction


def _scope_reason(dev: _Prog, host: _Prog) -> tuple[str, str] | None:
    """Constructs outside the certifiable domain -> (reason, detail)."""
    for prog in (dev, host):
        if prog.n_gates:
            return "element-gate", f"{prog.n_gates} gate(s)"
        for r in prog.chk:
            if "*" in r.path.split(SEP):
                return "wildcard-path", r.path
            if r.existence:
                return "existence-anchor", r.path
            if r.is_gate or r.gate >= 0:
                return "element-gate", r.path
            if r.op == int(CheckOp.EXISTS_LIST):
                return "element-gate", r.path
            if not r.ascii_ok:
                return "non-ascii-pattern", r.path
        for r in prog.aux:
            if r.path and "*" in r.path.split(SEP):
                return "wildcard-path", r.path
            if r.path is None and r.op != int(AuxOp.TRUE):
                return "pathless-aux-op", f"op {r.op}"
            if not r.ascii_ok:
                return "non-ascii-pattern", r.path or "<pathless>"
    paths = sorted(dev.paths() | host.paths())
    for i, p in enumerate(paths):
        for q in paths[i + 1:]:
            if q.startswith(p + SEP):
                return "path-prefix-aliasing", f"{p} vs {q}"
    return None


def _safe_candidate(v) -> bool:
    if isinstance(v, str):
        if not v.isascii() or len(v) > STR_LEN:
            return False
    return True


def _path_domains(dev: _Prog, host: _Prog) -> dict:
    by_path: dict = {}
    for prog in (dev, host):
        for r in prog.chk:
            by_path.setdefault(r.path, []).extend(r.witnesses)
        for r in prog.aux:
            if r.path:
                by_path.setdefault(r.path, []).extend(r.witnesses)
    domains = {}
    for path, hints in by_path.items():
        cands = [ABSENT, None, "x", "zz~nomatch", LIST_VAL, OBJ_VAL]
        cands.extend(h for h in hints if _safe_candidate(h))
        seen = set()
        out = []
        for c in cands:
            key = (type(c).__name__, repr(c))
            if key in seen:
                continue
            seen.add(key)
            out.append(c)
            if len(out) >= PATH_CAND_CAP:
                break
        domains[path] = [(c, _lanes(c)) for c in out]
    return domains


def _render_state(state_vals: dict, kind: str) -> str:
    parts = [f"kind={kind!r}"]
    for p, v in sorted(state_vals.items()):
        parts.append(f"{p.replace(SEP, '/')}={v!r}")
    return " ".join(parts)


# ---------------------------------------------------------------------------
# certification driver


@dataclass
class CertifyResult:
    """Outcome of a certification pass."""

    diagnostics: list
    statuses: dict           # (policy_name, rule_name) -> status
    states_checked: int = 0
    escalation_cells: int = 0

    def counts(self) -> dict:
        out: dict = {}
        for s in self.statuses.values():
            out[s] = out.get(s, 0) + 1
        return out

    @property
    def divergences(self) -> list:
        return [d for d in self.diagnostics if d.code == "KT401"]


def _certify_rule(tensors: PolicyTensors, row: int, ir: RuleIR,
                  diags: list) -> tuple[str, int, int]:
    """Certify one rule; returns (status, states_checked, escalations)."""
    ctx = dict(policy=ir.policy_name, rule=ir.rule_name)
    t_host = bool(tensors.rule_host_only[row])
    if t_host != bool(ir.host_only):
        diags.append(make(
            "KT401",
            f"host flag mismatch: tensors say host_only={t_host}, IR "
            f"says {bool(ir.host_only)}", component="certify", **ctx))
        return "divergent", 0, 0
    if ir.host_only:
        return "host", 0, 0

    host = _host_prog(ir)
    dev = _device_prog(tensors, row, diags, ctx)
    if dev is None:
        return "divergent", 0, 0

    reason = _scope_reason(dev, host)
    if reason:
        diags.append(make(
            "KT404",
            f"certification incomplete ({reason[0]}): {reason[1]}",
            component="certify", reason=reason[0], **ctx))
        return "incomplete", 0, 0

    domains = _path_domains(dev, host)
    kinds = sorted(dev.kind_strs | host.kind_strs) + [_OTHER_KIND]
    total = len(kinds)
    for cands in domains.values():
        total *= len(cands)
        if total > STATE_CAP:
            diags.append(make(
                "KT404",
                f"certification incomplete (state-space): "
                f"{len(domains)} paths x {len(kinds)} kinds exceed "
                f"cap {STATE_CAP}", component="certify",
                reason="state-space", **ctx))
            return "incomplete", 0, 0

    paths = sorted(domains)
    checked = escalations = divergences = 0
    for kind in kinds:
        for combo in itertools.product(*(domains[p] for p in paths)):
            state = {p: vi for p, (_, vi) in zip(paths, combo)}
            dv = _eval_prog(dev, state, kind)
            hv = _eval_prog(host, state, kind)
            checked += 1
            if dv == V_HOST:
                # device escalation is always sound (the oracle decides)
                escalations += 1
                continue
            if dv != hv:
                vals = {p: v for p, (v, _) in zip(paths, combo)}
                what = ("device decided a cell the IR semantics mark "
                        "order-dependent" if hv == V_HOST
                        else "device/host verdict divergence")
                diags.append(make(
                    "KT401",
                    f"{what}: device={_VNAME[dv]} host={_VNAME[hv]} "
                    f"at {_render_state(vals, kind)}",
                    component="certify", **ctx))
                divergences += 1
                if divergences >= _WITNESS_CAP:
                    return "divergent", checked, escalations
    return ("divergent" if divergences else "certified",
            checked, escalations)


def _probe_discharge(ir: RuleIR) -> bool:
    """True when a host-escalated rule certifies cleanly once the host
    flag is cleared — i.e. the escalation is dischargeable (KT402)."""
    trial = copy.deepcopy(ir)
    trial.host_only = False
    trial.host_reason = ""
    trial.host_reason_code = ""
    trial.rule_index = 0
    dictionary = TensorDictionary()
    seg = compile_segment([trial], dictionary, name="certify-probe")
    if trial.host_only:
        return False  # re-escalated (genuine geometry/NFA limits)
    tens = assemble_tensors([seg], dictionary)
    scratch: list = []
    status, _, _ = _certify_rule(tens, 0, trial, scratch)
    return status == "certified" and not any(
        d.code == "KT401" for d in scratch)


def _structural_diags(tensors: PolicyTensors) -> list:
    """Tensor-wide wiring and pad-region invariants (KT401)."""
    T = tensors
    out: list = []

    def bad(msg: str) -> None:
        if len(out) < _STRUCT_CAP:
            out.append(make("KT401", f"tensor wiring violation: {msg}",
                            component="certify"))

    live = T.n_rules_logical
    for a in range(T.n_alts):
        r = int(T.alt_rule[a])
        if not (0 <= r < live):
            bad(f"alt {a} wired to rule row {r} (live rules: {live})")
    for g in range(T.n_groups):
        a = int(T.group_alt[g])
        if not (0 <= a < T.n_alts):
            bad(f"group {g} wired to alt {a} (alts: {T.n_alts})")
    for i in range(len(T.chk_rule)):
        if not (0 <= int(T.chk_path[i]) < len(T.paths)):
            bad(f"chk row {i} path id {int(T.chk_path[i])} out of range")
        if not (0 <= int(T.chk_rule[i]) < live):
            bad(f"chk row {i} rule {int(T.chk_rule[i])} out of range")
    for i in range(len(T.ax_rule)):
        g = int(T.ax_group[i])
        if not (0 <= g < T.n_aux_groups):
            bad(f"aux row {i} group {g} out of range")
        elif int(T.axg_rule[g]) != int(T.ax_rule[i]):
            bad(f"aux row {i} rule {int(T.ax_rule[i])} disagrees with "
                f"its group's rule {int(T.axg_rule[g])}")
        p = int(T.ax_path[i])
        if p >= len(T.paths):
            bad(f"aux row {i} path id {p} out of range")
    for r in range(live, T.n_rules):
        if (bool(T.rule_host_only[r]) or bool(T.rule_is_deny[r])
                or bool(T.rule_has_match[r])
                or bool(T.rule_match_all_kinds[r])):
            bad(f"pad rule row {r} carries live flags")
    spans_end = 0
    for span in T.segments:
        if span.rule_base != spans_end:
            bad(f"segment {span.name!r} rule_base {span.rule_base} "
                f"!= running total {spans_end}")
        spans_end = span.rule_base + span.n_rules
    if spans_end != live:
        bad(f"segment spans cover {spans_end} rules, expected {live}")
    if len(T.rules) != live:
        bad(f"{len(T.rules)} RuleIRs attached for {live} live rule rows")
    return out


def certify_tensors(tensors: PolicyTensors, rule_filter=None,
                    probe_discharge: bool = True) -> CertifyResult:
    """Certify every rule of an assembled tensor set against its
    attached RuleIRs. Pure CPU work; no torch.

    ``rule_filter`` (optional ``RuleIR -> bool``) restricts the per-rule
    pass — the incremental-refresh hook skips rules already stamped.
    ``probe_discharge=False`` skips the KT402 recompile probe (it
    deep-copies and recompiles each host rule; lint wants it, the
    admission refresh path doesn't)."""
    diags = _structural_diags(tensors)
    statuses: dict = {}
    states = escal = 0
    structural_broken = any(d.code == "KT401" for d in diags)

    idx = 0
    for span in tensors.segments:
        for _ in range(span.n_rules):
            if idx >= len(tensors.rules):
                break
            ir = tensors.rules[idx]
            idx += 1
            row = span.rule_base + ir.rule_index
            if not (0 <= row < tensors.n_rules_logical):
                diags.append(make(
                    "KT401",
                    f"rule {ir.rule_name!r} maps to row {row} outside "
                    f"the live rule range", component="certify",
                    policy=ir.policy_name, rule=ir.rule_name))
                statuses[(ir.policy_name, ir.rule_name)] = "divergent"
                continue
            if structural_broken:
                statuses[(ir.policy_name, ir.rule_name)] = "divergent"
                continue
            if rule_filter is not None and not rule_filter(ir):
                continue
            status, n, e = _certify_rule(tensors, row, ir, diags)
            states += n
            escal += e
            if (probe_discharge and status == "host"
                    and (ir.checks or ir.aux_rows)):
                try:
                    discharge = _probe_discharge(ir)
                except Exception:
                    discharge = False
                if discharge:
                    diags.append(make(
                        "KT402",
                        "host escalation is dischargeable: the rule "
                        f"recompiles device-decidable and certifies "
                        f"cleanly (escalation reason: "
                        f"{ir.host_reason or 'unrecorded'})",
                        component="certify", policy=ir.policy_name,
                        rule=ir.rule_name))
            statuses[(ir.policy_name, ir.rule_name)] = status
    return CertifyResult(diagnostics=diags, statuses=statuses,
                         states_checked=states, escalation_cells=escal)


def certify_policies(policies) -> CertifyResult:
    """Compile ``policies`` (ClusterPolicy objects) per segment and
    certify the assembled tensors; adds the KT403 message-divergence
    pass, which needs the raw validate messages."""
    from ..models.ir import compile_rule_ir

    dictionary = TensorDictionary()
    segments = []
    by_rule: dict = {}
    for policy in policies:
        vrules = [r for r in policy.spec.rules if r.has_validate()]
        irs = [compile_rule_ir(policy, rule, i)
               for i, rule in enumerate(vrules)]
        for ir, rule in zip(irs, vrules):
            by_rule[(ir.policy_name, ir.rule_name)] = (ir, rule)
        segments.append(compile_segment(
            irs, dictionary, name=irs[0].policy_name if irs else ""))
    tensors = assemble_tensors(segments, dictionary)
    result = certify_tensors(tensors)

    for key, status in result.statuses.items():
        if status == "host" or key not in by_rule:
            continue
        ir, rule = by_rule[key]
        msg = rule.validation.message or ""
        if "{{" in msg or "$(" in msg:
            result.diagnostics.append(make(
                "KT403",
                "device deny message cannot reproduce the host render: "
                "the validate message carries variable substitution",
                component="certify", policy=key[0], rule=key[1]))
        elif ir.n_alts > 1:
            result.diagnostics.append(make(
                "KT403",
                "anyPattern failure messages are composed per-pattern "
                "by the host walk; the device lane renders the rule-"
                "level message only",
                component="certify", policy=key[0], rule=key[1]))
    return result
