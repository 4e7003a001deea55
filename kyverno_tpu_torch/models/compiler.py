"""RuleIR -> pattern tensors.

Produces the static, device-resident representation of a policy set:

- a path dictionary (generalized paths; array segments are ``*``)
- flat check arrays (one row per leaf check)
- aux arrays (match/exclude filters, precondition/deny conditions — one row
  per primitive, reduced group -> filter/block -> rule on device)
- glob-NFA tables for string operands (consumed by ops/glob.py); literal
  NFAs compile metachars as plain bytes for exact-equality rows
- rule/alt/group segment maps for the verdict reduction (ops/eval.py)
- per-rule kind sets for the legacy prefilter (host-lane rules only;
  device rules carry their full match program as aux rows)

Compilation is *segmented*: each policy's rules compile into a
self-contained :class:`PolicySegment` whose rule/alt/group/gate ids are
local (base 0) but whose path/NFA/kind ids come from a shared append-only
:class:`TensorDictionary`. ``assemble_tensors`` concatenates segments
into one :class:`PolicyTensors`, rebasing the local ids — so a policy
update recompiles one segment and splices it in while every other
segment's rows (and every flatten-row memo keyed on the dictionary)
survive byte-identical. ``compile_tensors`` is the one-shot form:
a single segment over a throwaway dictionary, byte-identical to the
pre-segmentation compiler.

This is the analogue of kyverno/pkg/policycache building its kind index
at policy admission. The compiler is host Python; ``ops/eval.py`` turns
its segment maps into the device plan the CUDA kernels walk.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field, fields

import numpy as np

from ..runtime import featureplane
from .ir import (
    AUX_EXCLUDE,
    AUX_MATCH,
    AuxOp,
    CheckAnchor,
    CheckOp,
    EscalationReason,
    RuleIR,
    SEP,
    _title_first,
)

# Glob NFA geometry: patterns longer than NFA_STATES-1 chars or values
# longer than STR_LEN bytes take the host lane.
NFA_STATES = 48
STR_LEN = 64
MAX_SEGMENTS = 12


def incremental_enabled() -> bool:
    """KTPU_INCREMENTAL=0 disables segment splicing, epoch-keyed memo
    survival and rule-axis bucketing everywhere — every policy change
    then rebuilds its population from scratch. Read dynamically so tests
    can flip it per-case."""
    return featureplane.enabled_strict("KTPU_INCREMENTAL")


class _Host(Exception):
    """Raised inside segment compilation when a construct can't take the
    device lane (oversized glob, non-ASCII pattern); the rule falls back
    to host_only and compilation continues."""


class TensorDictionary:
    """Append-only path / glob-NFA / kind interner shared across segment
    compiles of one policy population.

    Ids are row indices, so append-only growth is the invariant that
    makes incremental compilation safe: a segment compiled at epoch *e*
    references the same rows at any epoch *e' >= e*, and a flatten-row
    memo cut at epoch *e* stays a valid prefix of any later batch.
    ``epoch`` counts appends to what the flatteners consume (paths and
    kinds — NFA rows are eval-side only); ``base`` names the lineage
    (uuid) when ``persistent`` so memo caches can key on it across
    recompiles, and is None for throwaway one-shot compiles."""

    def __init__(self, persistent: bool = False):
        self.paths: list[str] = []
        self.path_index: dict[str, int] = {}
        self.nfa_rows: list = []
        self.nfa_index: dict[tuple[str, bool], int] = {}
        self.kind_index: dict[str, int] = {}
        self.epoch = 0
        self.base: str | None = uuid.uuid4().hex if persistent else None

    def path_id(self, p: str) -> int:
        if p not in self.path_index:
            self.path_index[p] = len(self.paths)
            self.paths.append(p)
            self.epoch += 1
        return self.path_index[p]

    def nfa_id(self, pattern: str, literal: bool = False) -> int:
        key = (pattern, literal)
        if key in self.nfa_index:
            return self.nfa_index[key]
        row = _compile_glob(pattern, literal)
        if row is None:
            raise _Host(f"glob pattern not NFA-compilable: {pattern!r}")
        self.nfa_index[key] = len(self.nfa_rows)
        self.nfa_rows.append(row)
        return self.nfa_index[key]

    def kind_id(self, k: str) -> int:
        if k not in self.kind_index:
            self.kind_index[k] = len(self.kind_index)
            self.epoch += 1
        return self.kind_index[k]

    def ensure_nonempty(self) -> None:
        """A rule set whose device lane is pure gates (kind-only match, no
        pattern paths — e.g. a mutate-gate screen) still needs a non-empty
        path axis for the kernel's gathers; the sentinel is never
        referenced by any check (and deliberately not interned, matching
        the historical compiler)."""
        if not self.paths:
            self.paths.append("metadata")
            self.epoch += 1


@dataclass
class PolicyTensors:
    # path dictionary
    paths: list[str]                      # SEP-joined generalized paths
    path_index: dict[str, int]
    path_wildcards: np.ndarray            # [P] number of '*' segments

    # checks (C rows)
    chk_path: np.ndarray                  # [C] int32 path id
    chk_op: np.ndarray                    # [C] int8 CheckOp
    chk_rule: np.ndarray                  # [C] int32 rule row
    chk_alt_gid: np.ndarray               # [C] int32 global alt id
    chk_group_gid: np.ndarray             # [C] int32 global group id
    chk_gate: np.ndarray                  # [C] int32 global gate id (-1 none)
    chk_guard: np.ndarray                 # [C] uint16 guard depth bitmask
    chk_is_gate_row: np.ndarray           # [C] bool (ELEMENT_GATE rows)
    chk_is_cond: np.ndarray               # [C] bool (CONDITION/GLOBAL rows)
    chk_tracked: np.ndarray               # [C] bool (anchorMap-tracked rows)
    chk_existence: np.ndarray             # [C] bool OR-over-elements
    chk_nfa: np.ndarray                   # [C] int32 NFA id (-1 none)
    chk_num_lo: np.ndarray                # [C] int64 micro-units
    chk_num_hi: np.ndarray                # [C] int64
    chk_bool: np.ndarray                  # [C] bool
    chk_num_fallback: np.ndarray          # [C] bool
    chk_num_mode: np.ndarray              # [C] int8 (ir.CheckIR.num_mode)
    chk_track_depth: np.ndarray           # [C] int8 anchorMap key depth (-1)
    chk_cond_depth: np.ndarray            # [C] int8 condition key depth (-1)

    # group -> alt -> rule segment maps
    n_groups: int
    n_alts: int
    group_alt: np.ndarray                 # [G] int32 alt id of each group
    alt_rule: np.ndarray                  # [A] int32 rule row of each alt
    n_gates: int

    # aux rows (X rows): match/exclude/precondition/deny primitives
    ax_path: np.ndarray                   # [X] int32 path id (-1 constant)
    ax_plen: np.ndarray                   # [X] int8 path segment count
    ax_op: np.ndarray                     # [X] int8 AuxOp
    ax_rule: np.ndarray                   # [X] int32
    ax_group: np.ndarray                  # [X] int32 global aux-group id
    ax_kind_req: np.ndarray               # [X] int32 kind id (-1 any)
    ax_nfa: np.ndarray                    # [X] int32 (-1 none)
    ax_absent: np.ndarray                 # [X] bool result for absent leaf
    ax_err_absent: np.ndarray             # [X] bool deny: absent -> ERROR
    ax_allow_num: np.ndarray              # [X] bool numeric keys allowed (In)
    ax_key_pat: np.ndarray                # [X] bool key acts as the pattern
    ax_obool: np.ndarray                  # [X] bool
    ax_is_obool: np.ndarray               # [X] bool operand is bool
    ax_is_ostr: np.ndarray                # [X] bool operand is string
    ax_is_onum: np.ndarray                # [X] bool operand is numeric
    ax_is_odur: np.ndarray                # [X] bool (strict, non-"0")
    ax_is_odur_any: np.ndarray            # [X] bool
    ax_is_ofloat: np.ndarray              # [X] bool
    ax_is_oint: np.ndarray                # [X] bool
    ax_is_oquant: np.ndarray              # [X] bool
    ax_q_hi: np.ndarray                   # [X] int64 -> limbs in eval
    ax_q_lo: np.ndarray
    ax_s_hi: np.ndarray
    ax_s_lo: np.ndarray

    # aux groups (GX): rows OR within a group, then XOR negate
    n_aux_groups: int
    axg_negate: np.ndarray                # [GX] bool
    axg_klass: np.ndarray                 # [GX] int8
    axg_rule: np.ndarray                  # [GX] int32
    axg_any: np.ndarray                   # [GX] bool (condition any-block)
    axg_filt: np.ndarray                  # [GX] int32 global filter (-1)

    # aux filters (FX): groups AND within a filter
    n_aux_filters: int
    axf_rule: np.ndarray                  # [FX] int32
    axf_is_exclude: np.ndarray            # [FX] bool

    # per-rule aux modes
    rule_match_any: np.ndarray            # [R] bool (match.any -> OR)
    rule_has_match: np.ndarray            # [R] bool (device match program)
    rule_has_exclude: np.ndarray          # [R] bool
    rule_exclude_all: np.ndarray          # [R] bool (exclude.all -> AND)
    rule_has_precond: np.ndarray          # [R] bool
    rule_precond_any: np.ndarray          # [R] bool (has an any-block)
    rule_is_deny: np.ndarray              # [R] bool
    rule_deny_any: np.ndarray             # [R] bool

    # NFA tables [N, S]
    nfa_char: np.ndarray                  # uint8 literal char (0 if meta)
    nfa_is_star: np.ndarray               # bool
    nfa_is_q: np.ndarray                  # bool
    nfa_len: np.ndarray                   # [N] int32 pattern length

    # rules (R rows, includes host-only rules for verdict indexing)
    n_rules: int
    rule_kind_ids: np.ndarray             # [R, KMAX] int32, -1 padding
    rule_match_all_kinds: np.ndarray      # [R] bool ('*' kind)
    rule_host_only: np.ndarray            # [R] bool
    kind_index: dict[str, int]
    rules: list[RuleIR] = field(default_factory=list)

    # -- incremental-compilation provenance (assemble_tensors) ----------
    # lineage id of the shared TensorDictionary (None for one-shot
    # compiles) and its append counter at assembly time; memo caches key
    # on (memo_space, digest) and revalidate rows across epochs
    dict_base: str | None = None
    dict_epoch: int = 0
    # true rule count when the rule axis is padded to a power-of-two
    # bucket (rule-axis bucketing); -1 = unpadded (n_rules is logical)
    n_rules_logical: int = -1
    # SegmentSpan per assembled segment ([] for one-shot compiles)
    segments: list = field(default_factory=list)

    @property
    def n_paths(self) -> int:
        return len(self.paths)

    @property
    def n_rules_live(self) -> int:
        """Logical rule count: columns past this are inert bucket padding
        (verdict NOT_APPLICABLE by construction) and are sliced off
        before any verdict matrix reaches a caller."""
        return self.n_rules if self.n_rules_logical < 0 else self.n_rules_logical

    def decidability_summary(self) -> dict:
        """Compiled-set device-decidability: how many live rules the
        device lattice decides vs. how many detour through the CPU
        oracle. The dry-run blast-radius report carries this so whoever
        approves a rollout sees whether the candidate rides the fast
        path before enforcement."""
        live = self.n_rules_live
        host = int(np.asarray(self.rule_host_only[:live]).sum())
        return {
            "rules": live,
            "host_only": host,
            "device_decidable": live - host,
            "device_fraction": round((live - host) / live, 4)
            if live else 1.0,
        }

    @property
    def memo_space(self) -> str:
        """Key space for flatten-row memos: the dictionary lineage when
        compiled incrementally (stable across splices — rows revalidate
        by epoch), else the content fingerprint (exact match only)."""
        return self.dict_base if self.dict_base is not None else self.fingerprint

    @property
    def fingerprint(self) -> str:
        """Content hash of everything the flatteners consume: the path
        dictionary (order-sensitive — path ids are row indices) and the
        kind index. Two compiles with the same fingerprint produce
        byte-identical FlatBatch/PackedBatch encodings for any resource,
        so native flattener handles keyed on it survive policy recompiles
        that don't move the dictionary."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            import hashlib

            kinds = [""] * len(self.kind_index)
            for k, i in self.kind_index.items():
                kinds[i] = k
            h = hashlib.blake2b(digest_size=16)
            h.update("\n".join(self.paths).encode("utf-8"))
            h.update(b"\x00")
            h.update("\n".join(kinds).encode("utf-8"))
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp


def _compile_glob(pattern: str, literal: bool = False):
    """Glob pattern -> NFA row (char / is_star / is_q per state). Runs of
    '*' collapse to one so the NFA epsilon-closure is a single shift.
    ``literal`` compiles metachars as plain bytes (exact equality rows)."""
    if not literal:
        while "**" in pattern:
            pattern = pattern.replace("**", "*")
    if len(pattern) > NFA_STATES - 1:
        return None
    char = np.zeros(NFA_STATES, dtype=np.uint8)
    star = np.zeros(NFA_STATES, dtype=bool)
    q = np.zeros(NFA_STATES, dtype=bool)
    for i, ch in enumerate(pattern):
        b = ch.encode("utf-8")
        if len(b) != 1:
            return None  # non-ASCII pattern: host lane
        if ch == "*" and not literal:
            star[i] = True
        elif ch == "?" and not literal:
            q[i] = True
        else:
            char[i] = b[0]
    return char, star, q, len(pattern)


_AUX_COL_NAMES = (
    "path", "plen", "op", "rule", "group", "kind_req", "nfa", "absent",
    "err_absent", "allow_num", "key_pat", "obool", "is_obool", "is_ostr",
    "is_onum", "is_odur", "is_odur_any", "is_ofloat", "is_oint", "is_oquant",
    "q", "s",
)

_CHK_COL_NAMES = (
    "path", "op", "rule", "alt", "group", "gate", "guard", "is_gate",
    "is_cond", "tracked", "exist", "nfa", "lo", "hi", "bool", "numfb",
    "num_mode", "track_depth", "cond_depth",
)

_RULE_FLAG_NAMES = (
    "match_any", "has_match", "has_exclude", "exclude_all",
    "has_precond", "precond_any", "is_deny", "deny_any",
)


@dataclass(frozen=True)
class SegmentSpan:
    """Row ranges one assembled segment occupies inside a PolicyTensors —
    the splice receipt the KT3xx invariant checks validate (a corrupted
    rebase shows up as ids escaping their span)."""

    name: str
    rule_base: int
    n_rules: int
    chk: tuple[int, int]                  # (start, length) in check rows
    alt: tuple[int, int]
    group: tuple[int, int]
    gate: tuple[int, int]
    aux: tuple[int, int]
    axg: tuple[int, int]
    axf: tuple[int, int]


@dataclass
class PolicySegment:
    """One policy's compiled tensor rows, self-contained: rule / alt /
    group / gate / aux-group / aux-filter ids are *local* (all bases 0)
    while path / NFA / kind ids are *global* (interned into the shared
    TensorDictionary). ``assemble_tensors`` rebases the local axes when
    concatenating, so a segment compiled once splices unchanged into any
    later assembly of its lineage."""

    name: str
    rule_irs: list[RuleIR]
    n_rules: int
    n_gates: int
    dict_epoch: int                       # dictionary epoch after compile
    chk: dict[str, list]
    group_alt: list[int]
    alt_rule: list[int]
    aux: dict[str, list]
    axg_negate: list
    axg_klass: list
    axg_rule: list
    axg_any: list
    axg_filt: list
    axf_rule: list
    axf_is_exclude: list
    rule_flags: dict[str, np.ndarray]     # [n_rules] each, _RULE_FLAG_NAMES
    kind_slots: list[list[int]]           # per local rule: kind id / -1('*')
    rule_all_kinds: np.ndarray            # [n_rules] bool
    rule_host_only: np.ndarray            # [n_rules] bool

    @property
    def n_alts(self) -> int:
        return len(self.alt_rule)

    @property
    def n_groups(self) -> int:
        return len(self.group_alt)


def compile_segment(rule_irs: list[RuleIR], dictionary: TensorDictionary,
                    name: str = "") -> PolicySegment:
    """Compile one policy's RuleIRs into a self-contained segment.

    ``rule_irs`` carry segment-local ``rule_index`` values (0..n-1);
    global rule rows are assigned at assembly by adding the segment's
    rule base. Dictionary ids (paths, NFAs, kinds) are appended to
    ``dictionary`` and are final — append-only growth means they never
    move under an already-compiled segment."""
    path_id = dictionary.path_id
    nfa_id = dictionary.nfa_id
    kind_id = dictionary.kind_id

    # validate device-lane constraints that depend on tensor geometry
    for rule in rule_irs:
        if rule.host_only:
            continue
        for c in rule.checks:
            if len(c.path.split(SEP)) > MAX_SEGMENTS:
                rule.host_only = True
                rule.host_reason = "path too deep"
                rule.host_reason_code = EscalationReason.GEOMETRY.value
                break
        for a in rule.aux_rows:
            if a.path and len(a.path.split(SEP)) > MAX_SEGMENTS:
                rule.host_only = True
                rule.host_reason = "aux path too deep"
                rule.host_reason_code = EscalationReason.GEOMETRY.value
                break

    chk_cols: dict[str, list] = {k: [] for k in _CHK_COL_NAMES}
    group_alt: list[int] = []
    alt_rule: list[int] = []
    n_gates_total = 0

    aux: dict[str, list] = {k: [] for k in _AUX_COL_NAMES}
    axg_negate: list[bool] = []
    axg_klass: list[int] = []
    axg_rule: list[int] = []
    axg_any: list[bool] = []
    axg_filt: list[int] = []
    axf_rule: list[int] = []
    axf_is_exclude: list[bool] = []

    n_rules = max((r.rule_index for r in rule_irs), default=-1) + 1
    rule_flags = {k: np.zeros(n_rules, dtype=bool) for k in _RULE_FLAG_NAMES}

    for rule in rule_irs:
        if rule.host_only:
            continue
        # -------- per-rule local buffers (no global rollback needed)
        local_chk = {k: [] for k in chk_cols}
        local_alt_rule: list[int] = []
        local_group_alt: list[int] = []
        local_groups: dict[tuple[int, int], int] = {}
        local_gates = rule.n_gates
        local_aux = {k: [] for k in aux}
        l_axg: list[tuple[bool, int, int, bool, int]] = []
        l_axf: list[tuple[int, bool]] = []

        alt_base = len(alt_rule)
        group_base = len(group_alt)
        gate_base = n_gates_total
        aux_group_base = len(axg_negate)
        aux_filter_base = len(axf_rule)

        try:
            for _ in range(rule.n_alts):
                local_alt_rule.append(rule.rule_index)

            for c in rule.checks:
                key = (c.alt, c.group)
                if key not in local_groups:
                    local_groups[key] = group_base + len(local_group_alt)
                    local_group_alt.append(alt_base + c.alt)
                gid = local_groups[key]

                n = -1
                if c.op in (CheckOp.STR_EQ, CheckOp.STR_NE):
                    n = nfa_id(c.pattern_str)

                is_gate = c.anchor is CheckAnchor.ELEMENT_GATE
                is_cond = c.anchor in (CheckAnchor.CONDITION, CheckAnchor.GLOBAL)
                tracked = is_cond or is_gate or c.op is CheckOp.ABSENT or c.existence
                segments = c.path.split(SEP)
                if is_cond:
                    track_depth = c.cond_depth
                elif c.existence:
                    # the existence anchor's own '*' (the LAST one): its
                    # preceding segment is the anchored key
                    track_depth = (len(segments) - 1 - segments[::-1].index("*")
                                   if "*" in segments else len(segments))
                elif is_gate or c.op is CheckOp.ABSENT:
                    track_depth = len(segments)
                else:
                    track_depth = -1

                local_chk["path"].append(path_id(c.path))
                local_chk["op"].append(int(c.op))
                local_chk["rule"].append(rule.rule_index)
                local_chk["alt"].append(alt_base + c.alt)
                local_chk["group"].append(gid)
                local_chk["gate"].append(gate_base + c.gate if c.gate >= 0 else -1)
                local_chk["guard"].append(c.guard_mask)
                local_chk["is_gate"].append(is_gate)
                local_chk["is_cond"].append(is_cond)
                local_chk["tracked"].append(tracked)
                local_chk["exist"].append(c.existence)
                local_chk["nfa"].append(n)
                local_chk["lo"].append(c.num_lo)
                local_chk["hi"].append(c.num_hi)
                local_chk["bool"].append(c.bool_val)
                local_chk["numfb"].append(c.num_fallback)
                local_chk["num_mode"].append(c.num_mode)
                local_chk["track_depth"].append(track_depth)
                local_chk["cond_depth"].append(c.cond_depth)

            # -------- aux rows
            filt_map: dict[tuple[int, int], int] = {}
            group_map: dict[int, int] = {}
            for a in rule.aux_rows:
                if a.klass in (AUX_MATCH, AUX_EXCLUDE):
                    fkey = (a.klass, a.filt)
                    if fkey not in filt_map:
                        filt_map[fkey] = aux_filter_base + len(l_axf)
                        l_axf.append((rule.rule_index, a.klass == AUX_EXCLUDE))
                    gfilt = filt_map[fkey]
                else:
                    gfilt = -1
                if a.group not in group_map:
                    group_map[a.group] = aux_group_base + len(l_axg)
                    l_axg.append((a.group_negate, a.klass, rule.rule_index,
                                  a.any_block, gfilt))
                gid = group_map[a.group]

                n = -1
                if a.op in (AuxOp.GLOB, AuxOp.CIN_ITEM, AuxOp.CIN_GLOB) or (
                    a.op is AuxOp.CEQ and a.o_is_str
                ):
                    n = nfa_id(a.pattern, a.literal)

                kreq = kind_id(a.kind_req) if a.kind_req else -1
                pid = path_id(a.path) if a.path else -1
                plen = len(a.path.split(SEP)) if a.path else 0

                local_aux["path"].append(pid)
                local_aux["plen"].append(plen)
                local_aux["op"].append(int(a.op))
                local_aux["rule"].append(rule.rule_index)
                local_aux["group"].append(gid)
                local_aux["kind_req"].append(kreq)
                local_aux["nfa"].append(n)
                local_aux["absent"].append(a.absent_res)
                local_aux["err_absent"].append(a.err_on_absent and bool(a.path))
                local_aux["allow_num"].append(a.allow_num_key)
                local_aux["key_pat"].append(a.key_is_pattern)
                local_aux["obool"].append(a.o_bool)
                local_aux["is_obool"].append(a.o_is_bool)
                local_aux["is_ostr"].append(a.o_is_str)
                local_aux["is_onum"].append(a.o_is_num)
                local_aux["is_odur"].append(a.o_is_dur)
                local_aux["is_odur_any"].append(a.o_is_dur_any)
                local_aux["is_ofloat"].append(a.o_is_float)
                local_aux["is_oint"].append(a.o_is_int)
                local_aux["is_oquant"].append(a.o_is_quant)
                local_aux["q"].append(a.o_qmicro)
                local_aux["s"].append(a.o_smicro)
        except _Host as e:
            rule.host_only = True
            rule.host_reason = str(e)
            rule.host_reason_code = EscalationReason.GEOMETRY.value
            continue

        # -------- commit the rule
        for k in chk_cols:
            chk_cols[k].extend(local_chk[k])
        alt_rule.extend(local_alt_rule)
        group_alt.extend(local_group_alt)
        n_gates_total += local_gates
        for k in aux:
            aux[k].extend(local_aux[k])
        for neg, klass, r_idx, any_b, gfilt in l_axg:
            axg_negate.append(neg)
            axg_klass.append(klass)
            axg_rule.append(r_idx)
            axg_any.append(any_b)
            axg_filt.append(gfilt)
        for r_idx, is_ex in l_axf:
            axf_rule.append(r_idx)
            axf_is_exclude.append(is_ex)

        rule_flags["match_any"][rule.rule_index] = rule.match_any
        rule_flags["has_match"][rule.rule_index] = rule.n_match_filters > 0
        rule_flags["has_exclude"][rule.rule_index] = rule.n_exclude_filters > 0
        rule_flags["exclude_all"][rule.rule_index] = rule.exclude_all
        rule_flags["has_precond"][rule.rule_index] = rule.has_precond
        rule_flags["precond_any"][rule.rule_index] = rule.precond_has_any
        rule_flags["is_deny"][rule.rule_index] = rule.is_deny
        rule_flags["deny_any"][rule.rule_index] = rule.deny_has_any

    # legacy kind prefilter (host-lane rules route to the oracle by kind)
    kind_slots: list[list[int]] = [[] for _ in range(n_rules)]
    rule_all_kinds = np.zeros(n_rules, dtype=bool)
    rule_host = np.zeros(n_rules, dtype=bool)
    for rule in rule_irs:
        rule_host[rule.rule_index] = rule.host_only
        slots = kind_slots[rule.rule_index]
        for k in rule.kinds:
            if k == "*":
                rule_all_kinds[rule.rule_index] = True
                slots.append(-1)
            else:
                # "Pod" matches "Pod" and "v1/Pod" style GVKs; store the
                # title-cased bare kind (utils.go checkKind title match)
                slots.append(kind_id(_title_first(k.split("/")[-1])))

    return PolicySegment(
        name=name,
        rule_irs=rule_irs,
        n_rules=n_rules,
        n_gates=n_gates_total,
        dict_epoch=dictionary.epoch,
        chk=chk_cols,
        group_alt=group_alt,
        alt_rule=alt_rule,
        aux=aux,
        axg_negate=axg_negate,
        axg_klass=axg_klass,
        axg_rule=axg_rule,
        axg_any=axg_any,
        axg_filt=axg_filt,
        axf_rule=axf_rule,
        axf_is_exclude=axf_is_exclude,
        rule_flags=rule_flags,
        kind_slots=kind_slots,
        rule_all_kinds=rule_all_kinds,
        rule_host_only=rule_host,
    )


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def assemble_tensors(segments: list[PolicySegment],
                     dictionary: TensorDictionary,
                     rule_bucket: bool = False) -> PolicyTensors:
    """Concatenate compiled segments into one PolicyTensors, rebasing the
    local rule/alt/group/gate/aux axes by running offsets. Dictionary ids
    pass through untouched (they are global by construction).

    ``rule_bucket`` pads the rule axis to the next power of two with
    inert rules (no alts -> not covered -> NOT_APPLICABLE in ops/eval.py)
    so single-policy churn tends to land in an already-built shape; ``n_rules_logical`` records the true count and verdict
    consumers slice back to it."""
    chk_cols: dict[str, list] = {k: [] for k in _CHK_COL_NAMES}
    group_alt: list[int] = []
    alt_rule: list[int] = []
    aux: dict[str, list] = {k: [] for k in _AUX_COL_NAMES}
    axg_negate: list[bool] = []
    axg_klass: list[int] = []
    axg_rule: list[int] = []
    axg_any: list[bool] = []
    axg_filt: list[int] = []
    axf_rule: list[int] = []
    axf_is_exclude: list[bool] = []
    rule_irs: list[RuleIR] = []
    spans: list[SegmentSpan] = []

    rule_base = alt_base = group_base = gate_base = 0
    axg_base = axf_base = 0
    for seg in segments:
        spans.append(SegmentSpan(
            name=seg.name,
            rule_base=rule_base,
            n_rules=seg.n_rules,
            chk=(len(chk_cols["rule"]), len(seg.chk["rule"])),
            alt=(alt_base, seg.n_alts),
            group=(group_base, seg.n_groups),
            gate=(gate_base, seg.n_gates),
            aux=(len(aux["rule"]), len(seg.aux["rule"])),
            axg=(axg_base, len(seg.axg_negate)),
            axf=(axf_base, len(seg.axf_rule)),
        ))
        for k in chk_cols:
            src = seg.chk[k]
            if k == "rule":
                chk_cols[k].extend(v + rule_base for v in src)
            elif k == "alt":
                chk_cols[k].extend(v + alt_base for v in src)
            elif k == "group":
                chk_cols[k].extend(v + group_base for v in src)
            elif k == "gate":
                chk_cols[k].extend(
                    v + gate_base if v >= 0 else -1 for v in src)
            else:
                chk_cols[k].extend(src)
        alt_rule.extend(v + rule_base for v in seg.alt_rule)
        group_alt.extend(v + alt_base for v in seg.group_alt)
        for k in aux:
            src = seg.aux[k]
            if k == "rule":
                aux[k].extend(v + rule_base for v in src)
            elif k == "group":
                aux[k].extend(v + axg_base for v in src)
            else:
                aux[k].extend(src)
        axg_negate.extend(seg.axg_negate)
        axg_klass.extend(seg.axg_klass)
        axg_rule.extend(v + rule_base for v in seg.axg_rule)
        axg_any.extend(seg.axg_any)
        axg_filt.extend(v + axf_base if v >= 0 else -1 for v in seg.axg_filt)
        axf_rule.extend(v + rule_base for v in seg.axf_rule)
        axf_is_exclude.extend(seg.axf_is_exclude)
        rule_irs.extend(seg.rule_irs)

        rule_base += seg.n_rules
        alt_base += seg.n_alts
        group_base += seg.n_groups
        gate_base += seg.n_gates
        axg_base += len(seg.axg_negate)
        axf_base += len(seg.axf_rule)

    n_rules_logical = rule_base
    n_rules = _next_pow2(n_rules_logical) if rule_bucket else n_rules_logical
    pad = n_rules - n_rules_logical

    rule_flag_arrs = {}
    for key in _RULE_FLAG_NAMES:
        parts = [seg.rule_flags[key] for seg in segments]
        arr = (np.concatenate(parts) if parts
               else np.zeros(0, dtype=bool))
        if pad:
            arr = np.concatenate([arr, np.zeros(pad, dtype=bool)])
        rule_flag_arrs[key] = arr

    kmax = max((len(s) for seg in segments for s in seg.kind_slots),
               default=1) or 1
    rule_kinds = np.full((n_rules, kmax), -1, dtype=np.int32)
    rule_all_kinds = np.zeros(n_rules, dtype=bool)
    rule_host = np.zeros(n_rules, dtype=bool)
    i = 0
    for seg in segments:
        rule_all_kinds[i:i + seg.n_rules] = seg.rule_all_kinds
        rule_host[i:i + seg.n_rules] = seg.rule_host_only
        for slots in seg.kind_slots:
            for j, kid in enumerate(slots):
                rule_kinds[i, j] = kid
            i += 1
    i += pad  # pad rules: no kinds, not host, not '*'

    dictionary.ensure_nonempty()
    paths = list(dictionary.paths)
    path_index = dict(dictionary.path_index)

    nfa_rows = dictionary.nfa_rows
    if nfa_rows:
        nfa_char = np.stack([r[0] for r in nfa_rows])
        nfa_star = np.stack([r[1] for r in nfa_rows])
        nfa_q = np.stack([r[2] for r in nfa_rows])
        nfa_len = np.array([r[3] for r in nfa_rows], dtype=np.int32)
    else:
        nfa_char = np.zeros((1, NFA_STATES), dtype=np.uint8)
        nfa_star = np.zeros((1, NFA_STATES), dtype=bool)
        nfa_q = np.zeros((1, NFA_STATES), dtype=bool)
        nfa_len = np.zeros(1, dtype=np.int32)

    def arr(cols, k, dtype):
        return np.array(cols[k], dtype=dtype)

    q_arr = np.array(aux["q"], dtype=np.int64)
    s_arr = np.array(aux["s"], dtype=np.int64)

    return PolicyTensors(
        paths=paths,
        path_index=path_index,
        path_wildcards=np.array([p.split(SEP).count("*") for p in paths], dtype=np.int32),
        chk_path=arr(chk_cols, "path", np.int32),
        chk_op=arr(chk_cols, "op", np.int8),
        chk_rule=arr(chk_cols, "rule", np.int32),
        chk_alt_gid=arr(chk_cols, "alt", np.int32),
        chk_group_gid=arr(chk_cols, "group", np.int32),
        chk_gate=arr(chk_cols, "gate", np.int32),
        chk_guard=arr(chk_cols, "guard", np.uint16),
        chk_is_gate_row=arr(chk_cols, "is_gate", bool),
        chk_is_cond=arr(chk_cols, "is_cond", bool),
        chk_tracked=arr(chk_cols, "tracked", bool),
        chk_existence=arr(chk_cols, "exist", bool),
        chk_nfa=arr(chk_cols, "nfa", np.int32),
        chk_num_lo=arr(chk_cols, "lo", np.int64),
        chk_num_hi=arr(chk_cols, "hi", np.int64),
        chk_bool=arr(chk_cols, "bool", bool),
        chk_num_fallback=arr(chk_cols, "numfb", bool),
        chk_num_mode=arr(chk_cols, "num_mode", np.int8),
        chk_track_depth=arr(chk_cols, "track_depth", np.int8),
        chk_cond_depth=arr(chk_cols, "cond_depth", np.int8),
        n_groups=len(group_alt),
        n_alts=len(alt_rule),
        group_alt=np.array(group_alt, dtype=np.int32) if group_alt else np.zeros(0, np.int32),
        alt_rule=np.array(alt_rule, dtype=np.int32) if alt_rule else np.zeros(0, np.int32),
        n_gates=gate_base,
        ax_path=arr(aux, "path", np.int32),
        ax_plen=arr(aux, "plen", np.int8),
        ax_op=arr(aux, "op", np.int8),
        ax_rule=arr(aux, "rule", np.int32),
        ax_group=arr(aux, "group", np.int32),
        ax_kind_req=arr(aux, "kind_req", np.int32),
        ax_nfa=arr(aux, "nfa", np.int32),
        ax_absent=arr(aux, "absent", bool),
        ax_err_absent=arr(aux, "err_absent", bool),
        ax_allow_num=arr(aux, "allow_num", bool),
        ax_key_pat=arr(aux, "key_pat", bool),
        ax_obool=arr(aux, "obool", bool),
        ax_is_obool=arr(aux, "is_obool", bool),
        ax_is_ostr=arr(aux, "is_ostr", bool),
        ax_is_onum=arr(aux, "is_onum", bool),
        ax_is_odur=arr(aux, "is_odur", bool),
        ax_is_odur_any=arr(aux, "is_odur_any", bool),
        ax_is_ofloat=arr(aux, "is_ofloat", bool),
        ax_is_oint=arr(aux, "is_oint", bool),
        ax_is_oquant=arr(aux, "is_oquant", bool),
        ax_q_hi=(q_arr >> 31).astype(np.int32),
        ax_q_lo=(q_arr & 0x7FFFFFFF).astype(np.int32),
        ax_s_hi=(s_arr >> 31).astype(np.int32),
        ax_s_lo=(s_arr & 0x7FFFFFFF).astype(np.int32),
        n_aux_groups=len(axg_negate),
        axg_negate=np.array(axg_negate, dtype=bool),
        axg_klass=np.array(axg_klass, dtype=np.int8),
        axg_rule=np.array(axg_rule, dtype=np.int32),
        axg_any=np.array(axg_any, dtype=bool),
        axg_filt=np.array(axg_filt, dtype=np.int32),
        n_aux_filters=len(axf_rule),
        axf_rule=np.array(axf_rule, dtype=np.int32),
        axf_is_exclude=np.array(axf_is_exclude, dtype=bool),
        rule_match_any=rule_flag_arrs["match_any"],
        rule_has_match=rule_flag_arrs["has_match"],
        rule_has_exclude=rule_flag_arrs["has_exclude"],
        rule_exclude_all=rule_flag_arrs["exclude_all"],
        rule_has_precond=rule_flag_arrs["has_precond"],
        rule_precond_any=rule_flag_arrs["precond_any"],
        rule_is_deny=rule_flag_arrs["is_deny"],
        rule_deny_any=rule_flag_arrs["deny_any"],
        nfa_char=nfa_char,
        nfa_is_star=nfa_star,
        nfa_is_q=nfa_q,
        nfa_len=nfa_len,
        n_rules=n_rules,
        rule_kind_ids=rule_kinds,
        rule_match_all_kinds=rule_all_kinds,
        rule_host_only=rule_host,
        kind_index=dict(dictionary.kind_index),
        rules=rule_irs,
        dict_base=dictionary.base,
        dict_epoch=dictionary.epoch,
        n_rules_logical=n_rules_logical,
        segments=spans,
    )


def tensor_nbytes(t: PolicyTensors) -> int:
    """Footprint of one PolicyTensors: the sum of its numpy arrays (the
    dictionary's paths and Python metadata excluded). A policy shard's
    bytes over the full set's are about 1 / policy shards, plus the rule
    bucket's padding."""
    total = 0
    for f in fields(t):
        v = getattr(t, f.name)
        if isinstance(v, np.ndarray):
            total += v.nbytes
    return total


def compile_tensors(rule_irs: list[RuleIR]) -> PolicyTensors:
    """One-shot compile: a single segment over a throwaway dictionary.
    Byte-identical output to the pre-segmentation compiler — the append
    order through the dictionary and the assembly of exactly one segment
    (all rebase offsets 0) reproduce the historical row layout."""
    dictionary = TensorDictionary()
    seg = compile_segment(rule_irs, dictionary)
    return assemble_tensors([seg], dictionary)
