"""Validate-pattern -> check IR.

Compiles the recursive JSON pattern of a validate rule
(kyverno/pkg/engine/validate/validate.go) into a flat list of leaf
checks. Each check is one row of the eventual pattern tensor:

    (path, anchor, element-gate, op, operand)

Anchors become row attributes instead of control flow
(SURVEY.md section 7 item 1):
  - condition ``(k)`` / global ``<(k)`` in maps  -> rule-skip predicate rows
  - condition inside a list element              -> element gate rows
  - equality ``=(k)``                            -> absent-passes rows
  - negation ``X(k)``                            -> must-be-absent rows
  - existence ``^(k)``                           -> OR-over-elements rows

Rules using constructs outside the supported subset (variables, deny,
foreach, multi-element pattern arrays, nested existence, ...) are marked
``host_only`` and evaluated by the CPU oracle tier instead.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import Enum, IntEnum
from fractions import Fraction

from ..engine.anchors import Anchor, anchor_kind, remove_anchor
from ..engine.pattern import Op, get_operator
from ..engine.variables import REGEX_VARIABLES, REGEX_REFERENCES
from ..utils.quantity import QuantityError, parse_quantity


# Internal path separator: map keys legitimately contain "/" (label keys
# like app.kubernetes.io/name), so segments join on a control char. Render
# with display_path() for messages.
SEP = "\x1f"

# Reserved first segments for paths that resolve outside the resource body:
# REQ_MARK roots in the per-request envelope (operation, namespace, ...);
# NSEFF_MARK is the "effective namespace" (resource name for Namespace
# kinds, metadata.namespace otherwise — utils.go checkNamespace semantics).
REQ_MARK = "\x02req"
NSEFF_MARK = "\x02nseff"


def display_path(path: str) -> str:
    return "/" + path.replace(SEP, "/")


class CheckOp(IntEnum):
    STR_EQ = 0        # glob match (NFA)
    STR_NE = 1        # glob non-match
    NUM_EQ = 2
    NUM_NE = 3
    NUM_GT = 4
    NUM_GE = 5
    NUM_LT = 6
    NUM_LE = 7
    NUM_IN_RANGE = 8
    NUM_NOT_IN_RANGE = 9
    BOOL_EQ = 10
    IS_NULL = 11
    EXISTS_OBJECT = 12  # pattern {} -> value must be a map
    ABSENT = 13         # negation anchor: path must not exist
    EXISTS_NONNIL = 14  # DefaultHandler "*": key present and non-null
                        # (anchor/anchor.go:118)
    EXISTS_LIST = 15    # gated list with no sibling fields: the list
                        # itself must exist AS a list; its elements are
                        # vacuous (every element matches-and-has-no-rest
                        # or is condition-skipped)


class CheckAnchor(IntEnum):
    NONE = 0
    CONDITION = 1   # fail -> rule skip
    GLOBAL = 2      # fail -> rule skip (same verdict effect at rule level)
    EQUALITY = 3    # absent -> pass
    ELEMENT_GATE = 4  # per-element condition inside a list


class EscalationReason(str, Enum):
    """Machine-readable taxonomy for why a rule (or one of its checks)
    escalates to the CPU oracle. Shared by three consumers: the compiler's
    ``HostOnly`` raises, the static analyzer's KT1xx escalation-provenance
    diagnostics, and the runtime escalation metrics
    (runtime/metrics.py record_host_rule_info) — one vocabulary end to end
    so a dashboard label and a lint finding always mean the same thing."""

    VARIABLE_REFERENCE = "variable-reference"    # {{var}} / $(ref) operands
    METACHAR_KEY = "metachar-key"                # wildcard map/label keys
    UNPARSEABLE_QUANTITY = "unparseable-quantity"  # precision/overflow/form
    UNSUPPORTED_OPERATOR = "unsupported-operator"  # operator off-lattice
    ANCHOR_ORDERING = "anchor-ordering"          # order-dependent anchors
    PATTERN_SHAPE = "pattern-shape"              # structure off the lattice
    ADMISSION_CONTEXT = "admission-context"      # userinfo / ns selector
    EXTERNAL_CONTEXT = "external-context"        # context: apiCall/configMap
    FOREACH = "foreach"                          # foreach validation
    UNSUPPORTED_CONSTRUCT = "unsupported-construct"  # everything else
    GEOMETRY = "geometry"                        # tensor limits (depth/NFA)


class HostOnly(Exception):
    """Raised during compilation when a construct needs the CPU oracle.

    Carries the human-readable ``detail`` plus a machine-readable
    ``reason`` (EscalationReason) so the analyzer and runtime metrics
    never have to parse message strings."""

    def __init__(self, detail: str = "",
                 reason: "EscalationReason | None" = None):
        super().__init__(detail)
        self.detail = detail
        self.reason = reason or EscalationReason.UNSUPPORTED_CONSTRUCT


# ----------------------------------------------------------------- aux rows
#
# Match/exclude filters (utils.go:265 MatchesResourceDescription) and
# precondition/deny condition lists (variables/evaluate.go:11) compile to
# "aux rows": per-(resource, rule) boolean programs evaluated alongside the
# pattern checks. Rows OR within a group; a group's result XORs with its
# negate flag; groups AND within a filter (match/exclude) or combine as
# any/all blocks (conditions).


AUX_MATCH = 0
AUX_EXCLUDE = 1
AUX_PRECOND = 2
AUX_DENY = 3


class AuxOp(IntEnum):
    TRUE = 0          # constant (kind-only rows / folded static conditions)
    FALSE = 1
    GLOB = 2          # NFA(pattern) over the value string at path
    EXISTS = 3        # leaf present
    NOT_EXISTS = 4    # leaf absent
    CEQ = 5           # condition Equals (operator/equal.go semantics)
    CIN_ITEM = 6      # In-family: key exact-equals one static item
    CIN_GLOB = 7      # In-family: single-string value is a pattern over key
    CGT = 8           # numeric.go family
    CGE = 9
    CLT = 10
    CLE = 11
    DGT = 12          # duration.go family (deprecated Duration* operators)
    DGE = 13
    DLT = 14
    DLE = 15


@dataclass
class AuxIR:
    klass: int                  # AUX_MATCH/AUX_EXCLUDE/AUX_PRECOND/AUX_DENY
    op: AuxOp
    path: str = ""              # SEP path ("" for constant rows); may start
                                # with REQ_MARK / NSEFF_MARK
    group: int = 0              # local group id (rows OR within a group)
    filt: int = 0               # filter index (match/exclude only)
    any_block: bool = False     # conditions: member of the any-list
    group_negate: bool = False  # NotEquals/NotIn...: negate the group OR
    kind_req: str = ""          # match rows: bare-kind gate ("" = any kind)
    pattern: str = ""           # glob / literal pattern operand
    literal: bool = False       # pattern matches byte-exact (no metachars)
    absent_res: bool = False    # row result when the leaf is absent
    err_on_absent: bool = False # deny rows: absent key -> rule ERROR
    allow_num_key: bool = True  # False for AllIn (numeric key -> False)
    key_is_pattern: bool = False  # In over a list value: the (dynamic) key
                                  # acts as the wildcard pattern -> a key
                                  # containing metachars goes to the oracle
    # condition operand encoding (CEQ / C* numeric rows)
    o_bool: bool = False
    o_is_bool: bool = False
    o_is_str: bool = False
    o_is_dur: bool = False      # operand parses as a Go duration (non-"0")
    o_is_dur_any: bool = False  # parses as a duration, "0" included
    o_is_float: bool = False    # operand string parses as a plain float
    o_is_int: bool = False      # operand string parses via strconv.Atoi
    o_is_num: bool = False      # operand is a numeric literal
    o_is_quant: bool = False    # operand parses as a k8s quantity
    o_qmicro: int = 0           # quantity/plain-number micro-units
    o_smicro: int = 0           # duration seconds (or numeric) micro-units


# Scaled integer representation for numbers/quantities: micro-units in i64.
NUM_SCALE = 1_000_000
NUM_MAX = (1 << 62) // 1


def quantity_to_micro(value) -> int:
    """Decompose a number or k8s quantity into i64 micro-units.

    Raises HostOnly when the value cannot be represented exactly enough
    (sub-micro precision or overflow) — those rules take the CPU lane.
    """
    if isinstance(value, bool):
        raise HostOnly("bool is not numeric",
                       EscalationReason.UNPARSEABLE_QUANTITY)
    if isinstance(value, (int, float)):
        frac = Fraction(value).limit_denominator(10**12)
    else:
        frac = parse_quantity(value)
    micro = frac * NUM_SCALE
    if micro.denominator != 1:
        raise HostOnly(f"sub-micro precision: {value!r}",
                       EscalationReason.UNPARSEABLE_QUANTITY)
    n = int(micro)
    if abs(n) > NUM_MAX:
        raise HostOnly(f"quantity overflow: {value!r}",
                       EscalationReason.UNPARSEABLE_QUANTITY)
    return n


@dataclass
class CheckIR:
    path: str                       # generalized path, "/"-joined, arrays as "*"
    op: CheckOp
    anchor: CheckAnchor = CheckAnchor.NONE
    # OR semantics: checks sharing (rule, alt, group) are OR'd; groups AND'd.
    alt: int = 0                    # anyPattern alternative index
    group: int = 0
    # element gating: index of the gate group this check belongs to (-1: none)
    gate: int = -1
    # operands
    pattern_str: str = ""           # for STR_* (glob)
    num_lo: int = 0                 # micro-units; for NUM_* (lo==hi for EQ)
    num_hi: int = 0
    bool_val: bool = False
    # a string-op check whose operand has a number part (pattern.go:312)
    # that parses as a quantity compares quantities on both sides
    # (validateNumberWithStr, pattern.go:264); non-quantity values fail
    num_fallback: bool = False
    # NUM_EQ literal semantics (pattern.go:67/95): 0 = quantity compare
    # (string-op rows), 1 = int literal (strings need ParseInt),
    # 2 = float literal (strings need ParseFloat)
    num_mode: int = 0
    # OR-over-elements (existence anchor) instead of AND-over-elements
    existence: bool = False
    # equality-anchor guard bitmask: bit d set => if segment-prefix of depth
    # d is the FIRST absent prefix on a slot's chain, the check passes
    # (equality anchors at any nesting level; 0 = no guards)
    guard_mask: int = 0
    # for CONDITION/GLOBAL rows: segment depth of the anchored key (the
    # predicate only applies — and can only skip — when that key exists)
    cond_depth: int = -1


@dataclass
class RuleIR:
    policy_name: str
    rule_name: str
    rule_index: int                  # global index into the verdict matrix
    kinds: list[str] = field(default_factory=list)
    namespaces: list[str] = field(default_factory=list)  # glob patterns
    checks: list[CheckIR] = field(default_factory=list)
    n_alts: int = 1
    n_gates: int = 0
    host_only: bool = False
    host_reason: str = ""            # human-readable detail
    host_reason_code: str = ""       # EscalationReason value ("" = device)
    # gate group -> array-prefix path (for element alignment validation)
    gate_prefix: dict[int, str] = field(default_factory=dict)
    # aux program (match/exclude filters + precondition/deny conditions)
    aux_rows: list[AuxIR] = field(default_factory=list)
    n_aux_groups: int = 0
    n_match_filters: int = 0
    n_exclude_filters: int = 0
    match_any: bool = False          # match.any -> OR over filters (else AND)
    exclude_all: bool = False        # exclude.all -> AND over filters (else OR)
    has_precond: bool = False
    precond_has_any: bool = False    # preconditions carry an any-block
    is_deny: bool = False
    deny_has_any: bool = False
    # KT4xx certification status stamped by analysis/certify.py via the
    # IncrementalCompiler refresh hook ("" = never certified; else
    # "certified" | "incomplete" | "host" | "divergent")
    certified: str = ""


_HAS_VAR = re.compile("|".join([REGEX_VARIABLES.pattern, REGEX_REFERENCES.pattern]))


def _contains_variable(node) -> bool:
    if isinstance(node, str):
        return bool(_HAS_VAR.search(node))
    if isinstance(node, dict):
        return any(_contains_variable(k) or _contains_variable(v) for k, v in node.items())
    if isinstance(node, list):
        return any(_contains_variable(v) for v in node)
    return False


class _PatternCompiler:
    """One validate pattern (or anyPattern alternative) -> checks."""

    def __init__(self, rule: RuleIR, alt: int):
        self.rule = rule
        self.alt = alt
        self.group_counter = 0

    def next_group(self) -> int:
        g = self.group_counter
        self.group_counter += 1
        return g

    def compile(self, pattern) -> None:
        if not isinstance(pattern, dict):
            raise HostOnly("top-level pattern must be a map",
                           EscalationReason.PATTERN_SHAPE)
        self._walk_map(pattern, "", gate=-1, array_depth=0, guard=0)

    # ---------------------------------------------------------------- walk

    @staticmethod
    def _segments(path: str) -> int:
        return len(path.split(SEP)) if path else 0

    def _walk_map(self, pattern: dict, path: str, gate: int, array_depth: int,
                  guard: int) -> None:
        # a skip-capable anchor (condition/global) SHARING a map level
        # with any other anchor is order-dependent in the reference:
        # validateMap runs anchor handlers in key order and the FIRST to
        # error decides skip-vs-fail for the rule (validate.go:102-137)
        # — a lattice without ordering cannot express that; the oracle
        # decides (deep-fuzz finding). Anchors that only fail-or-pass
        # (=, X, ^) commute and stay on device.
        kinds_here = [anchor_kind(k) for k in pattern
                      if anchor_kind(k) is not Anchor.NONE]
        if (len(kinds_here) > 1
                and any(k in (Anchor.CONDITION, Anchor.GLOBAL)
                        for k in kinds_here)):
            raise HostOnly("skip-capable anchor sharing a map level",
                           EscalationReason.ANCHOR_ORDERING)
        for key, value in pattern.items():
            kind = anchor_kind(key)
            bare, _ = remove_anchor(key)
            if "*" in bare or "?" in bare:
                # wildcard map keys expand against the resource at match time
                # (wildcards.ExpandInMetadata) - host lane
                raise HostOnly("wildcard map key",
                               EscalationReason.METACHAR_KEY)
            child_path = f"{path}{SEP}{bare}" if path else bare

            if kind in (Anchor.CONDITION, Anchor.GLOBAL):
                if array_depth > 0:
                    # handled by _walk_list via element gates
                    raise HostOnly(
                        "conditional anchor below an array outside a gated element",
                        EscalationReason.ANCHOR_ORDERING)
                anchor = (
                    CheckAnchor.CONDITION if kind is Anchor.CONDITION else CheckAnchor.GLOBAL
                )
                self._compile_subtree(value, child_path, anchor, gate, array_depth,
                                      guard, cond_depth=self._segments(child_path))
            elif kind is Anchor.EQUALITY:
                # =(key): absence of key (at this depth) passes; accumulate
                # into the guard mask for every check underneath
                self._compile_subtree(
                    value, child_path, CheckAnchor.EQUALITY, gate, array_depth,
                    guard=guard | (1 << self._segments(child_path)),
                )
            elif kind is Anchor.NEGATION:
                self._emit(CheckIR(path=child_path, op=CheckOp.ABSENT, gate=gate,
                                   guard_mask=guard))
            elif kind is Anchor.EXISTENCE:
                if array_depth > 0:
                    raise HostOnly("existence anchor inside an array",
                                   EscalationReason.PATTERN_SHAPE)
                self._walk_existence(value, child_path, guard)
            elif kind is Anchor.ADD_IF_NOT_PRESENT:
                raise HostOnly("+() anchor is mutate-only",
                               EscalationReason.UNSUPPORTED_CONSTRUCT)
            elif value == "*":
                # DefaultHandler's special case (anchor/anchor.go:118):
                # a plain map key with pattern "*" means "present and
                # non-null" for ANY value type — maps and lists included,
                # which the elementary string compare would reject
                self._emit(CheckIR(path=child_path, op=CheckOp.EXISTS_NONNIL,
                                   gate=gate, guard_mask=guard))
            else:
                self._compile_subtree(value, child_path, CheckAnchor.NONE, gate,
                                      array_depth, guard)

    def _compile_subtree(self, value, path: str, anchor: CheckAnchor, gate: int,
                         array_depth: int, guard: int, cond_depth: int = -1) -> None:
        if isinstance(value, dict):
            if not value:
                self._emit(CheckIR(path=path, op=CheckOp.EXISTS_OBJECT,
                                   anchor=anchor, gate=gate, guard_mask=guard,
                                   cond_depth=cond_depth))
                return
            if anchor in (CheckAnchor.CONDITION, CheckAnchor.GLOBAL):
                # condition predicate subtree: leaves inherit the anchor
                for k, v in value.items():
                    if anchor_kind(k) is not Anchor.NONE:
                        raise HostOnly("nested anchor inside condition subtree",
                                       EscalationReason.ANCHOR_ORDERING)
                    self._compile_subtree(v, f"{path}{SEP}{k}", anchor, gate,
                                          array_depth, guard, cond_depth)
                return
            self._walk_map(value, path, gate, array_depth, guard)
        elif isinstance(value, list):
            if anchor in (CheckAnchor.CONDITION, CheckAnchor.GLOBAL):
                raise HostOnly("array inside condition predicate",
                               EscalationReason.PATTERN_SHAPE)
            self._walk_list(value, path, anchor, array_depth, guard)
        else:
            if anchor is CheckAnchor.EQUALITY:
                guard |= 1 << self._segments(path)  # scalar =(k): v self-guards
            self._emit_leaf(value, path, anchor, gate, guard=guard,
                            cond_depth=cond_depth)

    def _walk_list(self, pattern: list, path: str, anchor: CheckAnchor,
                   array_depth: int, guard: int) -> None:
        """validate.go:140 validateArray: a single pattern element applies to
        every resource element."""
        if len(pattern) != 1:
            raise HostOnly("multi-element pattern arrays",
                           EscalationReason.PATTERN_SHAPE)
        element = pattern[0]
        elem_path = f"{path}{SEP}*"
        if isinstance(element, dict):
            gates = [k for k in element if anchor_kind(k) in (Anchor.CONDITION, Anchor.GLOBAL)]
            if gates:
                if array_depth > 0:
                    raise HostOnly("element gates in nested arrays",
                                   EscalationReason.PATTERN_SHAPE)
                if any(anchor_kind(k) is Anchor.GLOBAL for k in gates):
                    # <() in an array element is NOT an element filter: a
                    # predicate mismatch on any element skips the whole
                    # RULE (GlobalConditionError propagates out of
                    # validateArrayOfMaps), an order-dependent semantic
                    # the gate lattice cannot express — oracle decides
                    raise HostOnly("global anchor in array element",
                                   EscalationReason.ANCHOR_ORDERING)
                rest = {k: v for k, v in element.items() if k not in gates}
                if not rest:
                    # pure-filter element ({(cond): pat} and nothing
                    # else): every element either condition-skips or
                    # trivially matches, so the constraints left are the
                    # LIST's own presence/type (deep-fuzz find: the gate
                    # alone let an ABSENT list pass) and that every
                    # element IS a map — a scalar element is a type
                    # mismatch the reference fails before the anchor
                    # handler runs (validateResourceElement dispatch)
                    self._emit(CheckIR(path=path, op=CheckOp.EXISTS_LIST,
                                       gate=-1, guard_mask=guard))
                    self._emit(CheckIR(path=elem_path,
                                       op=CheckOp.EXISTS_OBJECT,
                                       gate=-1, guard_mask=guard))
                    return
                gate_id = self.rule.n_gates
                self.rule.n_gates += 1
                self.rule.gate_prefix[gate_id] = elem_path
                for key in gates:
                    bare, _ = remove_anchor(key)
                    self._compile_gate_predicate(element[key], f"{elem_path}{SEP}{bare}", gate_id)
                self._walk_map(rest, elem_path, gate_id, array_depth + 1, guard)
            else:
                self._compile_subtree(element, elem_path, anchor, -1,
                                      array_depth + 1, guard)
        elif isinstance(element, list):
            raise HostOnly("array of arrays pattern",
                           EscalationReason.PATTERN_SHAPE)
        else:
            self._emit_leaf(element, elem_path, anchor, -1, guard=guard)

    def _compile_gate_predicate(self, value, path: str, gate_id: int) -> None:
        """The anchored key's pattern becomes the gate predicate rows."""
        if isinstance(value, (dict, list)):
            raise HostOnly("non-scalar element gate predicate",
                           EscalationReason.PATTERN_SHAPE)
        self._emit_leaf(value, path, CheckAnchor.ELEMENT_GATE, gate_id)

    def _walk_existence(self, value, path: str, guard: int = 0) -> None:
        """^(key): [pattern] -> at least one element matches. Compiled as an
        OR-over-elements group; only a single scalar-leaf predicate or a
        flat map of scalars is supported on device. ``guard`` carries
        equality-anchor bits from ancestors: an absent =() key makes the
        existence check vacuous too."""
        if not isinstance(value, list) or len(value) != 1:
            raise HostOnly("existence anchor expects a single-element list",
                           EscalationReason.PATTERN_SHAPE)
        element = value[0]
        elem_path = f"{path}{SEP}*"
        group = self.next_group()
        if isinstance(element, dict):
            if len(element) != 1:
                raise HostOnly("existence anchor over multi-key element",
                               EscalationReason.PATTERN_SHAPE)
            for k, v in element.items():
                if anchor_kind(k) is not Anchor.NONE or isinstance(v, (dict, list)):
                    raise HostOnly("nested existence anchor",
                                   EscalationReason.PATTERN_SHAPE)
                self._emit_leaf(
                    v, f"{elem_path}{SEP}{k}", CheckAnchor.NONE, -1,
                    existence_group=group, guard=guard,
                )
        else:
            self._emit_leaf(element, elem_path, CheckAnchor.NONE, -1,
                            existence_group=group, guard=guard)

    # ---------------------------------------------------------------- leaves

    def _emit(self, check: CheckIR) -> None:
        check.alt = self.alt
        check.group = self.next_group()
        self.rule.checks.append(check)

    def _emit_leaf(self, value, path: str, anchor: CheckAnchor, gate: int,
                   existence_group: int | None = None, guard: int = 0,
                   cond_depth: int = -1) -> None:
        """One scalar pattern leaf -> one or more check rows (compound
        ``a|b`` patterns OR into the same group; pattern.go:153)."""
        if (existence_group is not None and isinstance(value, str)
                and ("&" in value or "|" in value)):
            # the at-least-one-element OR and the compound split cannot
            # share the two-level group lattice
            raise HostOnly("compound pattern under existence anchor",
                           EscalationReason.PATTERN_SHAPE)
        group = existence_group if existence_group is not None else self.next_group()
        existence = existence_group is not None

        if isinstance(value, bool):
            self._append(CheckIR(path=path, op=CheckOp.BOOL_EQ, anchor=anchor,
                                 gate=gate, group=group, bool_val=value,
                                 guard_mask=guard, cond_depth=cond_depth),
                         existence)
            return
        if value is None:
            self._append(CheckIR(path=path, op=CheckOp.IS_NULL, anchor=anchor,
                                 gate=gate, group=group, guard_mask=guard,
                                 cond_depth=cond_depth), existence)
            return
        if isinstance(value, (int, float)):
            n = quantity_to_micro(value)
            self._append(CheckIR(path=path, op=CheckOp.NUM_EQ, anchor=anchor,
                                 gate=gate, group=group, num_lo=n, num_hi=n,
                                 guard_mask=guard, cond_depth=cond_depth,
                                 num_mode=1 if isinstance(value, int) else 2),
                         existence)
            return
        if not isinstance(value, str):
            raise HostOnly(f"unsupported leaf pattern type {type(value).__name__}",
                           EscalationReason.PATTERN_SHAPE)

        if "&" in value and "|" in value:
            # mixed compound: (a AND b) OR c — an OR of ANDs the two-level
            # group lattice (rows OR in group, groups AND) cannot express
            raise HostOnly("mixed &/| compound pattern",
                           EscalationReason.PATTERN_SHAPE)
        if "&" in value:
            # AND-compound: each part its own group (pattern.go:165)
            for part in value.split("&"):
                self._emit_leaf(part.strip(), path, anchor, gate, guard=guard,
                                cond_depth=cond_depth)
            return

        alternatives = [p.strip() for p in value.split("|")] if "|" in value else [value]
        for alternative in alternatives:
            check = self._compile_scalar(alternative, path, anchor, gate, group, guard)
            check.cond_depth = cond_depth
            self._append(check, existence)

    def _append(self, check: CheckIR, existence: bool) -> None:
        check.alt = self.alt
        check.existence = existence
        self.rule.checks.append(check)

    def _compile_scalar(self, pattern: str, path: str, anchor: CheckAnchor,
                        gate: int, group: int, guard: int) -> CheckIR:
        op = get_operator(pattern)
        operand = pattern[len(op.value):] if op.value and op is not Op.IN_RANGE and op is not Op.NOT_IN_RANGE else pattern

        if op in (Op.MORE, Op.MORE_EQUAL, Op.LESS, Op.LESS_EQUAL):
            operand = operand.strip()
            if not _number_part(operand):
                # no number part: validateString with a non-equality
                # operator is constant false (pattern.go:173) — host keeps
                # the anchor skip/fail lattice exact for this odd case
                raise HostOnly(f"comparison operand without number part: "
                               f"{pattern!r}",
                               EscalationReason.UNSUPPORTED_OPERATOR)
            try:
                n = quantity_to_micro(operand)
            except QuantityError:
                # validateNumberWithStr with a non-quantity operand falls
                # back to a wildcard over convertNumberToString(value) —
                # fixed-point "%f" floats, nil -> "0" — a stringification
                # the device dictionary does not carry (pattern.go:283-288)
                raise HostOnly(
                    f"number-part operand without quantity form: {operand!r}",
                    EscalationReason.UNPARSEABLE_QUANTITY)
            num_op = {
                Op.MORE: CheckOp.NUM_GT,
                Op.MORE_EQUAL: CheckOp.NUM_GE,
                Op.LESS: CheckOp.NUM_LT,
                Op.LESS_EQUAL: CheckOp.NUM_LE,
            }[op]
            return CheckIR(path=path, op=num_op, anchor=anchor, gate=gate,
                           group=group, num_lo=n, num_hi=n, guard_mask=guard)
        if op in (Op.IN_RANGE, Op.NOT_IN_RANGE):
            lo, hi = _split_range(pattern, op)
            num_op = CheckOp.NUM_IN_RANGE if op is Op.IN_RANGE else CheckOp.NUM_NOT_IN_RANGE
            return CheckIR(path=path, op=num_op, anchor=anchor, gate=gate,
                           group=group, num_lo=lo, num_hi=hi, guard_mask=guard)
        if op is Op.NOT_EQUAL:
            return self._string_check(operand, path, anchor, gate, group, guard, negate=True)
        return self._string_check(operand, path, anchor, gate, group, guard, negate=False)

    def _string_check(self, operand: str, path: str, anchor: CheckAnchor,
                      gate: int, group: int, guard: int, negate: bool) -> CheckIR:
        operand = operand.strip()  # pattern.go:211 TrimSpace after operator
        # pattern.go:212: only an operand with a leading number part takes
        # the validateNumberWithStr path; "-5" or "abc" are pure strings
        if _number_part(operand):
            try:
                n = quantity_to_micro(operand)
            except QuantityError:
                # wildcard fallback over convertNumberToString(value)
                # (pattern.go:283, operator ignored) -> host lane, like the
                # comparison-op branch above
                raise HostOnly(
                    f"number-part operand without quantity form: {operand!r}",
                    EscalationReason.UNPARSEABLE_QUANTITY)
            check = CheckIR(
                path=path,
                op=CheckOp.STR_NE if negate else CheckOp.STR_EQ,
                anchor=anchor, gate=gate, group=group, pattern_str=operand,
                guard_mask=guard, num_fallback=True, num_lo=n, num_hi=n,
            )
            return check
        return CheckIR(
            path=path,
            op=CheckOp.STR_NE if negate else CheckOp.STR_EQ,
            anchor=anchor, gate=gate, group=group, pattern_str=operand,
            guard_mask=guard,
        )




# ------------------------------------------------------------ aux compilers


def _title_first(s: str) -> str:
    return s[:1].upper() + s[1:] if s else s


def _matches_empty(pattern: str) -> bool:
    from ..utils.wildcard import wildcard_match

    return wildcard_match(pattern, "")


class _AuxBuilder:
    """Emits AuxIR rows for one rule, allocating group/filter ids."""

    def __init__(self, ir: RuleIR):
        self.ir = ir

    def new_group(self) -> int:
        g = self.ir.n_aux_groups
        self.ir.n_aux_groups += 1
        return g

    def row(self, klass: int, op: AuxOp, group: int, **kw) -> AuxIR:
        r = AuxIR(klass=klass, op=op, group=group, **kw)
        self.ir.aux_rows.append(r)
        return r


# --------------------------------------------------------- match compilation


def compile_match_program(rule, policy_namespace: str, ir: RuleIR) -> None:
    """Match/exclude -> aux rows (utils.go:265 MatchesResourceDescription).

    Raises HostOnly for constructs needing admission context (userinfo,
    namespaceSelector) or dynamic key expansion (wildcard annotation/label
    keys)."""
    b = _AuxBuilder(ir)
    match = rule.match
    if match.any:
        ir.match_any = True
        filters = list(match.any)
    elif match.all:
        filters = list(match.all)
    else:
        from ..api.types import ResourceFilter

        filters = [ResourceFilter(user_info=match.user_info,
                                  resources=match.resources)]
    ir.n_match_filters = len(filters)
    for fi, rf in enumerate(filters):
        _compile_filter(b, rf, AUX_MATCH, fi, policy_namespace)

    exclude = rule.exclude
    if exclude.any:
        ex_filters = list(exclude.any)
    elif exclude.all:
        ir.exclude_all = True
        ex_filters = list(exclude.all)
    else:
        from ..api.types import ResourceFilter

        rf = ResourceFilter(user_info=exclude.user_info,
                            resources=exclude.resources)
        ex_filters = [] if rf.is_empty() else [rf]
    ir.n_exclude_filters = len(ex_filters)
    for fi, rf in enumerate(ex_filters):
        _compile_filter(b, rf, AUX_EXCLUDE, fi, policy_namespace)


def _compile_filter(b: _AuxBuilder, rf, klass: int, fi: int,
                    policy_namespace: str) -> None:
    """One ResourceFilter -> AND of groups (doesResourceMatchConditionBlock).

    An exclude filter with only an empty block never excludes
    (_exclude_helper); an empty match filter never matches."""
    if not rf.user_info.is_empty():
        # roles/clusterRoles/subjects need live admission context; in a
        # batched scan the oracle result also differs from admission — the
        # whole rule takes the host lane (utils.go:196-234)
        raise HostOnly("userinfo in match/exclude",
                       EscalationReason.ADMISSION_CONTEXT)
    desc = rf.resources
    if desc.namespace_selector is not None:
        raise HostOnly("namespaceSelector needs namespace labels",
                       EscalationReason.ADMISSION_CONTEXT)
    if desc.is_empty():
        if klass == AUX_MATCH:
            # "match cannot be empty" -> filter never matches
            b.row(klass, AuxOp.FALSE, b.new_group(), filt=fi)
        return

    if desc.kinds:
        g = b.new_group()
        for entry in desc.kinds:
            parts = entry.split("/")
            if entry == "*":
                b.row(klass, AuxOp.TRUE, g, filt=fi)
            elif len(parts) == 1:
                b.row(klass, AuxOp.TRUE, g, filt=fi,
                      kind_req=_title_first(entry))
            elif len(parts) == 2:
                # version/Kind: resource version must equal parts[0]
                # (checkKind matches version regardless of group)
                kind = _title_first(parts[1])
                b.row(klass, AuxOp.GLOB, g, filt=fi, kind_req=kind,
                      path="apiVersion", pattern=parts[0])
                b.row(klass, AuxOp.GLOB, g, filt=fi, kind_req=kind,
                      path="apiVersion", pattern=f"*/{parts[0]}")
            elif len(parts) == 3:
                kind = _title_first(parts[2])
                version = "*" if parts[1] == "*" else parts[1]
                b.row(klass, AuxOp.GLOB, g, filt=fi, kind_req=kind,
                      path="apiVersion", pattern=f"{parts[0]}/{version}")
            else:
                raise HostOnly(f"unparseable kind {entry!r}",
                               EscalationReason.UNSUPPORTED_CONSTRUCT)

    name_patterns = ([desc.name] if desc.name else []) + list(desc.names or [])
    if desc.name and desc.names:
        # both present: reference ANDs the two checks
        g = b.new_group()
        b.row(klass, AuxOp.GLOB, g, filt=fi, path=f"metadata{SEP}name",
              pattern=desc.name, absent_res=_matches_empty(desc.name))
        name_patterns = list(desc.names)
    if name_patterns:
        g = b.new_group()
        for p in name_patterns:
            b.row(klass, AuxOp.GLOB, g, filt=fi, path=f"metadata{SEP}name",
                  pattern=p, absent_res=_matches_empty(p))

    if desc.namespaces:
        g = b.new_group()
        for p in desc.namespaces:
            b.row(klass, AuxOp.GLOB, g, filt=fi, path=NSEFF_MARK,
                  pattern=p, absent_res=_matches_empty(p))

    for k, v in (desc.annotations or {}).items():
        if "*" in k or "?" in k:
            raise HostOnly("wildcard annotation key in match",
                           EscalationReason.METACHAR_KEY)
        g = b.new_group()
        b.row(klass, AuxOp.GLOB, g, filt=fi,
              path=f"metadata{SEP}annotations{SEP}{k}", pattern=str(v))

    if desc.selector is not None:
        _compile_selector(b, desc.selector, klass, fi)

    if policy_namespace:
        # namespaced Policy objects only apply inside their own namespace
        g = b.new_group()
        b.row(klass, AuxOp.GLOB, g, filt=fi,
              path=f"metadata{SEP}namespace", pattern=policy_namespace,
              literal=True)


def _compile_selector(b: _AuxBuilder, selector: dict, klass: int, fi: int) -> None:
    """LabelSelector -> groups over metadata.labels paths. Kyverno expands
    wildcards in matchLabels values (wildcards.ReplaceInSelector), which a
    glob row reproduces; wildcard *keys* need dynamic expansion -> host."""
    for k, v in (selector.get("matchLabels") or {}).items():
        if "*" in k or "?" in k:
            raise HostOnly("wildcard label key in selector",
                           EscalationReason.METACHAR_KEY)
        g = b.new_group()
        b.row(klass, AuxOp.GLOB, g, filt=fi,
              path=f"metadata{SEP}labels{SEP}{k}", pattern=str(v))
    for expr in selector.get("matchExpressions") or []:
        k = expr.get("key", "")
        if "*" in k or "?" in k:
            raise HostOnly("wildcard label key in matchExpressions",
                           EscalationReason.METACHAR_KEY)
        op = (expr.get("operator") or "").lower()
        values = [str(x) for x in (expr.get("values") or [])]
        path = f"metadata{SEP}labels{SEP}{k}"
        g = b.new_group()
        if op == "in":
            for v in values:
                b.row(klass, AuxOp.GLOB, g, filt=fi, path=path, pattern=v,
                      literal=True)
        elif op == "notin":
            # absent key satisfies NotIn (k8s labels.Requirement.Matches)
            for v in values:
                b.row(klass, AuxOp.GLOB, g, filt=fi, path=path, pattern=v,
                      literal=True, group_negate=True)
            if not values:
                b.row(klass, AuxOp.FALSE, g, filt=fi, group_negate=True)
        elif op == "exists":
            b.row(klass, AuxOp.EXISTS, g, filt=fi, path=path)
        elif op == "doesnotexist":
            b.row(klass, AuxOp.NOT_EXISTS, g, filt=fi, path=path,
                  absent_res=True)
        else:
            raise HostOnly(f"selector operator {op!r}",
                           EscalationReason.UNSUPPORTED_OPERATOR)


# ----------------------------------------------------- condition compilation


_VAR_PATH_SEG = re.compile(r'^(?:"([^"]*)"|([A-Za-z0-9_\-./]+))$')


def _parse_condition_key(key) -> list[str] | None:
    """A key that is exactly one ``{{request...}}`` variable with plain
    dotted segments -> path segments (resource-rooted for request.object.*,
    REQ_MARK-rooted otherwise). None => not device-compilable."""
    if not isinstance(key, str):
        return None
    m = re.fullmatch(r"\{\{(.+)\}\}", key.strip())
    if m is None:
        return None
    inner = m.group(1).strip()
    # split on dots, honoring double-quoted segments
    segs: list[str] = []
    buf = ""
    in_quote = False
    for ch in inner:
        if ch == '"':
            in_quote = not in_quote
            buf += ch
        elif ch == "." and not in_quote:
            segs.append(buf)
            buf = ""
        else:
            buf += ch
    segs.append(buf)
    out: list[str] = []
    for s in segs:
        sm = _VAR_PATH_SEG.match(s)
        if sm is None or s == "":
            return None
        seg = sm.group(1) if sm.group(1) is not None else sm.group(2)
        if seg is None or seg == "" or "." in (sm.group(2) or ""):
            # bare segments may not contain dots (they were split) — but a
            # segment like "metadata-name" is fine; dots only via quotes
            pass
        out.append(seg)
    if not out or out[0] != "request":
        return None
    if len(out) >= 2 and out[1] == "object":
        rest = out[2:]
        if not rest:
            return None  # whole-object key: host
        return rest
    rest = out[1:]
    if not rest:
        return None
    return [REQ_MARK] + rest


def compile_conditions(raw, klass: int, ir: RuleIR) -> None:
    """Precondition / deny condition lists -> aux rows
    (variables/evaluate.go:21 EvaluateConditions)."""
    b = _AuxBuilder(ir)
    if isinstance(raw, dict):
        if not set(raw) <= {"any", "all"}:
            raise HostOnly("invalid conditions block",
                           EscalationReason.PATTERN_SHAPE)
        any_conds = raw.get("any") or []
        all_conds = raw.get("all") or []
        # a PRESENT-but-empty any-list still fails the block: evaluate.go
        # checks `anyConditions != nil` and any([]) is false
        has_any = raw.get("any") is not None
    elif isinstance(raw, list):
        any_conds, all_conds, has_any = [], raw, False
    else:
        raise HostOnly("invalid conditions", EscalationReason.PATTERN_SHAPE)
    if klass == AUX_PRECOND:
        ir.has_precond = True
        ir.precond_has_any = has_any
    else:
        ir.deny_has_any = has_any
    for cond in any_conds:
        _compile_condition(b, cond, klass, any_block=True)
    for cond in all_conds:
        _compile_condition(b, cond, klass, any_block=False)


def _static_quant_micro(s):
    try:
        return quantity_to_micro(s)
    except (HostOnly, QuantityError):
        return None


def _operand_flags(value) -> dict:
    """Static operand -> the flag set the device branches on."""
    from ..utils.duration import DurationError, parse_duration

    kw: dict = {}
    if isinstance(value, bool):
        kw["o_is_bool"] = True
        kw["o_bool"] = value
    elif isinstance(value, (int, float)):
        kw["o_is_num"] = True
        m = _static_quant_micro(value)
        if m is None:
            raise HostOnly(f"operand precision: {value!r}",
                           EscalationReason.UNPARSEABLE_QUANTITY)
        kw["o_qmicro"] = m
        kw["o_smicro"] = m  # numeric operand doubles as seconds
        kw["o_is_quant"] = True
    elif isinstance(value, str):
        kw["o_is_str"] = True
        try:
            secs = parse_duration(value)
            kw["o_is_dur_any"] = True
            kw["o_is_dur"] = value != "0"  # operator.go:82 excludes "0"
            kw["o_smicro"] = round(secs * 1_000_000)
        except DurationError:
            pass
        try:
            float(value)
            kw["o_is_float"] = True
            if not kw.get("o_is_dur_any"):
                m = _static_quant_micro(value)
                if m is None:
                    raise HostOnly(f"operand precision: {value!r}",
                                   EscalationReason.UNPARSEABLE_QUANTITY)
                kw["o_smicro"] = m
        except ValueError:
            pass
        try:
            int(value, 10)
            kw["o_is_int"] = True
        except ValueError:
            pass
        m = _static_quant_micro(value)
        if m is not None:
            kw["o_qmicro"] = m
            kw["o_is_quant"] = True
    else:
        raise HostOnly("non-scalar condition operand",
                       EscalationReason.PATTERN_SHAPE)
    return kw


def _compile_condition(b: _AuxBuilder, cond: dict, klass: int,
                       any_block: bool) -> None:
    from ..engine.operators import evaluate_condition

    key = cond.get("key")
    op = (cond.get("operator") or "").lower()
    value = cond.get("value")

    def has_var(x) -> bool:
        return _contains_variable(x)

    if has_var(value):
        raise HostOnly("variables in condition value",
                       EscalationReason.VARIABLE_REFERENCE)

    err_absent = klass == AUX_DENY  # deny substitution errors on unresolved

    if not has_var(key):
        # fully static condition: fold to a constant
        result = evaluate_condition(key, cond.get("operator", ""), value)
        b.row(klass, AuxOp.TRUE if result else AuxOp.FALSE, b.new_group(),
              any_block=any_block)
        return

    segs = _parse_condition_key(key)
    if segs is None:
        raise HostOnly(f"condition key not compilable: {key!r}",
                       EscalationReason.VARIABLE_REFERENCE)
    path = SEP.join(segs)
    if "*" in segs:
        raise HostOnly("wildcard in condition key path",
                       EscalationReason.METACHAR_KEY)
    g = b.new_group()
    common = dict(path=path, any_block=any_block, err_on_absent=err_absent,
                  filt=0)

    def absent_result(operator: str) -> bool:
        # unresolved precondition keys substitute to "" (vars.go:62-74)
        return evaluate_condition("", operator, value)

    if op in ("equals", "equal", "notequals", "notequal"):
        if isinstance(value, (dict, list)):
            # scalar paths never deep-equal a composite operand
            base = False
            negate = op.startswith("notequal")
            res = base != negate
            b.row(klass, AuxOp.TRUE if res else AuxOp.FALSE, g,
                  any_block=any_block, path=path if err_absent else "",
                  err_on_absent=err_absent)
            return
        kw = _operand_flags(value)
        negate = op in ("notequals", "notequal")
        b.row(klass, AuxOp.CEQ, g, group_negate=negate,
              absent_res=absent_result("equals"),
              pattern=value if isinstance(value, str) else "",
              **common, **kw)
    elif op in ("in", "anyin", "allin", "notin", "anynotin", "allnotin"):
        negate = op in ("notin", "anynotin", "allnotin")
        coerce = op in ("anyin", "allin", "anynotin", "allnotin")
        allow_num = op != "allin"
        raw_abs = absent_result("in" if not negate else "notin")
        # row-level absent results must be pre-negation
        # (item, is_glob_row, key_is_pattern)
        item_rows: list[tuple[str, bool, bool]] = []
        if isinstance(value, list):
            items = []
            for el in value:
                if isinstance(el, str):
                    items.append(el)
                elif coerce:
                    items.append(_go_sprint(el))
                else:
                    # In/NotIn with non-string items: invalid -> False
                    b.row(klass, AuxOp.FALSE, g, any_block=any_block,
                          path=path if err_absent else "",
                          err_on_absent=err_absent)
                    return
            # in.go:62 keyExistsInArray: the KEY is the wildcard pattern
            # over list items — exact on device, HOST for metachar keys
            item_rows = [(it, False, True) for it in items]
        elif isinstance(value, str):
            item_rows = [(value, True, False)]
            import json as _json

            try:
                arr = _json.loads(value)
            except ValueError:
                arr = None
            if isinstance(arr, list) and all(isinstance(x, str) for x in arr):
                item_rows += [(it, False, False) for it in arr]
            elif negate:
                # in.go:62 quirk: with a string value that is not a JSON
                # string-array, a wildcard miss returns invalid-type, and
                # every Not* handler maps invalid to FALSE — so the negated
                # condition is constant false whether the key matches or not
                b.row(klass, AuxOp.FALSE, g, any_block=any_block,
                      path=path if err_absent else "",
                      err_on_absent=err_absent)
                return
        else:
            # numeric/bool value: invalid type -> condition False
            b.row(klass, AuxOp.FALSE, g, any_block=any_block,
                  path=path if err_absent else "", err_on_absent=err_absent)
            return
        for item, is_glob, key_pat in item_rows:
            b.row(klass, AuxOp.CIN_GLOB if is_glob else AuxOp.CIN_ITEM, g,
                  group_negate=negate, pattern=item, literal=not is_glob,
                  absent_res=(wildcard_match_static(item, "") if is_glob
                              else item == ""),
                  allow_num_key=allow_num, key_is_pattern=key_pat, **common)
        if not item_rows:
            b.row(klass, AuxOp.FALSE, g, group_negate=negate,
                  any_block=any_block, path=path if err_absent else "",
                  err_on_absent=err_absent, absent_res=raw_abs)
    elif op in ("greaterthan", "greaterthanorequals", "lessthan",
                "lessthanorequals"):
        aux_op = {
            "greaterthan": AuxOp.CGT,
            "greaterthanorequals": AuxOp.CGE,
            "lessthan": AuxOp.CLT,
            "lessthanorequals": AuxOp.CLE,
        }[op]
        if isinstance(value, (dict, list)):
            b.row(klass, AuxOp.FALSE, g, any_block=any_block,
                  path=path if err_absent else "", err_on_absent=err_absent)
            return
        kw = _operand_flags(value)
        b.row(klass, aux_op, g, absent_res=absent_result(op),
              **common, **kw)
    elif op in ("durationgreaterthan", "durationgreaterthanorequals",
                "durationlessthan", "durationlessthanorequals"):
        aux_op = {
            "durationgreaterthan": AuxOp.DGT,
            "durationgreaterthanorequals": AuxOp.DGE,
            "durationlessthan": AuxOp.DLT,
            "durationlessthanorequals": AuxOp.DLE,
        }[op]
        if isinstance(value, (dict, list)) or isinstance(value, bool):
            b.row(klass, AuxOp.FALSE, g, any_block=any_block,
                  path=path if err_absent else "", err_on_absent=err_absent)
            return
        kw = _operand_flags(value)
        if not (kw.get("o_is_dur_any") or kw.get("o_is_num")):
            b.row(klass, AuxOp.FALSE, g, any_block=any_block,
                  path=path if err_absent else "", err_on_absent=err_absent)
            return
        b.row(klass, aux_op, g, absent_res=absent_result(op), **common, **kw)
    else:
        # unknown operator evaluates to false (evaluate.go default)
        b.row(klass, AuxOp.FALSE, g, any_block=any_block,
              path=path if err_absent else "", err_on_absent=err_absent)


def _go_sprint(v) -> str:
    """fmt.Sprint for condition items (operators._sprint twin)."""
    import math

    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "<nil>"
    if isinstance(v, float) and v == math.trunc(v) and abs(v) < 1e21:
        return str(int(v))
    return str(v)


def wildcard_match_static(pattern: str, s: str) -> bool:
    from ..utils.wildcard import wildcard_match

    return wildcard_match(pattern, s)


_RANGE_RE = re.compile(r"^(\d+(?:\.\d+)?[^-!]*?)(!?-)(\d+(?:\.\d+)?.*)$")

_NUMBER_PART_RE = re.compile(r"^(\d*(?:\.\d+)?)")


def _number_part(operand: str) -> str:
    """pattern.go:312 getNumberAndStringPartsFromPattern's number group."""
    m = _NUMBER_PART_RE.match(operand)
    return m.group(1) if m else ""


def _split_range(pattern: str, op: Op) -> tuple[int, int]:
    sep = "!-" if op is Op.NOT_IN_RANGE else "-"
    idx = pattern.find(sep)
    lo = pattern[:idx]
    hi = pattern[idx + len(sep):]
    return quantity_to_micro(lo.strip()), quantity_to_micro(hi.strip())


def compile_rule_ir(policy, rule, rule_index: int) -> RuleIR:
    """Compile one validate rule to IR, falling back to host_only.

    Device-lane coverage: pattern/anyPattern rules, deny rules with
    static-operand conditions, preconditions over request.object paths,
    any/all match filters, exclude blocks, name/namespace/annotation/
    selector matching. Context rules, foreach, userinfo matching, and
    {{variables}} outside condition keys stay on the CPU oracle."""
    ir = RuleIR(
        policy_name=policy.name,
        rule_name=rule.name,
        rule_index=rule_index,
        kinds=list(rule.match.resources.kinds)
        or [k for rf in rule.match.any or rule.match.all or [] for k in rf.resources.kinds],
        namespaces=list(rule.match.resources.namespaces),
    )

    def host(reason: str, code: EscalationReason) -> RuleIR:
        ir.host_only = True
        ir.host_reason = reason
        ir.host_reason_code = code.value
        ir.checks = []
        ir.aux_rows = []
        return ir

    v = rule.validation
    if v.foreach:
        return host("foreach rules", EscalationReason.FOREACH)
    if rule.context:
        return host("external context", EscalationReason.EXTERNAL_CONTEXT)

    try:
        compile_match_program(rule, getattr(policy, "namespace", ""), ir)
        if rule.preconditions is not None:
            compile_conditions(rule.preconditions, AUX_PRECOND, ir)

        if v.deny is not None:
            ir.is_deny = True
            conditions = (v.deny or {}).get("conditions")
            if conditions is None:
                return host("deny without conditions",
                            EscalationReason.UNSUPPORTED_CONSTRUCT)
            compile_conditions(conditions, AUX_DENY, ir)
            ir.n_alts = 0
            return ir

        patterns = []
        if v.pattern is not None:
            if _contains_variable(v.pattern):
                return host("variables in pattern",
                            EscalationReason.VARIABLE_REFERENCE)
            patterns = [v.pattern]
        elif v.any_pattern is not None:
            if not isinstance(v.any_pattern, list):
                return host("malformed anyPattern",
                            EscalationReason.PATTERN_SHAPE)
            if _contains_variable(v.any_pattern):
                return host("variables in anyPattern",
                            EscalationReason.VARIABLE_REFERENCE)
            patterns = v.any_pattern
        else:
            return host("no pattern", EscalationReason.UNSUPPORTED_CONSTRUCT)

        ir.n_alts = len(patterns)
        for alt, pattern in enumerate(patterns):
            _PatternCompiler(ir, alt).compile(pattern)
    except HostOnly as e:
        return host(e.detail or str(e), e.reason)
    except QuantityError as e:
        return host(str(e), EscalationReason.UNPARSEABLE_QUANTITY)
    return ir
