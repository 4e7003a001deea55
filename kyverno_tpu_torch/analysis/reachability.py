"""Reachability / conflict pass (KT2xx).

Works on the compiled ``RuleIR`` aux program, mirroring the device
evaluation semantics (rows OR within a group, XOR ``group_negate``,
groups AND within a filter, filters OR/AND per ``match_any`` /
``exclude_all``, conditions split into an any-block OR and an all AND).

The fold is three-valued: a row contributes {True}, {False}, or
{True, False} ("depends on the resource"). Only ``AuxOp.TRUE`` /
``AuxOp.FALSE`` rows are constant — exactly the rows the compiler emits
for empty match blocks, folded static conditions, and the invalid-type
condition quirks — so every verdict here is sound: KT201 fires only
when *no* resource can reach the rule, never on a may-analysis guess.

anyPattern shadowing (KT202) uses subsumption over the check lattice:
alternative ``i`` shadows a later alternative ``j`` when every check
group of ``alt_i`` contains some group of ``alt_j`` — then ``alt_j``
passing forces ``alt_i`` to pass first, and ``alt_j`` can never change
the rule outcome.
"""

from __future__ import annotations

from dataclasses import asdict

from ..models.ir import AUX_DENY, AUX_EXCLUDE, AUX_MATCH, AUX_PRECOND, AuxOp, RuleIR
from .diagnostics import Diagnostic, make

# three-valued lattice as frozensets of bool
_T = frozenset([True])
_F = frozenset([False])
_TF = frozenset([True, False])


def _row_value(row) -> frozenset:
    if row.op is AuxOp.TRUE:
        # a kind-gated TRUE row is only true for resources of that kind
        return _T if not row.kind_req else _TF
    if row.op is AuxOp.FALSE:
        return _F
    return _TF


def _negate(v: frozenset) -> frozenset:
    return frozenset(not x for x in v)


def _or(values) -> frozenset:
    out = _F  # identity: empty OR is false
    for v in values:
        out = frozenset(a or b for a in out for b in v)
    return out


def _and(values) -> frozenset:
    out = _T
    for v in values:
        out = frozenset(a and b for a in out for b in v)
    return out


def _group_values(rows) -> dict[int, frozenset]:
    """group id -> folded value (OR of rows, negated if any row asks)."""
    by_group: dict[int, list] = {}
    for r in rows:
        by_group.setdefault(r.group, []).append(r)
    out = {}
    for g, grows in by_group.items():
        v = _or(_row_value(r) for r in grows)
        if any(r.group_negate for r in grows):
            v = _negate(v)
        out[g] = v
    return out


def _filter_values(rows) -> dict[int, frozenset]:
    """filter id -> AND over its groups."""
    by_filt: dict[int, list] = {}
    for r in rows:
        by_filt.setdefault(r.filt, []).append(r)
    return {fi: _and(_group_values(frows).values())
            for fi, frows in by_filt.items()}


def fold_match(ir: RuleIR) -> frozenset:
    rows = [r for r in ir.aux_rows if r.klass == AUX_MATCH]
    if not rows:
        return _TF
    filters = _filter_values(rows)
    # a filter can compile zero rows (vacuous selector): value unknown
    vals = [filters.get(fi, _TF) for fi in range(ir.n_match_filters)]
    return _or(vals) if ir.match_any else _and(vals)


def fold_exclude(ir: RuleIR) -> frozenset:
    rows = [r for r in ir.aux_rows if r.klass == AUX_EXCLUDE]
    if ir.n_exclude_filters == 0:
        return _F  # nothing to exclude
    filters = _filter_values(rows)
    # a filter that compiled to zero rows (empty block) never excludes
    vals = [filters.get(fi, _F) for fi in range(ir.n_exclude_filters)]
    return _and(vals) if ir.exclude_all else _or(vals)


def _fold_conditions(ir: RuleIR, klass: int, has_any: bool) -> frozenset:
    rows = [r for r in ir.aux_rows if r.klass == klass]
    any_groups = _group_values([r for r in rows if r.any_block])
    all_groups = _group_values([r for r in rows if not r.any_block])
    # evaluate.go: a present-but-empty any list fails the block outright
    any_part = _or(any_groups.values()) if has_any else _T
    return _and([any_part, _and(all_groups.values())])


def fold_preconditions(ir: RuleIR) -> frozenset:
    if not ir.has_precond:
        return _T
    return _fold_conditions(ir, AUX_PRECOND, ir.precond_has_any)


def fold_deny(ir: RuleIR) -> frozenset:
    return _fold_conditions(ir, AUX_DENY, ir.deny_has_any)


def _check_key(check) -> tuple:
    """Check identity for subsumption, ignoring placement (alt/group)."""
    d = asdict(check)
    d.pop("alt")
    d.pop("group")
    return tuple(sorted(d.items()))


def shadowed_alts(ir: RuleIR) -> list[tuple[int, int]]:
    """(earlier, later) pairs where the earlier alternative subsumes the
    later one. Gated (element-aligned) checks are skipped — gate groups
    couple checks across groups and the simple lattice is not sound."""
    if ir.n_alts < 2:
        return []
    alts: list[list[frozenset] | None] = []
    for alt in range(ir.n_alts):
        checks = [c for c in ir.checks if c.alt == alt]
        if any(c.gate != -1 for c in checks):
            alts.append(None)
            continue
        groups: dict[int, set] = {}
        for c in checks:
            groups.setdefault(c.group, set()).add(_check_key(c))
        alts.append([frozenset(s) for s in groups.values()])
    out = []
    for j in range(1, ir.n_alts):
        if alts[j] is None:
            continue
        for i in range(j):
            if alts[i] is None:
                continue
            # alt_i subsumes alt_j: every group of alt_i has a subset
            # group in alt_j (OR over a subset implies OR over the set)
            if all(any(gj <= gi for gj in alts[j]) for gi in alts[i]):
                out.append((i, j))
                break
    return out


def analyze_reachability(policy, rules, rule_irs) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for rule, ir in zip(rules, rule_irs):
        if ir.host_only:
            continue  # the oracle owns host rules; nothing folded here

        if fold_match(ir) == _F:
            out.append(make(
                "KT201", "match program is statically unsatisfiable; the "
                "rule can never apply to any resource",
                policy=policy.name, rule=rule.name, component="match"))
            continue
        if fold_exclude(ir) == _T:
            out.append(make(
                "KT201", "exclude block always matches; every resource is "
                "excluded and the rule can never apply",
                policy=policy.name, rule=rule.name, component="exclude"))
            continue
        if fold_preconditions(ir) == _F:
            out.append(make(
                "KT201", "preconditions constant-fold to false; the rule "
                "can never apply",
                policy=policy.name, rule=rule.name, component="preconditions"))
            continue

        if ir.is_deny:
            deny = fold_deny(ir)
            if deny == _T:
                out.append(make(
                    "KT203", "deny conditions constant-fold to true; every "
                    "matching resource is denied regardless of content",
                    policy=policy.name, rule=rule.name, component="deny"))
            elif deny == _F:
                out.append(make(
                    "KT204", "deny conditions constant-fold to false; the "
                    "rule never denies anything",
                    policy=policy.name, rule=rule.name, component="deny"))

        for i, j in shadowed_alts(ir):
            out.append(make(
                "KT202",
                f"anyPattern alternative {j} is shadowed by alternative "
                f"{i}: whenever it passes, alternative {i} already passed",
                policy=policy.name, rule=rule.name,
                component=f"anyPattern[alt={j}]"))
    return out
