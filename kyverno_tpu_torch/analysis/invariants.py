"""Tensor-invariant pass (KT3xx).

Validates the structural contracts between the compiler and the device
kernels: every index tensor in ``PolicyTensors`` stays inside the table
it gathers from, and every ``FlatBatch`` (raw or bucket-padded) keeps
the interner/type-tag/padding invariants that ``pack_batch`` and the
eval kernels assume. A violation here means a malformed gather on
device — silently wrong verdicts, not an exception — which is why all
KT3xx diagnostics are ERROR severity.

Pure numpy; no torch import, so the lint CLI stays host-only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.compiler import MAX_SEGMENTS, NFA_STATES, PolicyTensors
from ..models.flatten import T_ABSENT, T_LIST, FlatBatch, pad_fill
from ..models.ir import SEP
from .diagnostics import Diagnostic, make


def _bound(name: str, arr, hi: int, lo: int = 0,
           sentinel: int | None = None) -> list[Diagnostic]:
    """Index array must lie in [lo, hi) (sentinel value exempt)."""
    a = np.asarray(arr)
    if a.size == 0:
        return []
    bad = (a < lo) | (a >= hi)
    if sentinel is not None:
        bad &= a != sentinel
    if not bad.any():
        return []
    worst = int(a[bad].flat[0])
    return [make(
        "KT302",
        f"{name}: {int(bad.sum())} entries outside [{lo}, {hi}) "
        f"(first offender {worst}); device gather would read garbage",
        component=f"tensors.{name}",
    )]


def _dtype(name: str, arr, want: type) -> list[Diagnostic]:
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, want):
        return []
    return [make(
        "KT301",
        f"{name} has dtype {a.dtype}, expected {want.__name__}-like; "
        "the pjit kernel signature would recompile or miscast",
        component=f"tensors.{name}",
    )]


def check_tensors(t: PolicyTensors) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    P, C, X = t.n_paths, len(t.chk_op), len(t.ax_op)
    G, A, GX, FX = t.n_groups, t.n_alts, t.n_aux_groups, t.n_aux_filters
    N = len(t.nfa_len)
    R = t.n_rules

    # index-range invariants (KT302)
    out += _bound("chk_path", t.chk_path, P)
    out += _bound("chk_rule", t.chk_rule, R)
    out += _bound("chk_alt_gid", t.chk_alt_gid, A)
    out += _bound("chk_group_gid", t.chk_group_gid, G)
    out += _bound("chk_gate", t.chk_gate, t.n_gates, sentinel=-1)
    out += _bound("chk_nfa", t.chk_nfa, N, sentinel=-1)
    out += _bound("ax_path", t.ax_path, P, sentinel=-1)
    out += _bound("ax_rule", t.ax_rule, R)
    out += _bound("ax_group", t.ax_group, GX)
    out += _bound("ax_nfa", t.ax_nfa, N, sentinel=-1)
    out += _bound("ax_kind_req", t.ax_kind_req, len(t.kind_index), sentinel=-1)
    out += _bound("group_alt", t.group_alt, A)
    out += _bound("alt_rule", t.alt_rule, R)
    out += _bound("axg_rule", t.axg_rule, R)
    out += _bound("axg_filt", t.axg_filt, FX, sentinel=-1)
    out += _bound("axf_rule", t.axf_rule, R)
    out += _bound("rule_kind_ids", t.rule_kind_ids, len(t.kind_index),
                  sentinel=-1)

    # dtype invariants (KT301) on the gather-critical tensors
    out += _dtype("chk_path", t.chk_path, np.integer)
    out += _dtype("chk_num_lo", t.chk_num_lo, np.signedinteger)
    out += _dtype("chk_num_hi", t.chk_num_hi, np.signedinteger)
    out += _dtype("ax_q_hi", t.ax_q_hi, np.signedinteger)
    out += _dtype("nfa_char", t.nfa_char, np.unsignedinteger)

    # geometry invariants (KT303)
    chk_cols = [
        "chk_path", "chk_op", "chk_rule", "chk_alt_gid", "chk_group_gid",
        "chk_gate", "chk_guard", "chk_nfa", "chk_num_lo", "chk_num_hi",
    ]
    for name in chk_cols:
        if len(np.asarray(getattr(t, name))) != C:
            out.append(make(
                "KT303", f"{name} length {len(np.asarray(getattr(t, name)))} "
                f"!= check count {C}; check columns desynchronized",
                component=f"tensors.{name}"))
    if t.nfa_char.shape[1:] != (NFA_STATES,):
        out.append(make(
            "KT303", f"nfa_char state axis {t.nfa_char.shape[1:]} != "
            f"({NFA_STATES},); glob NFA step would misindex",
            component="tensors.nfa_char"))
    if (np.asarray(t.nfa_len) > NFA_STATES - 1).any():
        out.append(make(
            "KT303", "nfa_len exceeds NFA_STATES-1; pattern should have "
            "taken the host lane at compile time",
            component="tensors.nfa_len"))
    too_deep = [p for p in t.paths if len(p.split(SEP)) > MAX_SEGMENTS]
    if too_deep:
        out.append(make(
            "KT303", f"{len(too_deep)} dictionary paths exceed "
            f"MAX_SEGMENTS={MAX_SEGMENTS} (first: "
            f"{too_deep[0].replace(SEP, '.')!r})",
            component="tensors.paths"))
    out += check_segments(t)
    return out


def _span_bound(name: str, arr, seg: str, lo: int, hi: int,
                sentinel: int | None = None) -> list[Diagnostic]:
    """A segment's slice of an index column must stay inside that
    segment's own rebased span."""
    a = np.asarray(arr)
    if a.size == 0:
        return []
    bad = (a < lo) | (a >= hi)
    if sentinel is not None:
        bad &= a != sentinel
    if not bad.any():
        return []
    return [make(
        "KT304",
        f"{name}: {int(bad.sum())} entries of segment {seg!r} escape its "
        f"span [{lo}, {hi}) (first offender {int(a[bad].flat[0])}); a "
        "corrupted splice rebased this column against the wrong base",
        component=f"tensors.{name}")]


def check_segments(t: PolicyTensors) -> list[Diagnostic]:
    """Splice receipts (KT304): after an incremental assembly the
    per-policy SegmentSpans must exactly tile every rebased axis, the
    logical rule count must fit the (possibly bucket-padded) rule axis,
    and every cross-referencing id inside a segment's rows must stay in
    that segment's own span. A violation means ``assemble_tensors``
    spliced a stale or mis-rebased segment — verdict columns silently
    read another policy's rows."""
    segs = list(getattr(t, "segments", None) or [])
    if not segs:
        return []
    out: list[Diagnostic] = []
    n_live = t.n_rules_live
    if n_live > t.n_rules:
        out.append(make(
            "KT304", f"n_rules_logical {n_live} exceeds padded rule axis "
            f"{t.n_rules}; verdict slicing would read out of bounds",
            component="tensors.n_rules_logical"))
    axes = {
        "chk": len(t.chk_op), "alt": t.n_alts, "group": t.n_groups,
        "gate": t.n_gates, "aux": len(t.ax_op), "axg": t.n_aux_groups,
        "axf": t.n_aux_filters,
    }
    for axis, total in axes.items():
        pos, ok = 0, True
        for start, length in sorted(getattr(s, axis) for s in segs):
            if start != pos:
                ok = False
                break
            pos += length
        if not ok or pos != total:
            out.append(make(
                "KT304", f"segment {axis} spans do not tile [0, {total}): "
                "splice dropped or overlapped rows",
                component=f"tensors.segments.{axis}"))
    pos, ok = 0, True
    for start, length in sorted((s.rule_base, s.n_rules) for s in segs):
        if start != pos:
            ok = False
            break
        pos += length
    if not ok or pos != n_live:
        out.append(make(
            "KT304", f"segment rule spans do not tile [0, {n_live})",
            component="tensors.segments.rule"))

    for s in segs:
        r = (s.rule_base, s.rule_base + s.n_rules)
        alt = (s.alt[0], s.alt[0] + s.alt[1])
        axg = (s.axg[0], s.axg[0] + s.axg[1])
        axf = (s.axf[0], s.axf[0] + s.axf[1])
        c0, cl = s.chk
        out += _span_bound("chk_rule", t.chk_rule[c0:c0 + cl], s.name, *r)
        out += _span_bound("chk_alt_gid", t.chk_alt_gid[c0:c0 + cl],
                           s.name, *alt)
        out += _span_bound("chk_group_gid", t.chk_group_gid[c0:c0 + cl],
                           s.name, s.group[0], s.group[0] + s.group[1])
        out += _span_bound("chk_gate", t.chk_gate[c0:c0 + cl], s.name,
                           s.gate[0], s.gate[0] + s.gate[1], sentinel=-1)
        g0, gl = s.group
        out += _span_bound("group_alt", t.group_alt[g0:g0 + gl], s.name,
                           *alt)
        a0, al = s.alt
        out += _span_bound("alt_rule", t.alt_rule[a0:a0 + al], s.name, *r)
        x0, xl = s.aux
        out += _span_bound("ax_rule", t.ax_rule[x0:x0 + xl], s.name, *r)
        out += _span_bound("ax_group", t.ax_group[x0:x0 + xl], s.name,
                           *axg)
        out += _span_bound("axg_rule", t.axg_rule[axg[0]:axg[1]], s.name,
                           *r)
        out += _span_bound("axg_filt", t.axg_filt[axg[0]:axg[1]], s.name,
                           *axf, sentinel=-1)
        out += _span_bound("axf_rule", t.axf_rule[axf[0]:axf[1]], s.name,
                           *r)
    return out


def check_policy_shards(full: PolicyTensors, shards) -> list[Diagnostic]:
    """Policy-shard partition invariants (KT305). ``shards`` is the 2D
    mesh's policy axis: ``(shard_tensors, col_map)`` pairs where
    ``col_map[r]`` is shard rule ``r``'s global verdict column in the
    FULL assembly's layout. The partition is sound only when every
    shard is internally valid (the KT30x battery over its own rebased
    tensors), the col_maps exactly tile ``[0, full.n_rules_live)`` — a
    gap silently drops a rule's verdicts, an overlap double-writes a
    column — shard rule rows agree with the full assembly's rows at
    their mapped columns, and shard bucket-padding rows are inert
    (PAD_FILL kinds, every flag clear, nothing references them) so a
    padded shard can never emit a phantom verdict."""
    out: list[Diagnostic] = []
    n_live = full.n_rules_live

    def _shard(i: int, diags: list[Diagnostic]) -> list[Diagnostic]:
        return [dataclasses.replace(
            d, component=f"shard[{i}].{d.component}" if d.component
            else f"shard[{i}]") for d in diags]

    flag_fields = (
        "rule_host_only", "rule_match_all_kinds", "rule_match_any",
        "rule_has_match", "rule_has_exclude", "rule_exclude_all",
        "rule_has_precond", "rule_precond_any", "rule_is_deny",
        "rule_deny_any",
    )
    kind_pad = pad_fill("kind_id")
    cols_seen: list[np.ndarray] = []
    for i, (st, col_map) in enumerate(shards):
        out += _shard(i, check_tensors(st))
        live = st.n_rules_live
        cm = np.asarray(col_map)
        if not np.issubdtype(cm.dtype, np.integer):
            out.append(make(
                "KT305", f"shard {i} col_map dtype {cm.dtype} is not "
                "integral; the verdict scatter would fancy-index wrong",
                component=f"shard[{i}].col_map"))
            continue
        if cm.size != live:
            out.append(make(
                "KT305", f"shard {i} col_map has {cm.size} columns for "
                f"{live} live rules; scatter and verdicts desynchronized",
                component=f"shard[{i}].col_map"))
            continue
        if cm.size and ((cm < 0) | (cm >= n_live)).any():
            out.append(make(
                "KT305", f"shard {i} col_map escapes [0, {n_live}); the "
                "scatter would write outside the live verdict columns",
                component=f"shard[{i}].col_map"))
            continue
        cols_seen.append(cm)

        # row parity at the mapped columns: the shard's local rule rows
        # must be the full assembly's rows, just relocated
        for name in flag_fields:
            sv = np.asarray(getattr(st, name))[:live]
            fv = np.asarray(getattr(full, name))[cm]
            if not np.array_equal(sv, fv):
                out.append(make(
                    "KT305", f"shard {i} {name} disagrees with the full "
                    "assembly at its mapped columns; the partitioner "
                    "spliced a stale segment",
                    component=f"shard[{i}].{name}"))
        # kind-id sets compared as sets: KMAX widths differ per assembly
        sk, fk = np.asarray(st.rule_kind_ids), np.asarray(full.rule_kind_ids)
        for r in range(live):
            if (set(sk[r].tolist()) - {kind_pad}
                    != set(fk[cm[r]].tolist()) - {kind_pad}):
                out.append(make(
                    "KT305", f"shard {i} rule {r} kind set differs from "
                    f"full column {int(cm[r])}; kind prefilter diverges",
                    component=f"shard[{i}].rule_kind_ids"))
                break

        # bucket-padding rows must be inert
        if st.n_rules > live:
            if (np.asarray(st.rule_kind_ids)[live:] != kind_pad).any():
                out.append(make(
                    "KT305", f"shard {i} pad rows carry kind ids (expected "
                    f"PAD_FILL {kind_pad}); the kind prefilter could light "
                    "a dead column", component=f"shard[{i}].rule_kind_ids"))
            for name in flag_fields:
                if np.asarray(getattr(st, name))[live:].any():
                    out.append(make(
                        "KT305", f"shard {i} pad rows set {name}; padding "
                        "must be flag-clear",
                        component=f"shard[{i}].{name}"))
            for name in ("chk_rule", "alt_rule", "ax_rule", "axg_rule",
                         "axf_rule"):
                a = np.asarray(getattr(st, name))
                if a.size and (a >= live).any():
                    out.append(make(
                        "KT305", f"shard {i} {name} references bucket-pad "
                        f"rule rows (>= {live}); a pad column would "
                        "receive real verdict writes",
                        component=f"shard[{i}].{name}"))

    # the union of col_maps must tile the live columns exactly
    union = (np.sort(np.concatenate(cols_seen)) if cols_seen
             else np.zeros(0, np.int64))
    if len(shards) and not np.array_equal(union, np.arange(n_live)):
        uniq = np.unique(union)
        missing = n_live - uniq.size
        out.append(make(
            "KT305", f"shard col_maps do not tile [0, {n_live}): "
            f"{missing} columns unowned, {union.size - uniq.size} owned "
            "twice; the merged verdict matrix is not the unsharded one",
            component="shards.col_map"))
    return out


def check_batch(batch: FlatBatch) -> list[Diagnostic]:
    """FlatBatch invariants the device unpack/gather assumes (KT31x)."""
    out: list[Diagnostic] = []
    V = int(batch.str_len.shape[0])

    sid = np.asarray(batch.str_id)
    bad = (sid < -1) | (sid >= V)
    if bad.any():
        out.append(make(
            "KT311",
            f"str_id has {int(bad.sum())} entries outside [-1, {V}); the "
            f"packed word0 gather would read past the dictionary "
            f"(first offender {int(sid[bad].flat[0])})",
            component="batch.str_id"))

    tag = np.asarray(batch.type_tag)
    bad = (tag < T_ABSENT) | (tag > T_LIST)
    if bad.any():
        out.append(make(
            "KT312",
            f"type_tag has {int(bad.sum())} entries outside "
            f"[{T_ABSENT}, {T_LIST}]; the 3-bit packed lane would truncate",
            component="batch.type_tag"))

    # an invalid slot must not claim an interned string: pack_batch scatters
    # dictionary value lanes from cells, and a stray reference can clobber
    # a live row's num/dur bits
    stray = (~np.asarray(batch.slot_valid)) & (sid >= 0) \
        & (tag != T_ABSENT) & (~np.asarray(batch.null_break))
    if stray.any():
        out.append(make(
            "KT312",
            f"{int(stray.sum())} invalid slots carry a live str_id; "
            "dictionary scatter may clobber value lanes",
            component="batch.slot_valid"))

    if np.asarray(batch.live).shape != (batch.n,):
        out.append(make(
            "KT312", f"live mask shape {np.asarray(batch.live).shape} != "
            f"({batch.n},)", component="batch.live"))
    return out


def check_padded(batch: FlatBatch, orig_n: int) -> list[Diagnostic]:
    """pad_to_buckets postconditions (KT313): power-of-two axes and dead
    padding rows."""
    out: list[Diagnostic] = []
    for axis, size in (("B", batch.n), ("E", batch.e),
                       ("V", int(batch.str_len.shape[0]))):
        if size & (size - 1):
            out.append(make(
                "KT313", f"padded axis {axis}={size} is not a power of two; "
                "the bucket cache would miss every batch",
                component=f"batch.pad.{axis}"))
    live = np.asarray(batch.live)
    if live[orig_n:].any():
        out.append(make(
            "KT313", "padding rows past the original batch are marked live; "
            "they would produce phantom verdicts",
            component="batch.live"))
    if np.asarray(batch.slot_valid)[orig_n:].any():
        out.append(make(
            "KT313", "padding rows carry valid slots",
            component="batch.slot_valid"))
    return out + check_batch(batch)
