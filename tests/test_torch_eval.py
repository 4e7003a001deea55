"""Stages 2-6 and K5 parity: the port's int8 verdict matrices and scan
counts (plain versions on the CPU) equal the JAX package's, exactly —
once with the compiled tensors carried across by ``convert.py`` (kernel
parity alone), once from the port's own compile (the slice) and once
through ``eval_rules`` itself. Covers the cross-check corpora (gate and
condition rows), a deny-only set (no check rows), difffuzz seeds and a
wide corpus (301 paths, 16 slots a path). The scan runs through the scan
form's masks (``scan_masks_plain``, ``scan_reduce_plain``), with the plan
as one rule tile and as several. Also pins the plan's layout to
``csrc/plan.cuh``: the header, the tile table, the column-major tile
sections and a block's shared memory, and the rule tiles' ranges."""

import inspect
import os
import re

import numpy as np
import pytest
import torch

from kyverno_tpu_torch import convert
from kyverno_tpu_torch.models import CompiledPolicySet as TorchPolicySet
from kyverno_tpu_torch.models.flatten import flatten_batch
from kyverno_tpu_torch.ops import eval as ev
from kyverno_tpu_torch.ops import plan as plan_mod
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse)
    both_sets,
    corpus_docs,
    corpus_resources,
    jax_blob,
    jax_scan,
    jax_verdicts,
    tensor_fields,
)

CASES = [("crosscheck", 96), ("deny_only", 48), ("fuzz3", 64), ("fuzz41", 64),
         ("wide", 24)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    corpus, n = request.param
    jset, tset = both_sets(corpus_docs(corpus))
    resources = corpus_resources(corpus, n)
    return corpus, jset, tset, resources, jax_verdicts(jset, resources)


def test_verdicts_own_compile(case):
    corpus, jset, tset, resources, want = case
    got = tset.evaluate_device(tset.flatten(resources))
    assert got.dtype == np.int8 and want.dtype == np.int8
    assert np.array_equal(got, want), _first_diff(got, want)
    if corpus == "deny_only":
        assert tset.plan.C == 0
    if corpus == "wide":
        assert tset.plan.n_tiles > 1 and got.shape == (24, 101)


def test_verdicts_carried_tensors(case):
    """The JAX compile's tensors and blob, carried across, through the
    port's kernels' plain versions."""
    _, jset, _, resources, want = case
    tensors = convert.tensors_from_numpy(tensor_fields(jset.tensors))
    carried = TorchPolicySet(jset.policies, device="cpu", tensors=tensors)
    jb = jset.flatten(resources)
    batch = convert.batch_from_numpy(*jb.packed_args())
    got = carried.evaluate_device(batch)
    assert np.array_equal(got, want), _first_diff(got, want)


@pytest.mark.parametrize("tile_words", [plan_mod.TILE_WORDS, 600])
def test_scan_counts(case, tile_words):
    """The scan (K1 -> eval_rules' scan form -> K5, plain on the CPU)
    equals the JAX package's build_scan_fn_blob, with the plan as the
    engine builds it and cut into several rule tiles, so that the HOST
    masks of several tiles are OR-ed."""
    corpus, jset, tset, resources, _ = case
    want = jax_scan(jset, resources)
    batch = tset.flatten(resources)
    if tile_words == plan_mod.TILE_WORDS:
        got = tset.scan_counts(batch)
    else:
        # the deny-only set's two rules fit one tile of 600 words
        words = 64 if corpus == "deny_only" else tile_words
        plan = plan_mod.Plan(tset.tensors, "cpu", tile_words=words)
        assert plan.n_tiles > 1
        blob, shp = tset.to_device(batch)
        got = tuple(x.numpy() for x in ev.scan_blob(plan, blob, *shp))
    for name, w, g in zip(("fails", "passes", "host_rows"), want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g), name


@pytest.mark.parametrize("B", [0, 1, 31, 32, 33, 65, 127, 128, 129, 300])
def test_scan_masks_and_reduce_equal_counts(B):
    """scan_masks_plain then scan_reduce_plain equal scan_counts_plain on
    seeded verdict matrices over a plan of several rule tiles, with HOST
    cells in the first and the last rule of a tile; the masks hold bit
    b % 32 of word b // 32 for resource b, and zeros past B."""
    _, tset = both_sets(corpus_docs("crosscheck"))
    plan = plan_mod.Plan(tset.tensors, "cpu", tile_words=600)
    assert plan.n_tiles > 2
    R = plan.R
    rng = np.random.default_rng(B)
    v = rng.choice(6, size=(B, R), p=[0.3, 0.3, 0.3, 0.05, 0.04, 0.01])
    ends = plan.tile_table[1, [plan_mod.TT_R0, plan_mod.TT_R1]]
    for b in range(0, B, 7):
        v[b, ends[0] if b % 2 else ends[1] - 1] = ev.V_HOST
    verdict = torch.from_numpy(v.astype(np.int8))
    masks = ev.scan_masks_plain(plan, verdict)
    G = -(-B // 32)
    assert [tuple(m.shape) for m in masks] == [(G, R), (G, R), (plan.n_tiles, G)]
    assert all(m.dtype == torch.int32 for m in masks)
    words = masks[0].numpy().view(np.uint32)
    bits = (words[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    bits = bits.reshape(G * 32, R)
    assert np.array_equal(bits[:B], v == ev.V_FAIL) and not bits[B:].any()
    got = ev.scan_reduce_plain(*masks, B)
    want = ev.scan_counts_plain(verdict)
    for name, w, g in zip(("fails", "passes", "host_rows"), want, got):
        assert w.dtype == g.dtype and torch.equal(w, g), name
    if B >= 32:
        assert bool(want[2].any())


@pytest.mark.parametrize("corpus,tile_words", [
    ("wide", plan_mod.TILE_WORDS), ("crosscheck", 64)])
@pytest.mark.parametrize("B", [1, 31, 33, 65])
def test_scan_and_counts_at_group_edges(corpus, tile_words, B):
    """The scan (masks then K5) and the counts form, plain on the CPU,
    equal the JAX package's scan and the counts of its verdicts at the
    kernel's group edges and at a batch that ends inside a group: on the
    wide corpus (E = 16) and on a plan whose tiles hold a rule alone."""
    jset, tset = both_sets(corpus_docs(corpus))
    plan = plan_mod.Plan(tset.tensors, "cpu", tile_words=tile_words)
    if corpus == "crosscheck":
        assert (plan.tile_table[:, plan_mod.TT_R1]
                - plan.tile_table[:, plan_mod.TT_R0] == 1).any()
    resources = corpus_resources(corpus, B)
    blob, shp = tset.to_device(tset.flatten(resources))
    if corpus == "wide":
        assert shp[2] == 16
    want = jax_scan(jset, resources)
    got = ev.scan_blob(plan, blob, *shp)
    for name, w, g in zip(("fails", "passes", "host_rows"), want, got):
        assert np.array_equal(w, g.numpy()), name
    jv = jax_verdicts(jset, resources)
    live = tset.tensors.n_rules_live
    v, fails, passes = ev.eval_rules_counts(
        plan, blob, *shp, ev.match_matrix(plan, blob, *shp), live)
    assert np.array_equal(v.numpy()[:B, :live], jv)
    assert np.array_equal(fails.numpy(), (jv == ev.V_FAIL).sum(axis=0))
    assert np.array_equal(passes.numpy(), (jv == ev.V_PASS).sum(axis=0))


def test_eval_rules_constants_match_source():
    """The group sizes and the launch record the wrappers and the plan's
    account of shared memory assume are the kernel's own: its largest
    group is kMaxK words of kMaxTB resources, a mask word per 32
    resources in every per-row array, and its launch writes LAUNCH_INFO
    fields."""
    src = open(os.path.join(os.path.dirname(plan_mod.__file__), "..", "csrc",
                            "eval_rules.cu")).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+);", src).group(1))

    assert const("kMaxK") * const("kMaxTB") == plan_mod.MAX_GROUP

    assert const("kThreads") == 256
    assert len(re.findall(r"\bin\[\d\] = ", src)) == ev.LAUNCH_INFO == 4
    P = plan_mod

    def masks(tb):
        # one check row's flags, one aux row's, a condition slot's words
        # at E = 2 and one rule's kind mask, beside the slots and bmeta
        return (P.tile_bytes(0, 0, 1, 1, 1, 0, 1, 2, tb)
                - P.tile_bytes(0, 0, 0, 0, 0, 0, 0, 2, tb))

    w = {tb: -(-tb // 32) for tb in (1, 8, 32, 64, 128)}
    for tb, words in w.items():
        assert masks(tb) == sum(-(-4 * n * words // P.SM_ALIGN) * P.SM_ALIGN
                                for n in (P.SM_CHECK_MASKS, P.SM_AUX_MASKS,
                                          P.SM_COND_WORDS * 2,
                                          P.SM_RULE_MASKS))
    for tb in (0, P.MAX_GROUP + 1):
        with pytest.raises(ValueError, match="a group of"):
            P.tile_bytes(0, 0, 0, 0, 0, 0, 0, 1, tb)
    _, tset = both_sets(corpus_docs("library250"))
    plan = tset.plan
    for tb in (64, P.MAX_GROUP):
        assert plan.smem_bytes(1, tb) == max(
            P.tile_bytes(*P._row_dims(row), 1, tb) for row in plan.tile_table)



def test_chip_smoke_operations_bound():
    """chip_smoke's integer-operations count for eval_rules' bound: per
    resource, each distinct check row on each slot and each distinct aux
    row of a tile; per 32-resource word, the walks' entries and the
    rules; the matrix and counts forms' verdict bytes, the counts form's
    counts; and the bound is the larger of its two terms."""
    import chip_smoke as cs

    _, tset = both_sets(corpus_docs("library250"))
    plan = tset.plan
    R = plan.R
    m, s_, c = (cs.eval_rules_ops(plan, 1000, 1, f)
                for f in ("matrix", "scan", "counts"))
    assert m - s_ == 1000 * R * cs.OPS_BYTE
    assert c - m == 32 * R * cs.OPS_COUNT
    # one more resource in the same word: the 6 distinct check rows and
    # the 3 distinct aux rows of the library's one tile
    assert (cs.eval_rules_ops(plan, 2, 1, "scan")
            - cs.eval_rules_ops(plan, 1, 1, "scan")
            == 6 * cs.OPS_CHECK_SLOT + 3 * cs.OPS_AUX_ROW)
    assert cs.rules_bound(3_350_000, 0) == (1e-3, "bytes")
    by_ops = cs.rules_bound(0, int(cs.INT32_OPS_PER_S))
    assert by_ops[1] == "operations" and abs(by_ops[0] - 1e3) < 1e-9


def test_stage_outputs_consistent(case):
    """The stage 2-3 flags and the stage 4-6 verdicts of the plain versions
    compose to the JAX package's verdicts, as eval_rules (stages 2-6 in
    one call) gives them, and the async handle gives the same matrix."""
    _, _, tset, resources, want = case
    batch = tset.flatten(resources)
    blob, shp = tset.to_device(batch)
    m = ev.match_matrix(tset.plan, blob, *shp)
    k3 = ev.eval_checks_plain(tset.plan, blob, *shp, m)
    assert k3[0].shape == (shp[0], tset.plan.C) and k3[0].dtype == torch.uint8
    assert k3[1].shape == (shp[0], tset.plan.NCOND, 3)
    assert k3[2].shape == (shp[0], tset.plan.X)
    v = ev.eval_verdict_plain(tset.plan, blob, *shp, *k3)
    assert np.array_equal(v.numpy()[:, :tset.tensors.n_rules_live], want)
    got = ev.eval_rules(tset.plan, blob, *shp, m)
    assert got.shape == (shp[0], tset.plan.R) and got.dtype == torch.int8
    got = got.numpy()[:, :tset.tensors.n_rules_live]
    assert np.array_equal(got, want), _first_diff(got, want)
    handle = tset.evaluate_device_async(batch)
    assert np.array_equal(handle.get(), want)


def _first_diff(got, want):
    d = np.argwhere(got != want)
    if not d.size:
        return "equal"
    b, r = d[0]
    return f"{len(d)} cells differ; first (b={b}, r={r}): jax {want[b, r]} port {got[b, r]}"


def _header_enums() -> dict:
    path = os.path.join(os.path.dirname(plan_mod.__file__), "..", "csrc",
                        "plan.cuh")
    text = open(path).read()
    pairs = dict((k, int(v)) for k, v in re.findall(
        r"\b(H_\w+|TT_\w+|TS_\w+|CK_\w+|AX_\w+|PE_\w+|AE_\w+|CF_\w+|XF_\w+|AG_\w+"
        r"|SM_\w+)"
        r"\s*=\s*(\d+)", text))
    pairs.update((k, 1 << int(v)) for k, v in
                 re.findall(r"\b(RF_\w+)\s*=\s*1\s*<<\s*(\d+)", text))
    return pairs


def test_plan_constants_match_header():
    """Every enum the kernel reads from csrc/plan.cuh has the value that
    ops/plan.py writes, and the layout enums (global header, tile table,
    section header, check and aux columns, entry bits) match name for
    name, and so do those of a block's shared memory (SM_). The plan
    budgets each tile at the flattener's own cap on slots."""
    pairs = _header_enums()
    for name, value in pairs.items():
        assert getattr(plan_mod, name) == value, name
    layout = ("H_", "TT_", "TS_", "CK_", "AX_", "PE_", "AE_", "SM_")
    py = {n for n in vars(plan_mod) if n.startswith(layout) and n.isupper()}
    assert py == {n for n in pairs if n.startswith(layout)}
    assert len(pairs) >= 126
    max_slots = inspect.signature(flatten_batch).parameters["max_slots"]
    assert max_slots.default == plan_mod.FLAT_SLOTS
    assert ev.MAX_SLOTS == plan_mod.MAX_SLOTS


def _tile_table(plan):
    buf = plan.buf_np
    n = int(buf[plan_mod.H_NTILES])
    t0 = int(buf[plan_mod.H_TILES])
    return buf[t0:t0 + n * plan_mod.TT_NCOLS].reshape(n, plan_mod.TT_NCOLS)


def _section(plan, row):
    sec = plan.buf_np[row[plan_mod.TT_OFF]:row[plan_mod.TT_OFF] + row[plan_mod.TT_WORDS]]

    def arr(h, n):
        return sec[sec[h]:sec[h] + n]

    def lst(hp, hi, i):
        return sec[sec[hi] + sec[sec[hp] + i]: sec[hi] + sec[sec[hp] + i + 1]]

    return sec, arr, lst


@pytest.mark.parametrize("corpus", ["crosscheck", "library250", "anchor"])
def test_plan_csr_walks_cover_segments(corpus):
    """Walking each rule tile's lists (a rule's pattern entries; its aux
    groups' rows) reaches exactly the rows the JAX program's segment ids
    assign to each rule, each through the distinct row it became, with
    one alternative end per alternative; the column-major tables hold
    each distinct row once, and through the tile's row maps the compiled
    columns of every row (paths through the tile's path list, gates and
    condition slots local to the tile)."""
    _, tset = both_sets(corpus_docs(corpus))
    t, plan = tset.tensors, tset.plan
    P = plan_mod
    cond_slot = np.cumsum(t.chk_is_cond) - 1
    merged = 0
    for row, (cmap, xmap) in zip(_tile_table(plan), plan.row_maps):
        sec, arr, lst = _section(plan, row)
        r0, c0, x0 = row[P.TT_R0], row[P.TT_C0], row[P.TT_X0]
        for r in range(row[P.TT_R1] - r0):
            pat = lst(P.TS_PAT_PTR, P.TS_PAT, r)
            rows = [int(e >> P.PE_SHIFT) for e in pat if not e & P.PE_NOROW]
            own = np.nonzero(t.chk_rule == r0 + r)[0] - c0
            assert sorted(rows) == sorted(cmap[own].tolist())
            n_alts = int(np.sum(t.alt_rule == r0 + r))
            assert sum(bool(e & P.PE_ALT_END) for e in pat) == n_alts
            aux = [int(x) for e in lst(P.TS_AUXP_PTR, P.TS_AUXP, r)
                   if not e & P.AE_NOGROUP
                   for x in lst(P.TS_AXG_PTR, P.TS_AXG_ROW, e >> P.AE_SHIFT)]
            own = np.nonzero(t.ax_rule == r0 + r)[0] - x0
            assert sorted(aux) == sorted(xmap[own].tolist())
        Ct, Xt = sec[P.TS_C], sec[P.TS_X]
        assert (Ct, Xt) == (row[P.TT_NCHK], row[P.TT_NAUX])
        chk_d = arr(P.TS_CHK, Ct * P.CK_NCOLS).reshape(P.CK_NCOLS, Ct)
        aux_d = arr(P.TS_AUX, Xt * P.AX_NCOLS).reshape(P.AX_NCOLS, Xt)
        for d in (chk_d, aux_d):
            assert len({tuple(c) for c in d.T}) == d.shape[1]
        chk, aux_t = chk_d[:, cmap], aux_d[:, xmap]
        paths = arr(P.TS_PATHS, sec[P.TS_NPATH])
        c1, x1 = row[P.TT_C1], row[P.TT_X1]
        assert len(cmap) == c1 - c0 and len(xmap) == x1 - x0
        merged += (c1 - c0 - Ct) + (x1 - x0 - Xt)
        assert np.array_equal(paths[chk[P.CK_PATH]], t.chk_path[c0:c1])
        assert np.array_equal(chk[P.CK_OP], t.chk_op[c0:c1])
        assert np.array_equal(chk[P.CK_IS_GATE], t.chk_is_gate_row[c0:c1])
        gate = t.chk_gate[c0:c1]
        assert np.array_equal(np.where(gate >= 0, chk[P.CK_GATE] + row[P.TT_GATE0], -1),
                              gate)
        slot = np.where(t.chk_is_cond[c0:c1], cond_slot[c0:c1], -1)
        assert np.array_equal(
            np.where(slot >= 0, chk[P.CK_COND_SLOT] + row[P.TT_SLOT0], -1), slot)
        assert np.array_equal(paths[aux_t[P.AX_PATH]], np.maximum(t.ax_path[x0:x1], 0))
        assert np.array_equal(aux_t[P.AX_OP], t.ax_op[x0:x1])
        assert np.array_equal(aux_t[P.AX_KIND], t.ax_kind_req[x0:x1])
    if corpus == "library250":
        # 248 check rows are 6 distinct ones, 248 aux rows 3
        assert merged == (248 - 6) + (248 - 3)


@pytest.mark.parametrize("corpus,tile_words", [
    ("library250", plan_mod.TILE_WORDS), ("library250", 2048),
    ("crosscheck", plan_mod.TILE_WORDS), ("crosscheck", 600),
    ("library1000", plan_mod.TILE_WORDS), ("library1000", 4096),
    ("wide", plan_mod.TILE_WORDS), ("wide", 600),
])
def test_plan_rule_tiles(corpus, tile_words):
    """The plan's rule tiles: consecutive rule ranges whose check-row and
    aux-row ranges are contiguous and cover each row exactly once, each
    gate and condition slot inside its rule's tile, and each section on
    16 bytes. A block over any tile fits in shared memory at one resource
    and 32 slots a path; one over a tile of several rules also at 8
    resources and the flattener's 16 slots, with the section within the
    tile budget. The wide corpus (301 paths) is cut by its slots, not its
    words, and its 100-path rule takes a tile alone."""
    tset = TorchPolicySet([torch_load_policy(d) for d in corpus_docs(corpus)],
                          device="cpu")
    t = tset.tensors
    plan = plan_mod.Plan(t, "cpu", tile_words=tile_words)
    P = plan_mod
    table = _tile_table(plan)
    assert len(table) == plan.n_tiles >= 1
    if corpus == "library250" and tile_words == P.TILE_WORDS:
        assert plan.n_tiles == 1
    if corpus == "library1000" or tile_words < P.TILE_WORDS:
        assert plan.n_tiles > 1
    for lo, hi in ((P.TT_R0, P.TT_R1), (P.TT_C0, P.TT_C1), (P.TT_X0, P.TT_X1),
                   (P.TT_SLOT0, P.TT_SLOT1)):
        assert table[0, lo] == 0 and np.array_equal(table[1:, lo], table[:-1, hi])
        assert np.all(table[:, hi] >= table[:, lo])
    assert table[-1, P.TT_R1] == t.n_rules
    assert table[-1, P.TT_C1] == t.chk_op.size and table[-1, P.TT_X1] == t.ax_op.size
    assert table[-1, P.TT_SLOT1] == int(np.sum(t.chk_is_cond))
    assert np.all(table[1:, P.TT_GATE0] >= table[:-1, P.TT_GATE1])
    tile_of = np.repeat(np.arange(len(table)), table[:, P.TT_R1] - table[:, P.TT_R0])
    for name, rule_of, lo, hi in (("check", t.chk_rule, P.TT_C0, P.TT_C1),
                                  ("aux", t.ax_rule, P.TT_X0, P.TT_X1)):
        idx = np.arange(len(rule_of))
        k = tile_of[rule_of]
        assert np.all((table[k, lo] <= idx) & (idx < table[k, hi])), name
    gated = np.nonzero(t.chk_gate >= 0)[0]
    k = tile_of[t.chk_rule[gated]]
    assert np.all((table[k, P.TT_GATE0] <= t.chk_gate[gated])
                  & (t.chk_gate[gated] < table[k, P.TT_GATE1]))
    cond = np.nonzero(t.chk_is_cond)[0]
    slot = np.arange(cond.size)
    k = tile_of[t.chk_rule[cond]]
    assert np.all((table[k, P.TT_SLOT0] <= slot) & (slot < table[k, P.TT_SLOT1]))
    assert np.all(table[:, P.TT_OFF] % P.SECTION_ALIGN == 0)
    assert np.all(table[:, P.TT_WORDS] % P.SECTION_ALIGN == 0)
    dims = [P._row_dims(row) for row in table]
    for d, row in zip(dims, table):
        assert P.tile_bytes(*d, P.MAX_SLOTS, 1) <= P.SMEM_BYTES
        if row[P.TT_R1] - row[P.TT_R0] > 1:
            assert d[0] <= tile_words
            assert P.tile_bytes(*d, P.FLAT_SLOTS, P.FLAT_TB) <= P.SMEM_BYTES
    for E, tb in ((1, 32), (P.FLAT_SLOTS, 4)):
        assert plan.smem_bytes(E, tb) == max(P.tile_bytes(*d, E, tb) for d in dims)
    if corpus == "wide":
        assert plan.n_tiles >= 6 and table[-1, P.TT_R0] == t.n_rules - 1
        assert table[-1, P.TT_NPATH] == 100
        assert P.tile_bytes(*dims[-1], P.FLAT_SLOTS, P.FLAT_TB) > P.SMEM_BYTES
        assert sum(d[0] for d in dims) <= P.TILE_WORDS


def test_plan_refuses_rows_out_of_rule_order():
    """Rules numbered backwards still nest, but a rule tile would no longer
    be one range of rows: `Plan` refuses it."""
    _, tset = both_sets(corpus_docs("fuzz3"))
    t = convert.tensors_from_numpy(tensor_fields(tset.tensors))
    last = t.n_rules - 1
    assert len(set(t.chk_rule.tolist())) >= 2
    for name in ("chk_rule", "ax_rule", "alt_rule", "axg_rule", "axf_rule"):
        setattr(t, name, last - getattr(t, name))
    with pytest.raises(ValueError, match="not in rule order"):
        plan_mod.Plan(t, "cpu")


def test_plan_refuses_a_rule_beyond_shared_memory():
    """A rule whose tile would not fit a block of one resource at 32 slots
    a path is refused when the plan is built, not at launch."""
    tset = TorchPolicySet([torch_load_policy(d) for d in corpus_docs("wide")],
                          device="cpu")
    plan_mod.Plan(tset.tensors, "cpu", smem_bytes=110_000)
    with pytest.raises(ValueError, match="rule 100 needs"):
        plan_mod.Plan(tset.tensors, "cpu", smem_bytes=100_000)


def test_eval_rules_refuses_other_devices():
    """No fallback: off the CPU, eval_rules (either form) and K5 launch
    their kernels or raise."""
    jset, tset = both_sets(corpus_docs("deny_only"))
    blob, (B, P, E, V) = jax_blob(jset, corpus_resources("deny_only", 4))
    meta = torch.empty(blob.size, dtype=torch.int32, device="meta")
    m = torch.empty((tset.plan.nfa_char.shape[0], V), dtype=torch.bool,
                    device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ev.eval_rules(tset.plan, meta, B, P, E, V, m)
    with pytest.raises(ValueError, match="unsupported device"):
        ev.eval_rules_scan(tset.plan, meta, B, P, E, V, m)
    masks = [torch.empty(s, dtype=torch.int32, device="meta")
             for s in ((1, 2), (1, 2), (1, 1))]
    with pytest.raises(ValueError, match="unsupported device"):
        ev.scan_reduce(*masks, B)


def test_blob_shape_checked():
    jset, tset = both_sets(corpus_docs("deny_only"))
    blob, (B, P, E, V) = jax_blob(jset, corpus_resources("deny_only", 4))
    with pytest.raises(ValueError, match="too short"):
        ev.evaluate_blob(tset.plan, torch.from_numpy(blob.view(np.int32)),
                         B, P, E, V + 1000)
