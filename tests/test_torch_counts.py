"""K7's counts as the epilogue of eval_rules' counts form, on both packages.

``eval_rules_counts`` returns the verdicts and, from them, per-rule FAIL
and PASS counts over every row of the first ``live`` rule columns. On
the CPU it runs ``eval_rules_plain`` then ``rule_counts_plain``; the
card's counts form is held to the same on the card by chip_smoke.py.
Here its counts are held, exactly, to those of the JAX package's K7
programs on the same padded batch: ``sharded_eval_fn`` (1D, conftest's 8
virtual devices, over the whole rule axis, an incremental set's padded
columns included) and ``shard_eval_fns`` (2D, per policy shard, whose
live rules are fewer than its bucket).
"""

import numpy as np
import pytest
import torch

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models.engine import IncrementalCompiler as JaxIncremental
from kyverno_tpu.models.engine import shard_policies as jax_shard_policies
from kyverno_tpu.models.flatten import pad_packed as jax_pad_packed
from kyverno_tpu.parallel import make_mesh as jax_make_mesh
from kyverno_tpu.parallel.mesh import sharded_eval_fn as jax_sharded_eval_fn
from kyverno_tpu.parallel.mesh import shard_eval_fns as jax_shard_eval_fns
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.models.engine import IncrementalCompiler, shard_policies
from kyverno_tpu_torch.models.flatten import _assemble_blob, pad_packed
from kyverno_tpu_torch.ops import _build
from kyverno_tpu_torch.ops import eval as ev
from kyverno_tpu_torch.ops import plan as plan_mod
from kyverno_tpu_torch.parallel import make_mesh, sharded_eval_fn
from kyverno_tpu_torch.parallel.mesh import shard_eval_fns
from tests.torch_parity import (  # noqa: F401
    both_sets,
    corpus_docs,
    corpus_resources,
    one_torch_thread,
)

# (corpus, resources): rows not a multiple of 32 nor of the mesh's 8
CASES = [("crosscheck", 37), ("library250", 45), ("anchor", 29)]


@pytest.fixture(scope="module", params=CASES, ids=[c for c, _ in CASES])
def case(request):
    corpus, n = request.param
    docs = corpus_docs(corpus)
    if corpus == "library250":
        docs = docs[:40]
    jset, tset = both_sets(docs)
    return corpus, jset, tset, corpus_resources(corpus, n)


def _port_blob(cps, resources, multiple):
    """The port's packed batch padded to ``multiple`` rows, as one blob
    on the CPU: (blob, (B, P, E, V), rows before padding)."""
    pb = cps.flatten_packed(resources)
    cells, bmeta, n = pad_packed(pb.cells, pb.bmeta, multiple)
    blob, shp = _assemble_blob(cells, bmeta, pb.str_bytes, pb.dictv)
    return torch.from_numpy(blob.view(np.int32)), shp, n


def _counts(plan, blob, shp, live):
    return ev.eval_rules_counts(plan, blob, *shp,
                                ev.match_matrix(plan, blob, *shp), live)


def _holds_1d_program(jset, tset, resources):
    """The port's sharded_eval_fn on 8 CPU devices against the JAX one on
    conftest's 8 virtual devices, on the same padded batch: verdicts and
    counts equal over the whole rule axis R, the counts form's over the
    first ``live`` columns. Returns (R, live)."""
    pb = jset.flatten_packed(resources)
    cells, bmeta, n = jax_pad_packed(pb.cells, pb.bmeta, 8)
    jv, jf, jp = jax_sharded_eval_fn(jset, jax_make_mesh())(
        cells, bmeta, pb.str_bytes, pb.dictv)
    tb = tset.flatten_packed(resources)
    tcells, tbmeta, tn = pad_packed(tb.cells, tb.bmeta, 8)
    assert tn == n and tcells.shape[0] == cells.shape[0] > n
    v, fails, passes = sharded_eval_fn(tset, make_mesh(["cpu"] * 8))(
        tcells, tbmeta, tb.str_bytes, tb.dictv)
    R, live = tset.plan.R, tset.tensors.n_rules_live
    assert fails.dtype == passes.dtype == torch.int32
    assert v.shape == (cells.shape[0], R) == np.asarray(jv).shape
    assert fails.shape == passes.shape == (R,) == np.asarray(jf).shape
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(fails.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(passes.numpy(), np.asarray(jp))
    blob, shp, _ = _port_blob(tset, resources, 8)
    lv, lf, lp = _counts(tset.plan, blob, shp, live)
    np.testing.assert_array_equal(lv[:, :live].numpy(), v[:, :live].numpy())
    np.testing.assert_array_equal(lf.numpy(), fails[:live].numpy())
    np.testing.assert_array_equal(lp.numpy(), passes[:live].numpy())
    assert int(fails.sum()) > 0 and int(passes.sum()) > 0
    return R, live


def test_counts_form_matches_jax_1d_program(case):
    """The 1D program over 8 devices: the port's verdicts and counts
    equal the JAX program's over the whole rule axis, and the counts
    form's over the live columns."""
    _, jset, tset, resources = case
    _holds_1d_program(jset, tset, resources)


def test_1d_program_over_an_incremental_sets_padded_rule_axis():
    """An incremental set's rule axis pads to its bucket (R > live): the
    1D program still gives the JAX one's whole arrays, the padded
    columns' verdicts and counts included."""
    docs = corpus_docs("crosscheck")
    jinc, tinc = JaxIncremental(), IncrementalCompiler(device="cpu")
    jp = [jax_load_policy(d) for d in docs]
    tp = [load_policy(d) for d in docs]
    jset, tset = jinc.refresh(jp), tinc.refresh(tp)
    R, live = _holds_1d_program(jset, tset,
                                corpus_resources("crosscheck", 37))
    assert R > live


def test_counts_form_matches_jax_2d_programs(case):
    """Each policy shard's program on a (2, 4) mesh: the shard's live
    rules are fewer than its rule bucket, and the counts cover only
    them."""
    _, jset, tset, resources = case
    jsps = jax_shard_policies(jset.policies, 2)
    sps = shard_policies(tset.policies, 2, device="cpu")
    pb = jsps.full.flatten_packed(resources)
    cells, bmeta, _ = jax_pad_packed(pb.cells, pb.bmeta, 4)
    want = {shard.index: fn(cells, bmeta, pb.str_bytes, pb.dictv)
            for shard, fn in jax_shard_eval_fns(
                jsps, jax_make_mesh(shape=(2, 4)))}
    blob, shp, _ = _port_blob(sps.full, resources, 4)
    sliced = 0
    for shard in sps.shards:
        plan, live = shard.cps.plan, shard.cps.tensors.n_rules_live
        sliced += live < plan.R
        v, fails, passes = _counts(plan, blob, shp, live)
        jv, jf, jp = (np.asarray(x) for x in want[shard.index])
        np.testing.assert_array_equal(v[:, :live].numpy(), jv)
        np.testing.assert_array_equal(fails.numpy(), jf)
        np.testing.assert_array_equal(passes.numpy(), jp)
    assert sliced, "no shard has fewer live rules than its bucket"


@pytest.mark.parametrize("B", [1, 31, 32, 33, 65, 70, 129])
@pytest.mark.parametrize("tile_words", [plan_mod.TILE_WORDS, 600])
def test_counts_form_equals_plain_pair(B, tile_words):
    """eval_rules_counts equals eval_rules_plain then rule_counts_plain
    over the live columns, for every live from 0 to R, with the plan in
    one rule tile and cut into several, and HOST cells among the
    verdicts."""
    _, tset = both_sets(corpus_docs("crosscheck"))
    plan = plan_mod.Plan(tset.tensors, "cpu", tile_words=tile_words)
    assert (plan.n_tiles > 2) == (tile_words == 600)
    blob, shp = tset.to_device(tset.flatten_packed(
        corpus_resources("crosscheck", B)))
    m = ev.match_matrix(plan, blob, *shp)
    want = ev.eval_rules_plain(plan, blob, *shp, m)
    assert (want == ev.V_HOST).any() or B < 33
    for live in sorted({0, 1, plan.R - 7, plan.R - 1, plan.R}):
        v, fails, passes = ev.eval_rules_counts(plan, blob, *shp, m, live)
        assert torch.equal(v, want)
        wf, wp = ev.rule_counts_plain(want[:, :live])
        assert torch.equal(fails, wf) and torch.equal(passes, wp)


def test_counts_form_refuses_live_outside_the_plan_and_other_devices():
    _, tset = both_sets(corpus_docs("crosscheck")[:4])
    blob, shp = tset.to_device(tset.flatten_packed(
        corpus_resources("crosscheck", 5)))
    plan = tset.plan
    m = ev.match_matrix(plan, blob, *shp)
    for live in (-1, plan.R + 1):
        with pytest.raises(ValueError, match="live"):
            ev.eval_rules_counts(plan, blob, *shp, m, live)
        with pytest.raises(ValueError, match="live"):
            ev.evaluate_live_counts(plan, blob, *shp, live)
    meta = torch.empty(blob.numel(), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ev.eval_rules_counts(plan, meta, *shp, m.to("meta"), plan.R)


@pytest.mark.parametrize("shape", [None, (2, 2)])
def test_row_program_runs_the_counts_form_once_a_shard(monkeypatch, shape):
    """On a mesh of four CPU devices, each data shard's program is one
    evaluate_live_counts: the matrix form and its separate counts are
    never called, and on the CPU nothing counts as a launch."""
    _, tset = both_sets(corpus_docs("crosscheck"))
    calls = []
    real = ev.evaluate_live_counts

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    def never(*args, **kw):
        raise AssertionError("K7's program ran the plain matrix form")

    monkeypatch.setattr(ev, "evaluate_live_counts", spy)
    monkeypatch.setattr(ev, "eval_rules", never)
    monkeypatch.setattr(ev, "evaluate_blob", never)
    mesh = make_mesh(["cpu"] * 4, shape=shape)
    if shape is None:
        sets = [tset]
        progs = [sharded_eval_fn(tset, mesh)]
    else:
        sps = shard_policies(tset.policies, 2, device="cpu")
        sets = [shard.cps for shard in sps.shards]
        progs = [fn for _, fn in shard_eval_fns(sps, mesh)]
        tset = sps.full
    pb = tset.flatten_packed(corpus_resources("crosscheck", 21))
    cells, bmeta, n = pad_packed(pb.cells, pb.bmeta, 2 if shape else 4)
    saved = dict(_build.LAUNCHES)
    try:
        _build.reset_launches()
        for cps, step in zip(sets, progs):
            v, fails, passes = step(cells, bmeta, pb.str_bytes, pb.dictv)
            live = cps.tensors.n_rules_live
            assert v.shape == (cells.shape[0], live)
            wf, wp = ev.rule_counts_plain(v)
            assert torch.equal(fails, wf) and torch.equal(passes, wp)
        assert set(_build.LAUNCHES.values()) == {0}
    finally:
        _build.LAUNCHES.update(saved)
    assert len(calls) == 4
    assert calls == [c.tensors.n_rules_live for c in sets
                     for _ in range(4 // len(sets))]
