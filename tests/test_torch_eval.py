"""K2-K5 parity: the port's int8 verdict matrices and scan counts (plain
versions on the CPU) equal the JAX package's, exactly — once with the
compiled tensors carried across by ``convert.py`` (kernel parity alone)
and once from the port's own compile (the slice). Covers the cross-check
corpora (gate and condition rows), a deny-only set (no check rows) and
difffuzz seeds. Also pins the plan's layout to ``csrc/plan.cuh``."""

import os
import re

import numpy as np
import pytest
import torch

from kyverno_tpu_torch import convert
from kyverno_tpu_torch.models import CompiledPolicySet as TorchPolicySet
from kyverno_tpu_torch.ops import eval as ev
from kyverno_tpu_torch.ops import plan as plan_mod
from tests.torch_parity import (
    both_sets,
    corpus_docs,
    corpus_resources,
    jax_blob,
    jax_scan,
    jax_verdicts,
    tensor_fields,
)

CASES = [("crosscheck", 96), ("deny_only", 48), ("fuzz3", 64), ("fuzz41", 64)]


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


def test_scan_counts(case):
    _, jset, tset, resources, _ = case
    want = jax_scan(jset, resources)
    got = tset.scan_counts(tset.flatten(resources))
    for name, w, g in zip(("fails", "passes", "host_rows"), want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g), name


def test_stage_outputs_consistent(case):
    """The K2+K3 flags and the K4 verdicts compose to the one-call
    pipeline, and the async handle gives the same matrix."""
    _, _, tset, resources, want = case
    batch = tset.flatten(resources)
    blob, shp = tset.to_device(batch)
    m = ev.match_matrix(tset.plan, blob, *shp)
    k3 = ev.eval_checks(tset.plan, blob, *shp, m)
    assert k3[0].shape == (shp[0], tset.plan.C) and k3[0].dtype == torch.uint8
    assert k3[1].shape == (shp[0], tset.plan.NCOND, 3)
    assert k3[2].shape == (shp[0], tset.plan.X)
    v = ev.eval_verdict(tset.plan, blob, *shp, *k3)
    assert np.array_equal(v.numpy()[:, :tset.tensors.n_rules_live], want)
    handle = tset.evaluate_device_async(batch)
    assert np.array_equal(handle.get(), want)


def _first_diff(got, want):
    d = np.argwhere(got != want)
    if not d.size:
        return "equal"
    b, r = d[0]
    return f"{len(d)} cells differ; first (b={b}, r={r}): jax {want[b, r]} port {got[b, r]}"


def test_plan_constants_match_header():
    """Every enum the kernels read from csrc/plan.cuh has the value the
    plan builder writes."""
    path = os.path.join(os.path.dirname(plan_mod.__file__), "..", "csrc",
                        "plan.cuh")
    text = open(path).read()
    pairs = dict((k, int(v)) for k, v in re.findall(r"\b([HC][K_]?\w*|AX_\w+|"
                                                   r"RF_\w+|AG_\w+|CF_\w+|XF_\w+)"
                                                   r"\s*=\s*(\d+)", text))
    shifts = dict((k, 1 << int(v)) for k, v in
                  re.findall(r"\b(RF_\w+)\s*=\s*1\s*<<\s*(\d+)", text))
    pairs.update(shifts)
    checked = 0
    for name, value in pairs.items():
        if hasattr(plan_mod, name):
            assert getattr(plan_mod, name) == value, name
            checked += 1
    assert checked >= 70


@pytest.mark.parametrize("corpus", ["crosscheck", "library250"])
def test_plan_csr_walks_cover_segments(corpus):
    """Walking the plan's CSR lists reaches exactly the rows the JAX
    program's segment ids assign to each rule."""
    _, tset = both_sets(corpus_docs(corpus))
    t, buf = tset.tensors, tset.plan.buf_np

    def lst(hp, hi, i):
        p = buf[buf[hp]:]
        return buf[buf[hi] + p[i]: buf[hi] + p[i + 1]]

    for r in range(t.n_rules):
        rows = [int(c) for a in lst(plan_mod.H_RULE_PTR, plan_mod.H_RULE_ALT, r)
                for g in lst(plan_mod.H_ALT_PTR, plan_mod.H_ALT_GRP, a)
                for c in lst(plan_mod.H_GRP_PTR, plan_mod.H_GRP_ROW, g)]
        assert sorted(rows) == np.nonzero(t.chk_rule == r)[0].tolist()
        aux = [int(x) for g in lst(plan_mod.H_RAXG_PTR, plan_mod.H_RAXG_GRP, r)
               for x in lst(plan_mod.H_AXG_PTR, plan_mod.H_AXG_ROW, g)]
        assert sorted(aux) == np.nonzero(t.ax_rule == r)[0].tolist()
    chk = buf[buf[plan_mod.H_CHK]:][:t.chk_op.size * plan_mod.CK_NCOLS]
    chk = chk.reshape(-1, plan_mod.CK_NCOLS)
    assert np.array_equal(chk[:, plan_mod.CK_PATH], t.chk_path)
    assert np.array_equal(chk[:, plan_mod.CK_OP], t.chk_op)


def test_blob_shape_checked():
    jset, tset = both_sets(corpus_docs("deny_only"))
    blob, (B, P, E, V) = jax_blob(jset, corpus_resources("deny_only", 4))
    with pytest.raises(ValueError, match="too short"):
        ev.evaluate_blob(tset.plan, torch.from_numpy(blob.view(np.int32)),
                         B, P, E, V + 1000)
