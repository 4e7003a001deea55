"""The batched mutate tier on both packages: ``BatchMutator.apply`` of the
port (its gate on the CPU, ``device="cpu"``: flatten -> K1 -> eval_rules
as their plain versions -> the host lane) against the JAX package's and
against the port's serial ``mutate()`` chain, patch bytes (``json.dumps``)
and patched resources equal, under ``use_device_gate=False`` and
``True``; the gate matrix of ``gate_verdicts`` equal to the JAX one's.

The cases are tests/unit/test_batch_mutate.py's, with its reference
corpus replaced by inline policies (bench.py's two config-4 policies) and
the file's own ``pod()`` corpus. Then the port's error contract: a
failure of any step of the device gate raises through ``apply`` and the
lane router, and the one use of the host gate in its place, an ERROR
cell, is counted in ``GATE_FALLBACKS``. Lanes are always passed explicitly or the router's
clock is a stand-in; no case reads a wall clock.
"""

import json
import random
from types import SimpleNamespace

import numpy as np
import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.engine.context import Context as JaxContext
from kyverno_tpu.engine.mutate import batch as jax_batch
from kyverno_tpu.engine.mutate.json_patch import (
    filter_and_sort_patches as jax_filter_and_sort,
)
from kyverno_tpu.engine.mutation import mutate as jax_mutate
from kyverno_tpu.engine.policy_context import PolicyContext as JaxPolicyContext
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.engine.context import Context
from kyverno_tpu_torch.engine.mutate import batch
from kyverno_tpu_torch.engine.mutate.batch import (
    GATE_FALLBACKS,
    BatchMutator,
    fast_strategic_merge,
    merge_emit,
)
from kyverno_tpu_torch.engine.mutate.json_patch import (
    filter_and_sort_patches,
    generate_patches,
)
from kyverno_tpu_torch.engine.mutate.strategic_merge import (
    _has_anchor,
    _has_anchors,
    merge,
    strategic_merge_patch,
)
from kyverno_tpu_torch.engine.mutation import mutate
from kyverno_tpu_torch.engine.policy_context import PolicyContext
from kyverno_tpu_torch.models import Verdict
from kyverno_tpu_torch.utils.jsoncopy import json_copy
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

JAX = SimpleNamespace(load=jax_load_policy, Context=JaxContext,
                      PolicyContext=JaxPolicyContext, mutate=jax_mutate)
PORT = SimpleNamespace(load=load_policy, Context=Context,
                       PolicyContext=PolicyContext, mutate=mutate)


def serial_chain(pkg, policies, doc):
    """The webhook's serial chain: per policy, engine mutate; the patched
    resource feeds the next policy."""
    resource = doc
    patches = []
    for policy in policies:
        jctx = pkg.Context()
        jctx.add_resource(resource)
        resp = pkg.mutate(pkg.PolicyContext(policy=policy, new_resource=resource,
                                            json_context=jctx))
        patches.extend(resp.patches)
        if resp.patched_resource is not None:
            resource = resp.patched_resource
    return patches, resource


def same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert json.dumps(g.patches) == json.dumps(w.patches)
        assert g.patched_resource == w.patched_resource


def mutators(docs, min_gate_batch=64):
    """(the port's BatchMutator on the CPU, the JAX package's) over the
    same policy documents."""
    return (BatchMutator([load_policy(json_copy(d)) for d in docs],
                         min_gate_batch=min_gate_batch, device="cpu"),
            jax_batch.BatchMutator([jax_load_policy(json_copy(d)) for d in docs],
                                   min_gate_batch=min_gate_batch))


def assert_parity(policy_docs, docs, lanes=(False, True)):
    """Every lane of the port's apply equal to the JAX package's on the
    same lane and to the port's serial chain; the two gate matrices
    equal. Returns (port mutator, {lane: results})."""
    tbm, jbm = mutators(policy_docs)
    out = {}
    for lane in lanes:
        got = tbm.apply(docs, use_device_gate=lane)
        same_results(got, jbm.apply(docs, use_device_gate=lane))
        for doc, g in zip(docs, got):
            want_patches, want_resource = serial_chain(PORT, tbm.policies, doc)
            assert json.dumps(g.patches) == json.dumps(want_patches), doc
            assert g.patched_resource == want_resource
        out[lane] = got
    tg = tbm.gate_verdicts(docs)
    if tg is not None:
        jg = jbm.gate_verdicts(docs)
        assert tg.dtype == jg.dtype and np.array_equal(tg, jg)
    return tbm, out


def pod(i, kind="Pod", labels=None):
    doc = {"apiVersion": "v1", "kind": kind,
           "metadata": {"name": f"r-{i}", "namespace": "default"},
           "spec": {"containers": [{"name": "c", "image": f"img:{i}"}]}}
    if labels:
        doc["metadata"]["labels"] = labels
    return doc


# bench.py's config-4 policies, inline (bench.py:974-984, :1018-1028)
ADD_DEFAULT_LABELS = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "add-default-labels"},
    "spec": {"rules": [{
        "name": "add-labels",
        "match": {"resources": {"kinds": ["Pod", "Service", "Namespace"]}},
        "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
            "+(app.kubernetes.io/managed-by)": "kyverno"}}}},
    }]},
}
ANNOTATE_BENCH_APPS = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "annotate-bench-apps"},
    "spec": {"rules": [{
        "name": "annotate",
        "match": {"resources": {"kinds": ["Pod"], "selector": {
            "matchLabels": {"app.kubernetes.io/name": "bench"}}}},
        "mutate": {"patchStrategicMerge": {
            "metadata": {"annotations": {"+(bench/tier)": "gated"}}}},
    }]},
}
BENCH = {"app.kubernetes.io/name": "bench"}


# ------------------------------------------------------- inline corpus

def test_add_default_labels_mixed_kinds():
    docs = [pod(0), pod(1, kind="Service"), pod(2, kind="Namespace"),
            pod(3, kind="Deployment"),
            pod(4, labels={"custom-foo-label": "already-set"}),
            pod(5, labels={"app.kubernetes.io/managed-by": "me"})]
    tbm, out = assert_parity([ADD_DEFAULT_LABELS], docs)
    assert tbm._gate_trivial
    assert [bool(r.patches) for r in out[True]] == [True] * 3 + [False, True,
                                                                 False]


def test_selector_gate_over_mixed_kinds():
    docs = [pod(0, labels=BENCH), pod(1), pod(2, kind="Service", labels=BENCH),
            pod(3, labels={"app.kubernetes.io/name": "other"}),
            pod(4, labels=dict(BENCH, tier="x")), pod(5, kind="Deployment")]
    tbm, out = assert_parity([ANNOTATE_BENCH_APPS], docs)
    assert not tbm._gate_trivial
    assert [bool(r.patches) for r in out[True]] == [
        True, False, False, False, True, False]


def test_both_inline_policies_chained():
    docs = ([pod(i) for i in range(4)]
            + [pod(i, labels=BENCH) for i in range(4, 8)]
            + [pod(8, kind="Namespace", labels=BENCH)])
    _, out = assert_parity([ADD_DEFAULT_LABELS, ANNOTATE_BENCH_APPS], docs)
    assert sum(bool(r.patches) for r in out[True]) == 9


def test_gate_skips_unmatched_kinds():
    tbm, _ = mutators([ADD_DEFAULT_LABELS])
    docs = [pod(i, kind="Secret") for i in range(4)]
    for r in tbm.apply(docs, use_device_gate=True):
        assert r.patches == []
    assert not tbm.gate_verdicts(docs).any()


# ------------------------------------------------------------- chaining

STEP_POLICIES = [
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "step1"},
     "spec": {"rules": [{
         "name": "tag", "match": {"resources": {"kinds": ["Pod"]}},
         "mutate": {"patchStrategicMerge": {
             "metadata": {"labels": {"stage": "tagged"}}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "step2"},
     "spec": {"rules": [{
         "name": "after-tag",
         # matches only what rule 1 just labelled: the tier re-gates on
         # the patched document, not the original
         "match": {"resources": {"kinds": ["Pod"], "selector": {
             "matchLabels": {"stage": "tagged"}}}},
         "mutate": {"patchStrategicMerge": {
             "metadata": {"annotations": {"+(chained)": "yes"}}}}}]}},
]


def test_patch_enables_later_rule():
    _, out = assert_parity(STEP_POLICIES, [pod(i) for i in range(4)])
    got = out[True][0].patched_resource["metadata"]
    assert got["labels"]["stage"] == "tagged"
    assert got["annotations"]["chained"] == "yes"


# ----------------------------------------------------------- mixed plan

MIXED = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "mixed"},
    "spec": {"rules": [
        {"name": "static", "match": {"resources": {"kinds": ["Pod"]}},
         "mutate": {"patchStrategicMerge": {"metadata": {"labels": {"s": "1"}}}}},
        {"name": "vars", "match": {"resources": {"kinds": ["Pod"]}},
         "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
             "n": "{{request.object.metadata.name}}"}}}}},
    ]},
}
FAST = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "fast"},
    "spec": {"rules": [{
        "name": "r", "match": {"resources": {"kinds": ["Pod"]}},
        "mutate": {"patchStrategicMerge": {"metadata": {"labels": {"f": "1"}}}}}]},
}
KIND_ONLY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "kind-only"},
    "spec": {"rules": [{
        "name": "r", "match": {"resources": {"kinds": ["Pod"]}},
        "mutate": {"patchStrategicMerge": {"metadata": {"labels": {"k": "1"}}}}}]},
}


def test_engine_fallback_policy_does_not_shift_gate_columns():
    tbm, _ = assert_parity([MIXED, FAST], [pod(i) for i in range(4)])
    modes = [(p.name, mode) for p, mode, _ in tbm.plan]
    assert ("mixed", "engine") in modes and ("fast", "fast") in modes
    (_, _, fast_rules), = [t for t in tbm.plan if t[0].name == "fast"]
    assert fast_rules[0].gate_index == 0


def test_kind_only_gate_compiles_on_device():
    tbm, jbm = mutators([KIND_ONLY])
    docs = [pod(0), pod(1, kind="Secret")]
    verdicts = tbm.gate_verdicts(docs)
    assert verdicts is not None, "the gate must not degrade to the host"
    assert verdicts[0, 0] == Verdict.PASS and verdicts[1, 0] == 0
    assert np.array_equal(verdicts, jbm.gate_verdicts(docs))


def test_chunks_give_one_matrix(monkeypatch):
    """gate_verdicts in chunks of 4: one device evaluation a chunk, each
    chunk padded to its shape bucket, and the same matrix as one chunk."""
    tbm, jbm = mutators([ANNOTATE_BENCH_APPS, ADD_DEFAULT_LABELS])
    docs = [pod(i, labels=BENCH if i % 3 else None) for i in range(10)]
    whole = tbm.gate_verdicts(docs)
    shapes = []
    real = tbm._gate_cps.evaluate_device

    def spy(b):
        shapes.append(b.n)
        return real(b)

    monkeypatch.setattr(tbm._gate_cps, "evaluate_device", spy)
    assert np.array_equal(tbm.gate_verdicts(docs, chunk=4), whole)
    assert shapes == [4, 4, 2]
    assert np.array_equal(whole, jbm.gate_verdicts(docs))


# ------------------------------------------------- merge emit property

KEYS = ["alpha", "beta", "labels", "mode", "name"]
VALS = ["on", "off", "3", "250m", "", True, 7, None]


def rand_tree(rng, depth=0):
    r = rng.random()
    if depth >= 3 or r < 0.4:
        return rng.choice(VALS)
    if r < 0.55:
        return [rand_tree(rng, depth + 2) for _ in range(rng.randint(0, 3))]
    return {rng.choice(KEYS): rand_tree(rng, depth + 1)
            for _ in range(rng.randint(0, 3))}


def rand_overlay(rng, depth=0):
    """Overlay grammar: maps with plain, +(add) and (condition) keys,
    keyed and plain lists, scalars."""
    r = rng.random()
    if depth >= 3 or r < 0.35:
        return rng.choice(VALS)
    if r < 0.5:
        els = []
        for _ in range(rng.randint(1, 2)):
            el = {"name": rng.choice(["a", "b", "c"])}
            el[rng.choice(KEYS[:4])] = rand_overlay(rng, depth + 2)
            els.append(el)
        return els
    out = {}
    for key in rng.sample(KEYS[:4], rng.randint(1, 3)):
        kind = rng.random()
        if kind < 0.25:
            out[f"+({key})"] = rand_overlay(rng, depth + 1)
        elif kind < 0.45:
            out[f"({key})"] = rng.choice(["on", "off", "3", "?*"])
        else:
            out[key] = rand_overlay(rng, depth + 1)
    return out


def test_merge_emit_matches_merge_plus_diff():
    rng = random.Random(2024)
    seen = 0
    for _ in range(400):
        base = rand_tree(rng)
        patch = rand_overlay(rng)
        if not isinstance(base, dict) or not isinstance(patch, dict):
            continue
        # strip anchors for the raw-merge comparison
        patch = json.loads(json.dumps(patch).replace("+(", "").replace(
            ")\":", "\":").replace("(", "").replace(")", ""))
        want_merged = merge(patch, base)
        want_ops = generate_patches(base, want_merged)
        ops, jops = [], []
        got_merged = merge_emit(patch, json_copy(base), "", ops)
        assert got_merged == want_merged, (base, patch)
        assert json.dumps(filter_and_sort_patches(ops)) == json.dumps(
            want_ops), (base, patch, ops, want_ops)
        assert jax_batch.merge_emit(patch, json_copy(base), "", jops) == \
            got_merged
        assert json.dumps(jax_filter_and_sort(jops)) == json.dumps(
            filter_and_sort_patches(ops))
        seen += 1
    assert seen > 50


def test_fast_strategic_merge_matches_engine_pipeline():
    rng = random.Random(777)
    seen = 0
    for _ in range(400):
        base = rand_tree(rng)
        overlay = rand_overlay(rng)
        if not isinstance(base, dict) or not isinstance(overlay, dict):
            continue
        try:
            want_patched = strategic_merge_patch(base, overlay)
        except Exception:
            continue
        want_ops = generate_patches(base, want_patched)
        anchors = _has_anchors(overlay, _has_anchor)
        got_patched, got_ops = fast_strategic_merge(json_copy(base), overlay,
                                                    anchors)
        assert json.dumps(got_ops) == json.dumps(want_ops), (base, overlay)
        assert got_patched == want_patched, (base, overlay)
        jp, jops = jax_batch.fast_strategic_merge(json_copy(base), overlay,
                                                  anchors)
        assert json.dumps(jops) == json.dumps(got_ops) and jp == got_patched
        seen += 1
    assert seen > 50


def test_fuzzed_policies_full_parity():
    """Seeded overlays as ConfigMap policies: the port's host and device
    lanes equal the JAX package's host lane and the port's serial chain
    (the JAX package holds its device lane to its host lane itself)."""
    rng = random.Random(4242)
    seen = 0
    for i in range(40):
        overlay = rand_overlay(rng)
        if not isinstance(overlay, dict) or not overlay:
            continue
        doc = {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
               "metadata": {"name": f"fz-{i}"},
               "spec": {"rules": [{
                   "name": f"fz-{i}-r",
                   "match": {"resources": {"kinds": ["ConfigMap"]}},
                   "mutate": {"patchStrategicMerge": {"data": overlay}}}]}}
        docs = []
        for j in range(5):
            t = rand_tree(rng)
            docs.append({"apiVersion": "v1", "kind": "ConfigMap",
                         "metadata": {"name": f"cm-{j}"},
                         "data": t if isinstance(t, dict) else {"k": t}})
        tbm, jbm = mutators([doc])
        want = jbm.apply(docs, use_device_gate=False)
        for lane in (False, True):
            got = tbm.apply(docs, use_device_gate=lane)
            same_results(got, want)
        for d, g in zip(docs, got):
            sp, sr = serial_chain(PORT, tbm.policies, d)
            assert json.dumps(g.patches) == json.dumps(sp)
            assert g.patched_resource == sr
        seen += 1
    assert seen > 10


# ------------------------------------------------------- error contract

@pytest.fixture
def fallbacks():
    """GATE_FALLBACKS zeroed for the case, and restored after it."""
    saved = dict(GATE_FALLBACKS)
    batch.reset_gate_fallbacks()
    yield GATE_FALLBACKS
    GATE_FALLBACKS.update(saved)


def _selector_docs():
    return [pod(i, labels=BENCH if i % 2 else None) for i in range(6)]


class KernelFault(RuntimeError):
    pass


def _fault(*a, **kw):
    raise KernelFault("launch failed")


def test_device_fault_propagates_through_apply(fallbacks, monkeypatch):
    """A failure of the device evaluation (a build, a launch, a copy)
    raises out of apply's device lane; nothing is counted and nothing
    falls back to the host gate."""
    tbm, _ = mutators([ANNOTATE_BENCH_APPS])
    monkeypatch.setattr(tbm._gate_cps, "evaluate_device", _fault)
    with pytest.raises(KernelFault):
        tbm.apply(_selector_docs(), use_device_gate=True)
    with pytest.raises(KernelFault):
        tbm.gate_verdicts(_selector_docs())
    assert tbm.apply(_selector_docs(), use_device_gate=False)
    assert set(fallbacks.values()) == {0}


def test_device_fault_propagates_through_the_lane_router(fallbacks,
                                                         monkeypatch):
    tbm, _ = mutators([ANNOTATE_BENCH_APPS], min_gate_batch=4)
    monkeypatch.setattr(tbm._gate_cps, "evaluate_device", _fault)
    with pytest.raises(KernelFault):
        tbm.apply(_selector_docs())
    assert tbm._gate_choice is None and set(fallbacks.values()) == {0}


@pytest.mark.parametrize("step", ["flatten", "resolve"])
def test_host_side_gate_fault_propagates(fallbacks, monkeypatch, step):
    """A host-side step of the device gate (the flatten, the resolve of
    the HOST cells) that raises propagates too, through gate_verdicts,
    apply's device lane and the router; the JAX package returns None there
    and gates on the host (a deliberate difference). Nothing is counted,
    and the host lane still gives the JAX package's results."""
    tbm, jbm = mutators([ANNOTATE_BENCH_APPS], min_gate_batch=4)
    docs = _selector_docs()
    name = "flatten_packed" if step == "flatten" else "resolve_host_cells"
    monkeypatch.setattr(tbm._gate_cps, name, _fault)
    monkeypatch.setattr(jbm._gate_cps, name, _fault)
    assert jbm.gate_verdicts(docs) is None
    with pytest.raises(KernelFault):
        tbm.gate_verdicts(docs)
    with pytest.raises(KernelFault):
        tbm.apply(docs, use_device_gate=True)
    with pytest.raises(KernelFault):
        tbm.apply(docs)
    assert tbm._gate_choice is None and set(fallbacks.values()) == {0}
    same_results(tbm.apply(docs, use_device_gate=False),
                 jbm.apply(docs, use_device_gate=True))


def test_error_cell_is_gated_on_the_host_and_counted(fallbacks, monkeypatch):
    """A gate cell that is neither PASS nor SKIP / NOT_APPLICABLE sends
    that one rule of that document to the host gate, counted a cell."""
    tbm, _ = mutators([ANNOTATE_BENCH_APPS])
    docs = _selector_docs()
    gate = tbm.gate_verdicts(docs)
    gate[1, 0] = gate[2, 0] = Verdict.ERROR
    monkeypatch.setattr(tbm, "gate_verdicts", lambda rs: gate)
    got = tbm.apply(docs, use_device_gate=True)
    same_results(got, tbm.apply(docs, use_device_gate=False))
    assert fallbacks == {"cell": 2}


def test_lane_router_follows_its_clock(monkeypatch):
    """The router's choice from a stand-in clock (device time, then host
    time of the sample): the device lane only when its time is less; a
    kind-only gate and a batch under min_gate_batch go to the host
    without timing. The choice is made once and kept."""
    docs = _selector_docs()
    for dev_s, host_s, want in ((1.0, 2.0, True), (2.0, 1.0, False)):
        tbm, _ = mutators([ANNOTATE_BENCH_APPS], min_gate_batch=4)
        ticks = iter([0.0, dev_s, 0.0, host_s])
        monkeypatch.setattr(batch, "time",
                            SimpleNamespace(monotonic=lambda: next(ticks)))
        assert tbm._auto_gate(docs) is want
        assert tbm._auto_gate(docs) is want          # kept, not re-timed
        same_results(tbm.apply(docs), tbm.apply(docs, use_device_gate=False))
    trivial, _ = mutators([KIND_ONLY], min_gate_batch=4)
    assert trivial._auto_gate(docs) is False
    small, _ = mutators([ANNOTATE_BENCH_APPS], min_gate_batch=64)
    assert small._auto_gate(docs) is False
    assert trivial._gate_choice is None and small._gate_choice is None
