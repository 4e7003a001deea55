"""The port's public names that close its API against the JAX package's:
``models.compile_policies``, ``featureplane.declared`` and
``raw(name, default)``, and the admission batcher's
``stats["mesh_shape"]``, each held to its counterpart on the CPU.
"""

import copy
import threading

import numpy as np
import pytest

from kyverno_tpu import models as jax_models
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.runtime import batch as jax_batch
from kyverno_tpu.runtime import featureplane as jax_featureplane
from kyverno_tpu.runtime.policycache import PolicyCache as JaxPolicyCache
from kyverno_tpu_torch import models
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.models import engine
from kyverno_tpu_torch.runtime import batch, featureplane
from kyverno_tpu_torch.runtime.policycache import PolicyCache
from tests.torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    corpus_docs,
    corpus_resources,
    one_torch_thread,
)

# switches of the JAX package that the port leaves out on purpose: its
# compile cache (the kernels' cache is build/torch_kernels/, with no
# switch) and bench.py's config filter (bench.py imports the JAX package)
NOT_PORTED = ("KTPU_BENCH_CONFIGS", "KTPU_COMPILE_CACHE",
              "KTPU_COMPILE_CACHE_DIR")


@pytest.mark.parametrize("corpus", ["crosscheck", "anchor"])
def test_compile_policies_matches_jax(corpus):
    docs = corpus_docs(corpus)
    jset = jax_models.compile_policies(
        [jax_load_policy(copy.deepcopy(d)) for d in docs])
    tset = models.compile_policies(
        [load_policy(copy.deepcopy(d)) for d in docs], device="cpu")
    assert type(tset) is engine.CompiledPolicySet
    assert tset.device.type == "cpu"
    assert ([(r.policy.name, r.rule.name) for r in tset.rule_refs]
            == [(r.policy.name, r.rule.name) for r in jset.rule_refs])
    resources = corpus_resources(corpus, 40)
    got, want = tset.evaluate(resources), jset.evaluate(resources)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]


def test_compile_policies_is_exported_lazily():
    assert "compile_policies" in models.__all__
    assert models.compile_policies is engine.compile_policies
    assert "compile_policies" in jax_models.__all__


@pytest.mark.parametrize("name", sorted(jax_featureplane.REGISTRY)
                         + ["KTPU_NOT_A_SWITCH"])
def test_declared_matches_jax(name):
    want = jax_featureplane.declared(name)
    got = featureplane.declared(name)
    if want is None or name in NOT_PORTED:
        assert got is None
        return
    # the docs name the port's own mechanisms; the name and the default
    # are the contract
    assert (got.name, got.default) == (want.name, want.default)
    assert got is featureplane.REGISTRY[name]


@pytest.mark.parametrize("env", [None, "", "2x4"])
@pytest.mark.parametrize("default", [None, "fallback"])
def test_raw_with_a_default_matches_jax(monkeypatch, env, default):
    name = "KTPU_MESH_SHAPE"
    if env is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, env)
    want = jax_featureplane.raw(name, default)
    assert featureplane.raw(name, default) == want
    assert featureplane.raw(name, default=default) == want
    if default is None:
        assert featureplane.raw(name) == want


def test_raw_of_an_undeclared_switch_raises_on_both():
    for fp in (jax_featureplane, featureplane):
        with pytest.raises(KeyError, match="undeclared feature switch"):
            fp.raw("KTPU_NOT_A_SWITCH", "x")


@pytest.mark.parametrize("spec", [None, "", "1", "1d", "1D", " 2x4 ",
                                  "4,1", "(2, 4)"])
def test_mesh_selection_matches_jax(monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv("KTPU_MESH_SHAPE", raising=False)
    else:
        monkeypatch.setenv("KTPU_MESH_SHAPE", spec)
    assert (batch.AdmissionBatcher._mesh_selection()
            == jax_batch.AdmissionBatcher._mesh_selection())


def _stop(b):
    b.stop()
    b._worker.join()
    for t in threading.enumerate():
        if t.name == "adm-rewarm":
            t.join()
    b._flush_pool.shutdown(wait=True)


@pytest.mark.parametrize("spec", [None, "2x4"])
def test_batcher_stats_report_the_mesh_shape(monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv("KTPU_MESH_SHAPE", raising=False)
    else:
        monkeypatch.setenv("KTPU_MESH_SHAPE", spec)
    jb = jax_batch.AdmissionBatcher(JaxPolicyCache())
    try:
        tb = batch.AdmissionBatcher(PolicyCache(device="cpu"))
        try:
            assert tb.stats["mesh_shape"] == jb.stats["mesh_shape"]
            assert tb.stats["mesh_shape"] == (spec or "1d")
        finally:
            _stop(tb)
    finally:
        _stop(jb)
