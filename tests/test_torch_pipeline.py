"""``evaluate_pipelined``: the port's (on the CPU) equals the JAX
package's ``evaluate_pipelined`` and the port's own ``evaluate()``, at
``chunk=8`` (as the JAX package's differential fuzzer runs it), with the
pipeline switch on and off and the three ``KTPU_HOST_*`` switches off.
Also: the chunks' traces carry the pipeline's spans, only the calling
thread touches the device path, and a CPU run launches no kernel.
"""

import threading

import numpy as np
import pytest

from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu_torch.models import Verdict
from kyverno_tpu_torch.ops import _build
from kyverno_tpu_torch.runtime import hostlane, tracing
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse)
    UNKNOWN_KIND,
    both_sets,
    corpus_docs,
    corpus_resources,
)

HOST_SWITCHES = ("KTPU_HOST_PREFETCH", "KTPU_HOST_MEMO", "KTPU_HOST_FANOUT")
MODES = {
    "pipeline": {},
    "pipeline_off": {"KTPU_FLATTEN_PIPELINE": "0"},
    "host_off": {s: "0" for s in HOST_SWITCHES},
    "all_off": {"KTPU_FLATTEN_PIPELINE": "0", **{s: "0" for s in HOST_SWITCHES}},
}
# The anchor corpus's plain kernels are the heaviest on the CPU: it runs
# a batch of two chunks, in the two outer modes only.
CORPORA = {"library250": 24, "crosscheck": 16, "anchor": 15}
CASES = [(c, m) for c in ("library250", "crosscheck") for m in MODES] + [
    ("anchor", "pipeline"), ("anchor", "all_off")]
@pytest.fixture(scope="module")
def corpus_case():
    """(corpus, JAX set, port set, resources) of a corpus, built once."""
    built = {}

    def get(corpus: str):
        if corpus not in built:
            jset, tset = both_sets(corpus_docs(corpus))
            resources = corpus_resources(corpus, CORPORA[corpus]) + [UNKNOWN_KIND]
            built[corpus] = (corpus, jset, tset, resources)
        return built[corpus]

    return get


@pytest.fixture(params=["library250", "crosscheck"])
def case(request, corpus_case):
    return corpus_case(request.param)


@pytest.fixture(autouse=True)
def _fresh_memo():
    hostlane.host_cache().clear()
    jax_hostlane.host_cache().clear()
    yield


@pytest.mark.parametrize("corpus,mode", CASES, ids=[f"{c}-{m}" for c, m in CASES])
def test_pipelined_equals_jax_and_evaluate(corpus_case, corpus, mode, monkeypatch):
    _, jset, tset, resources = corpus_case(corpus)
    for name, value in MODES[mode].items():
        monkeypatch.setenv(name, value)
    got = tset.evaluate_pipelined(resources, chunk=8)
    want = jset.evaluate_pipelined(resources, chunk=8)
    whole = tset.evaluate(resources)
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]
    assert np.array_equal(got, whole)
    assert not (got == int(Verdict.HOST)).any()


def test_short_batches():
    jset, tset = both_sets(corpus_docs("library250"))
    res = corpus_resources("library250", 8)
    assert np.array_equal(tset.evaluate_pipelined(res, chunk=8),
                          jset.evaluate_pipelined(res, chunk=8))
    assert np.array_equal(tset.evaluate_pipelined(res[:3], chunk=8),
                          tset.evaluate(res[:3]))


def test_chunk_traces_carry_the_pipeline(case, monkeypatch):
    """Every chunk's trace holds its flatten (on the prefetch thread),
    its device dispatch, its host prefetch join (with the oracle seconds
    hidden in the device's shadow, ``overlap_us``) and its resolve."""
    corpus, _, tset, resources = case
    monkeypatch.setenv("KTPU_HOST_MEMO", "0")
    rec = tracing.recorder()
    rec.clear()
    got = tset.evaluate_pipelined(resources, chunk=8)
    n_chunks = -(-len(resources) // 8)
    traces = [t for t in rec.traces(256) if t.kind == "scan_chunk"]
    assert len(traces) == n_chunks
    assert sorted(int(t.labels["lo"]) for t in traces) == list(
        range(0, len(resources), 8))
    for t in traces:
        names = t.stage_names()
        assert {"flatten", "device_dispatch", "host_resolve"} <= names
        flat = [s for s in t.spans if s.name == "flatten"]
        assert flat[0].tid.startswith("ktpu-prefetch")
    joins = [s for t in traces for s in t.spans if s.name == "host_join"]
    if tset.tensors.rule_host_only.any():
        assert joins and all(int(s.labels["overlap_us"]) >= 0 for s in joins)
        assert sum(int(s.labels["applied"]) for s in joins) > 0
    assert not (got == int(Verdict.HOST)).any()


def test_trace_kill_switch(monkeypatch):
    _, tset = both_sets(corpus_docs("library250"))
    res = corpus_resources("library250", 24)
    rec = tracing.recorder()
    rec.clear()
    monkeypatch.setenv("KTPU_TRACE", "0")
    off = tset.evaluate_pipelined(res, chunk=8)
    assert rec.traces(256) == []
    monkeypatch.setenv("KTPU_TRACE", "1")
    assert np.array_equal(off, tset.evaluate_pipelined(res, chunk=8))
    assert len(rec.traces(256)) == 3


def test_only_the_calling_thread_touches_the_device(monkeypatch):
    _, tset = both_sets(corpus_docs("library250"))
    res = corpus_resources("library250", 40)
    seen = set()
    real = tset.to_device

    def to_device(*a, **kw):
        seen.add(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(tset, "to_device", to_device)
    _build.reset_launches()
    tset.evaluate_pipelined(res, chunk=8)
    assert seen == {threading.current_thread().name}
    assert all(n == 0 for n in _build.LAUNCHES.values())
