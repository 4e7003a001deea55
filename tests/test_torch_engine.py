"""The slice as a whole: policy documents -> the port's compile -> flatten
-> device verdicts and scan counts, at the 250-policy library's full width
(512 mixed resources here; the card runs 10k in chip_smoke.py), equal to
the JAX package's. Also: the entry points run on CUDA unless the CPU is
asked for by name."""

import numpy as np
import pytest
import torch

from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.models import CompiledPolicySet, Verdict
from kyverno_tpu_torch.models.engine import resolve_device
from kyverno_tpu_torch.ops import _build
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse)
    both_sets,
    corpus_docs,
    corpus_resources,
    jax_scan,
    jax_verdicts,
)


@pytest.fixture(scope="module")
def library():
    jset, tset = both_sets(corpus_docs("library250"))
    resources = corpus_resources("library250", 512)
    return jset, tset, resources


def test_library_verdicts_equal(library):
    jset, tset, resources = library
    want = jax_verdicts(jset, resources)
    got = tset.evaluate_device(tset.flatten(resources))
    assert got.shape == (512, 250) and got.dtype == np.int8
    assert np.array_equal(got, want)
    hist = np.bincount(got.ravel().astype(np.int64), minlength=6)
    assert hist[Verdict.PASS] and hist[Verdict.FAIL] and hist[Verdict.HOST]


def test_library_scan_counts_equal(library):
    jset, tset, resources = library
    want = jax_scan(jset, resources)
    got = tset.scan_counts(tset.flatten(resources))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)


def test_cpu_run_launches_no_kernel(library):
    _, tset, resources = library
    _build.reset_launches()
    tset.evaluate_device(tset.flatten(resources[:8]))
    assert all(n == 0 for n in _build.LAUNCHES.values())


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    doc = corpus_docs("library250")[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledPolicySet([load_policy(doc)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_empty_batch_and_empty_policy_set():
    doc = corpus_docs("library250")[0]
    cps = CompiledPolicySet([load_policy(doc)], device="cpu")
    v = cps.evaluate_device(cps.flatten([]))
    assert v.shape == (0, 1)
    empty = CompiledPolicySet([], device="cpu")
    v = empty.evaluate_device(empty.flatten(corpus_resources("library250", 3)))
    assert v.shape == (3, 0)
