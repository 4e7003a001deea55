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


def test_plain_dispatch_args_are_the_wrappers(library, monkeypatch):
    """The plain route's one call (``ops/eval.py::blob_launch_args``)
    passes K1's and eval_rules' entries what their wrappers pass: the
    plan's tables and tile table, the blob's string bytes and length
    column (5 words a string) at the wrappers' views, K1's matrix and
    the verdicts at the given addresses."""
    from kyverno_tpu_torch.ops import eval as ev

    _, tset, resources = library
    monkeypatch.setattr(_build, "address", lambda name, entry, n: {
        "glob_nfa": 11, "eval_rules": 12}[name])
    blob, shp = tset.to_device(tset.flatten_packed(resources[:16]))
    B, P, E, V = shp
    _, _, dictv, str_bytes = ev.blob_parts(blob, *shp)
    plan, g = tset.plan, tset.plan.glob
    calls = ev.blob_launch_args(plan, blob.data_ptr(), *shp, 1 << 20,
                                2 << 20, 77)
    assert [(k, e) for k, e, _ in calls] == [("glob_nfa", 11),
                                            ("eval_rules", 12)]
    (_, _, gargs), (_, _, rargs) = calls
    assert gargs.dtype == rargs.dtype == np.int64
    assert gargs.tolist() == [
        g.consume.data_ptr(), g.star.data_ptr(), g.full.data_ptr(),
        g.acc.data_ptr(), *plan.nfa_char.shape, str_bytes.data_ptr(),
        dictv[:, 4].data_ptr(), dictv[:, 4].stride(0), V, 1 << 20, 77]
    assert rargs.tolist() == [
        plan.buf.data_ptr(), blob.data_ptr(), B, P, E, V, 1 << 20,
        plan.tile_ptr, plan.n_tiles, ev.LAST_LAUNCH.ctypes.data, 2 << 20, 77]
    with pytest.raises(ValueError, match="P=0"):
        ev.blob_launch_args(plan, blob.data_ptr(), B, 0, E, V, 0, 0, 0)
