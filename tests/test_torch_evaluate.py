"""``evaluate()`` and ``resolve_host_cells``: the port on the CPU (the
plain versions of K1 and ``eval_rules``, then the CPU oracle for every
HOST cell) against the JAX package's ``CompiledPolicySet``, exactly.

(c) ``evaluate`` on the 250-policy library x 500, the anchor corpus x
300, the cross-check corpus and the difffuzz seeds, each with a resource
of a kind no policy names: equal matrices, no HOST cell left, and each
corpus had HOST cells to resolve.
(d) ``resolve_host_cells`` with admission payloads, ``messages_out``,
``rule_filter`` and ``copy=True``. Also: the caller's arrays are left
alone where they must be, an oracle error propagates from the serial
loop, and a CPU run launches no kernel.
"""

import numpy as np
import pytest

from kyverno_tpu_torch.models import Verdict
from kyverno_tpu_torch.models import engine as torch_engine
from kyverno_tpu_torch.ops import _build
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse)
    FUZZ_SEEDS,
    REQUEST_POLICIES,
    UNKNOWN_KIND,
    both_sets,
    corpus_docs,
    corpus_resources,
    request_payload,
    request_resources,
)

HOST = int(Verdict.HOST)
CASES = [("library250", 500), ("anchor", 300), ("crosscheck", 160)] + [
    (f"fuzz{s}", 64) for s in FUZZ_SEEDS]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    corpus, n = request.param
    jset, tset = both_sets(corpus_docs(corpus))
    resources = corpus_resources(corpus, n) + [UNKNOWN_KIND]
    return corpus, jset, tset, resources


def test_evaluate_equal(case):
    corpus, jset, tset, resources = case
    device = tset.evaluate_device(tset.flatten(resources))
    host = device == HOST
    assert host.any(), f"{corpus}: no HOST cell to resolve"
    got = tset.evaluate(resources)
    want = jset.evaluate(resources)
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]
    assert not (got == HOST).any()
    assert np.array_equal(got[~host], device[~host])
    if corpus == "library250":
        assert int(host.sum()) >= 2 * 300


def test_unknown_kind_through_the_host_lane():
    """Where a host-only rule names more kinds than another, the kind
    table pads with the id an unknown kind also gets: the device lets a
    resource of unknown kind through every host-only rule's kind
    prefilter as HOST, and the oracle answers NOT_APPLICABLE."""
    two_kinds = dict(REQUEST_POLICIES[0], metadata={"name": "two-kinds"})
    two_kinds["spec"] = {"rules": [dict(
        REQUEST_POLICIES[0]["spec"]["rules"][0], name="two-kinds",
        match={"resources": {"kinds": ["Pod", "Deployment"]}})]}
    jset, tset = both_sets(REQUEST_POLICIES + [two_kinds])
    resources = [UNKNOWN_KIND] + request_resources(4)
    device = tset.evaluate_device(tset.flatten(resources))
    assert (device[0] == HOST).sum() >= len(REQUEST_POLICIES)
    got = tset.evaluate(resources)
    assert np.array_equal(got, jset.evaluate(resources))
    assert (got[0] == Verdict.NOT_APPLICABLE).all()


def test_anchor_resolution_reaches_every_status():
    _, tset = both_sets(corpus_docs("anchor"))
    got = tset.evaluate(corpus_resources("anchor", 300))
    counts = np.bincount(got.ravel(), minlength=6)
    assert all(counts[v] for v in (Verdict.PASS, Verdict.FAIL, Verdict.SKIP,
                                   Verdict.ERROR)), counts


# ------------------------------------------------------- resolve_host_cells

@pytest.fixture(scope="module")
def request_case():
    jset, tset = both_sets(REQUEST_POLICIES)
    resources = request_resources(40)
    payloads = [request_payload(i, r) for i, r in enumerate(resources)]
    device = tset.evaluate_device(tset.flatten(resources))
    assert (device == HOST).sum() >= 40
    return jset, tset, resources, payloads, device


def _resolve_both(case, **kw):
    jset, tset, resources, _, device = case
    jm, tm = {}, {}
    want = jset.resolve_host_cells(resources, device.copy(), messages_out=jm, **kw)
    got = tset.resolve_host_cells(resources, device.copy(), messages_out=tm, **kw)
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]
    assert tm == jm
    return got, tm


def test_resolve_with_admission_contexts(request_case):
    _, _, _, payloads, device = request_case
    got, msgs = _resolve_both(request_case, contexts=payloads)
    bare, bare_msgs = _resolve_both(request_case)
    assert not (got == HOST).any() and not (bare == HOST).any()
    # the payloads reach the oracle: verdicts and messages differ from a
    # resolution against the resource alone
    assert not np.array_equal(got, bare) and msgs != bare_msgs
    assert set(msgs) == {tuple(map(int, c)) for c in np.argwhere(device == HOST)}
    assert any("user-" in m for m in msgs.values())
    counts = np.bincount(got.ravel(), minlength=6)
    assert counts[Verdict.PASS] and counts[Verdict.FAIL] and counts[Verdict.ERROR]


def test_resolve_rule_filter(request_case):
    _, _, _, payloads, device = request_case
    keep = {0, 2}
    got, msgs = _resolve_both(request_case, contexts=payloads, rule_filter=keep)
    host = device == HOST
    for r in range(device.shape[1]):
        if r in keep:
            assert not (got[:, r] == HOST).any()
        else:
            assert np.array_equal(got[:, r], device[:, r])
            assert host[:, r].any()
    assert {r for _, r in msgs} <= keep


def test_resolve_copy_and_in_place(request_case):
    jset, tset, resources, payloads, device = request_case
    for cps in (jset, tset):
        v = device.copy()
        out = cps.resolve_host_cells(resources, v, contexts=payloads, copy=True)
        assert out is not v and np.array_equal(v, device)
        v2 = device.copy()
        out2 = cps.resolve_host_cells(resources, v2, contexts=payloads)
        assert out2 is v2 and np.array_equal(out2, out)


def test_evaluate_leaves_held_arrays_alone(request_case):
    """On the CPU the device matrix may be a view of the plain version's
    output: ``evaluate`` resolves a matrix of its own, and ``copy=True``
    leaves a handle's cached matrix as it was."""
    _, tset, resources, _, device = request_case
    batch = tset.flatten(resources)
    held = tset.evaluate_device(batch)
    handle = tset.evaluate_device_async(batch)
    cached = handle.get()
    resolved = tset.evaluate(resources)
    assert not (resolved == HOST).any()
    assert np.array_equal(held, device) and np.array_equal(cached, device)
    tset.resolve_host_cells(resources, handle.get(), copy=True)
    assert handle.get() is cached and np.array_equal(cached, device)


def test_oracle_error_propagates(request_case, monkeypatch):
    """With the host lane's switches off, resolution is the serial loop,
    and an oracle error leaves it (under fan-out the JAX package leaves
    the cells HOST instead: tests/test_torch_hostlane.py)."""
    _, tset, resources, _, device = request_case

    def broken(_ctx):
        raise RuntimeError("oracle down")

    for switch in ("KTPU_HOST_PREFETCH", "KTPU_HOST_MEMO", "KTPU_HOST_FANOUT"):
        monkeypatch.setenv(switch, "0")
    monkeypatch.setattr(torch_engine, "oracle_validate", broken)
    with pytest.raises(RuntimeError, match="oracle down"):
        tset.resolve_host_cells(resources, device.copy())
    with pytest.raises(RuntimeError, match="oracle down"):
        tset.evaluate(resources)


def test_cpu_evaluate_launches_no_kernel(request_case):
    _, tset, resources, _, _ = request_case
    _build.reset_launches()
    tset.evaluate(resources[:8])
    assert all(n == 0 for n in _build.LAUNCHES.values())
