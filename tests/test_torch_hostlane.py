"""The host lane (``runtime/hostlane.py`` behind ``resolve_host_cells``)
on both packages: the cases of the JAX package's host-lane battery, each
run through the JAX package and through the port (on the CPU) on the
same inputs, with both held to the serial loop's verdicts and messages
and to each other.

Prefetch, the verdict memo and fan-out must reproduce the serial
per-resource oracle walk bit for bit. The memo is process-wide; each
case starts from empty caches.
"""

import time

import numpy as np
import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import CompiledPolicySet as JaxPolicySet
from kyverno_tpu.models import engine as jax_engine
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import CompiledPolicySet as TorchPolicySet
from kyverno_tpu_torch.models import Verdict
from kyverno_tpu_torch.models import engine as torch_engine
from kyverno_tpu_torch.runtime import hostlane as torch_hostlane
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

HOST = int(Verdict.HOST)
SWITCHES = ("KTPU_HOST_PREFETCH", "KTPU_HOST_MEMO", "KTPU_HOST_FANOUT")


class Side:
    """One package: its loader, compiled set, host lane and engine."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            self.load, self.hostlane, self.engine = (
                jax_load_policy, jax_hostlane, jax_engine)
            self.compile = JaxPolicySet
        else:
            self.load, self.hostlane, self.engine = (
                torch_load_policy, torch_hostlane, torch_engine)
            self.compile = lambda ps: TorchPolicySet(ps, device="cpu")

    def cps(self, docs):
        return self.compile([self.load(d) for d in docs])

    def memo(self):
        return self.hostlane.host_cache()


SIDES = (Side("jax"), Side("torch"))


def _host_policy(name="host-echo-name", message="name mismatch",
                 field="name"):
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": name},
        "spec": {"validationFailureAction": "enforce", "rules": [{
            "name": "echo",
            "match": {"resources": {"kinds": ["Pod"]}},
            "validate": {"message": message,
                         "pattern": {"metadata": {field:
                             "{{request.object.metadata." + field + "}}"}}},
        }]},
    }


def _device_policy(name="no-latest"):
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": name},
        "spec": {"validationFailureAction": "enforce", "rules": [{
            "name": "r",
            "match": {"resources": {"kinds": ["Pod"]}},
            "validate": {"message": "latest banned",
                         "pattern": {"spec": {"containers": [
                             {"image": "!*:latest"}]}}},
        }]},
    }


def _mismatch_policy(message):
    """Always FAILs (name vs uid), so its own message is the oracle's."""
    return {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "host-name-vs-uid"},
        "spec": {"validationFailureAction": "enforce", "rules": [{
            "name": "echo",
            "match": {"resources": {"kinds": ["Pod"]}},
            "validate": {"message": message,
                         "pattern": {"metadata": {"name":
                             "{{request.object.metadata.uid}}"}}},
        }]},
    }


POLICIES = [_host_policy(), _device_policy(),
            _host_policy("host-echo-ns", "ns mismatch", "namespace")]


def _pod(i):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": "default",
                         "uid": str(i)},
            "spec": {"containers": [{"name": "c", "image": f"nginx:1.{i}"}]}}


def _ctx(pod):
    return {"request": {"object": pod, "operation": "CREATE",
                        "userInfo": {"username": "t"}}}


@pytest.fixture(autouse=True)
def _fresh_memo():
    for side in SIDES:
        side.memo().clear()
    yield
    for side in SIDES:
        side.memo().clear()


@pytest.fixture(scope="module")
def sets():
    return {side.name: side.cps(POLICIES) for side in SIDES}


def _device(cps, pods):
    return np.array(cps.evaluate_device(cps.flatten_packed(pods)))


def _serial_reference(cps, pods, contexts, rule_filter):
    """Ground truth: every switch thrown — the serial loop."""
    with pytest.MonkeyPatch.context() as mp:
        for s in SWITCHES:
            mp.setenv(s, "0")
        msgs = {}
        v = cps.resolve_host_cells(
            pods, _device(cps, pods), contexts=contexts,
            rule_filter=rule_filter, messages_out=msgs)
    return np.asarray(v), msgs


def _memo_delta(before, after):
    return {k: after[k] - before[k] for k in ("hits", "misses", "expired")}


@pytest.mark.parametrize("with_contexts", [False, True])
@pytest.mark.parametrize("with_filter", [False, True])
@pytest.mark.parametrize("with_messages", [False, True])
def test_battery(sets, with_contexts, with_filter, with_messages):
    """contexts x rule_filter x messages_out: the overlapped lane (a
    prefetch at dispatch, then the memo and fan-out) against the serial
    reference, on both packages."""
    pods = [_pod(i) for i in range(6)]
    contexts = [_ctx(p) for p in pods] if with_contexts else None
    results = {}
    for side in SIDES:
        cps = sets[side.name]
        host_rows = [r for r, ref in enumerate(cps.rule_refs)
                     if "echo" in ref.policy.name]
        rule_filter = set(host_rows[:1]) if with_filter else None
        want_v, want_m = _serial_reference(cps, pods, contexts, rule_filter)
        side.memo().clear()
        msgs = {} if with_messages else None
        v = _device(cps, pods)
        pf = side.hostlane.resolver().prefetch(
            cps, pods, contexts=contexts, rule_filter=rule_filter)
        assert pf is not None and pf.submitted_cells > 0
        got = np.asarray(cps.resolve_host_cells(
            pods, v, contexts=contexts, rule_filter=rule_filter,
            messages_out=msgs, prefetch=pf))
        assert pf.applied_cells > 0
        assert np.array_equal(got, want_v), side.name
        if with_messages:
            assert msgs == want_m, side.name
        if with_filter:
            # cells outside the filter stay HOST for the caller
            other = [r for r in host_rows if r not in rule_filter]
            assert (got[:, other] == HOST).all()
        else:
            assert not (got == HOST).any()
        results[side.name] = (got, msgs, want_m)
    assert np.array_equal(results["jax"][0], results["torch"][0])
    assert results["jax"][1] == results["torch"][1]
    assert results["jax"][2] == results["torch"][2]


def test_copy_flag_leaves_input_untouched(sets):
    pods = [_pod(i) for i in range(3)]
    out = {}
    for side in SIDES:
        cps = sets[side.name]
        raw = _device(cps, pods)
        before = raw.copy()
        resolved = cps.resolve_host_cells(pods, raw, copy=True)
        assert np.array_equal(raw, before)          # input untouched
        assert resolved is not raw
        assert not (resolved == HOST).any()
        inplace = raw.copy()
        got = cps.resolve_host_cells(pods, inplace)
        assert got is inplace                       # default: in place
        assert not (inplace == HOST).any()
        out[side.name] = resolved
    assert np.array_equal(out["jax"], out["torch"])


def test_prefetch_vs_post_pass_parity(sets, monkeypatch):
    """A prefetched join and the plain post-pass agree cell for cell —
    over-computation may be wasted, never a verdict change."""
    monkeypatch.setenv("KTPU_HOST_MEMO", "0")
    pods = [_pod(i) for i in range(5)]
    out = {}
    for side in SIDES:
        cps = sets[side.name]
        m_post = {}
        monkeypatch.setenv("KTPU_HOST_PREFETCH", "0")
        assert side.hostlane.resolver().prefetch(cps, pods) is None
        v_post = cps.resolve_host_cells(pods, _device(cps, pods),
                                        messages_out=m_post)
        monkeypatch.setenv("KTPU_HOST_PREFETCH", "1")
        pf = side.hostlane.resolver().prefetch(cps, pods)
        assert pf is not None and pf.submitted_cells > 0
        m_pre = {}
        v_pre = cps.resolve_host_cells(pods, _device(cps, pods),
                                       messages_out=m_pre, prefetch=pf)
        assert pf.applied_cells > 0 and pf.overlap_s() >= 0
        assert np.array_equal(np.asarray(v_post), np.asarray(v_pre))
        assert m_post == m_pre
        out[side.name] = (v_pre, m_pre, pf.submitted_cells, pf.applied_cells)
    assert np.array_equal(out["jax"][0], out["torch"][0])
    assert out["jax"][1:] == out["torch"][1:]


def test_fanout_parity(sets, monkeypatch):
    monkeypatch.setenv("KTPU_HOST_MEMO", "0")
    pods = [_pod(i) for i in range(8)]
    out = {}
    for side in SIDES:
        cps = sets[side.name]
        monkeypatch.setenv("KTPU_HOST_FANOUT", "0")
        m_serial = {}
        v_serial = cps.resolve_host_cells(pods, _device(cps, pods),
                                          messages_out=m_serial)
        monkeypatch.setenv("KTPU_HOST_FANOUT", "1")
        before = side.hostlane.resolver().stats["fanout_batches"]
        m_fan = {}
        v_fan = cps.resolve_host_cells(pods, _device(cps, pods),
                                       messages_out=m_fan)
        assert side.hostlane.resolver().stats["fanout_batches"] > before
        assert np.array_equal(np.asarray(v_serial), np.asarray(v_fan))
        assert m_serial == m_fan
        out[side.name] = (v_fan, m_fan)
    assert np.array_equal(out["jax"][0], out["torch"][0])
    assert out["jax"][1] == out["torch"][1]


def test_memo_hit_after_warm(sets, monkeypatch):
    monkeypatch.setenv("KTPU_HOST_MEMO", "1")
    monkeypatch.setenv("KTPU_HOST_PREFETCH", "0")
    pods = [_pod(i) for i in range(4)]
    out = {}
    for side in SIDES:
        cps = sets[side.name]
        memo = side.memo()
        t0 = dict(memo.stats())
        m1 = {}
        v1 = cps.resolve_host_cells(pods, _device(cps, pods), messages_out=m1)
        cold = _memo_delta(t0, memo.stats())
        assert cold["misses"] > 0 and cold["hits"] == 0
        t1 = dict(memo.stats())
        m2 = {}
        v2 = cps.resolve_host_cells(pods, _device(cps, pods), messages_out=m2)
        warm = _memo_delta(t1, memo.stats())
        assert warm["hits"] == cold["misses"]       # every cell served
        assert warm["misses"] == 0                  # no new oracle work
        assert np.array_equal(np.asarray(v1), np.asarray(v2))
        assert m1 == m2
        out[side.name] = (v2, m2, cold, warm)
    assert np.array_equal(out["jax"][0], out["torch"][0])
    assert out["jax"][1:] == out["torch"][1:]


def test_memo_kill_switch_bypasses_cache(sets, monkeypatch):
    monkeypatch.setenv("KTPU_HOST_MEMO", "0")
    pods = [_pod(i) for i in range(3)]
    out = {}
    for side in SIDES:
        cps = sets[side.name]
        memo = side.memo()
        t0 = dict(memo.stats())
        out[side.name] = cps.resolve_host_cells(pods, _device(cps, pods))
        d = _memo_delta(t0, memo.stats())
        assert d["hits"] == d["misses"] == len(memo) == 0
    assert np.array_equal(out["jax"], out["torch"])


def test_memo_ttl_expiry(sets, monkeypatch):
    monkeypatch.setenv("KTPU_HOST_MEMO", "1")
    monkeypatch.setenv("KTPU_HOST_PREFETCH", "0")
    pods = [_pod(0)]
    out = {}
    for side in SIDES:
        cps = sets[side.name]
        memo = side.memo()
        monkeypatch.setattr(memo, "pure_ttl_s", 0.02)
        monkeypatch.setattr(memo, "context_ttl_s", 0.02)
        t0 = dict(memo.stats())
        cps.resolve_host_cells(pods, _device(cps, pods))
        assert _memo_delta(t0, memo.stats())["misses"] > 0
        time.sleep(0.05)
        t1 = dict(memo.stats())
        cps.resolve_host_cells(pods, _device(cps, pods))
        d = _memo_delta(t1, memo.stats())
        assert d["expired"] > 0                     # entries aged out
        assert d["hits"] == 0                       # and did not serve
        out[side.name] = d
    assert out["jax"] == out["torch"]


def test_memo_policy_swap_invalidates(monkeypatch):
    """Content addressing: an edited policy (same name, new raw) lands in
    a fresh key space — memoized verdicts and messages never cross policy
    content."""
    monkeypatch.setenv("KTPU_HOST_MEMO", "1")
    monkeypatch.setenv("KTPU_HOST_PREFETCH", "0")
    pods = [_pod(0)]
    out = {}
    for side in SIDES:
        memo = side.memo()
        t0 = dict(memo.stats())
        cps1 = side.cps([_mismatch_policy("old wording")])
        m1 = {}
        cps1.resolve_host_cells(pods, _device(cps1, pods), messages_out=m1)
        assert _memo_delta(t0, memo.stats())["misses"] > 0
        t1 = dict(memo.stats())
        cps2 = side.cps([_mismatch_policy("new wording")])
        m2 = {}
        v2 = cps2.resolve_host_cells(pods, _device(cps2, pods), messages_out=m2)
        d = _memo_delta(t1, memo.stats())
        assert d["hits"] == 0                       # nothing crossed
        assert d["misses"] > 0
        assert any("new wording" in m for m in m2.values())
        assert not any("new wording" in m for m in m1.values())
        out[side.name] = (v2, m1, m2)
    assert np.array_equal(out["jax"][0], out["torch"][0])
    assert out["jax"][1:] == out["torch"][1:]


def test_fanout_swallows_an_oracle_exception(sets, monkeypatch):
    """Under fan-out an oracle exception for one resource leaves its HOST
    cells HOST and the other resources resolved, in both packages; the
    serial loop lets the same exception out."""
    monkeypatch.setenv("KTPU_HOST_MEMO", "0")
    monkeypatch.setenv("KTPU_HOST_PREFETCH", "0")
    pods = [_pod(i) for i in range(5)]
    out = {}
    for side in SIDES:
        cps = sets[side.name]
        real = side.engine.oracle_validate

        def flaky(pctx, real=real):
            if (pctx.new_resource or {}).get("metadata", {}).get("name") == "p3":
                raise RuntimeError("oracle down for p3")
            return real(pctx)

        monkeypatch.setattr(side.engine, "oracle_validate", flaky)
        device = _device(cps, pods)
        monkeypatch.setenv("KTPU_HOST_FANOUT", "1")
        got = cps.resolve_host_cells(pods, device.copy())
        host = got == HOST
        assert host[3].any() and np.array_equal(host[3], device[3] == HOST)
        assert not np.delete(host, 3, axis=0).any()
        monkeypatch.setenv("KTPU_HOST_FANOUT", "0")
        with pytest.raises(RuntimeError, match="oracle down for p3"):
            cps.resolve_host_cells(pods, device.copy())
        out[side.name] = got
    assert np.array_equal(out["jax"], out["torch"])


def test_executor_threads_run_only_the_oracle(sets, monkeypatch):
    """The port's host lane resolves on its executor threads, and the
    caller's thread alone touches the device path."""
    import threading

    cps = sets["torch"]
    monkeypatch.setenv("KTPU_HOST_MEMO", "0")
    pods = [_pod(i) for i in range(6)]
    oracle_threads, device_threads = set(), set()
    real_oracle, real_to_device = cps._oracle_verdicts, cps.to_device

    def oracle(*a, **kw):
        oracle_threads.add(threading.current_thread().name)
        return real_oracle(*a, **kw)

    def to_device(*a, **kw):
        device_threads.add(threading.current_thread().name)
        return real_to_device(*a, **kw)

    monkeypatch.setattr(cps, "_oracle_verdicts", oracle)
    monkeypatch.setattr(cps, "to_device", to_device)
    handle = cps.evaluate_device_async(cps.flatten_packed(pods))
    pf = torch_hostlane.resolver().prefetch(cps, pods)
    got = cps.resolve_host_cells(pods, handle.get(), prefetch=pf)
    assert not (got == HOST).any()
    assert device_threads == {threading.current_thread().name}
    assert oracle_threads and all(t.startswith("ktpu-hostlane")
                                  for t in oracle_threads)
