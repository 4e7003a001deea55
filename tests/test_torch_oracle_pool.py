"""The oracle pool on both packages (``runtime/oracle_pool.py``), and the
host lane's pool route.

Mirrors tests/runtime/test_oracle_pool.py with ``min_cores=1``, so that
the pool engages on any host: the spawned workers' verdicts equal the
port's inline oracle and the JAX package's pool; a generation change
rebuilds the pool; below the core floor it stays dormant; a policy with
``context:`` entries never takes the pool route; the workers load
neither torch nor jax and see no CUDA device. Then the host lane with a
pool attached resolves a batch's admission payloads through the workers
to the verdicts and messages of the inline route and of the JAX
package's pool route, with ``pool_cells`` counted.
"""

import copy
import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import CompiledPolicySet as JaxPolicySet
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu.runtime.oracle_pool import OraclePool as JaxOraclePool
from kyverno_tpu.runtime.policycache import PolicyCache as JaxPolicyCache
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.models import CompiledPolicySet
from kyverno_tpu_torch.models import Verdict
from kyverno_tpu_torch.runtime import hostlane
from kyverno_tpu_torch.runtime.oracle_pool import (
    OraclePool,
    _worker_ready,
    pool_safe,
)
from kyverno_tpu_torch.runtime.policycache import PolicyCache
from tests.torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    REQUEST_POLICIES,
    one_torch_thread,
    request_payload,
    request_resources,
)

ENFORCE = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "disallow-latest"},
    "spec": {"validationFailureAction": "enforce", "rules": [{
        "name": "no-latest",
        "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {"message": "latest tag not allowed",
                     "pattern": {"spec": {"containers": [
                         {"image": "!*:latest"}]}}},
    }]},
}

REQUIRE_LABEL = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "require-team"},
    "spec": {"validationFailureAction": "enforce", "rules": [{
        "name": "team",
        "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {"message": "team label required",
                     "pattern": {"metadata": {"labels": {"team": "?*"}}}},
    }]},
}

CONTEXT_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "uses-context"},
    "spec": {"rules": [{
        "name": "r",
        "match": {"resources": {"kinds": ["Pod"]}},
        "context": [{"name": "cm", "configMap": {"name": "x",
                                                 "namespace": "default"}}],
        "validate": {"pattern": {"metadata": {"name": "?*"}}},
    }]},
}


def pod(image, name="p", labels=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         **({"labels": labels} if labels else {})},
            "spec": {"containers": [{"name": "c", "image": image}]}}


def review(resource):
    return {"uid": "u1", "kind": {"kind": "Pod"}, "namespace": "default",
            "operation": "CREATE", "object": resource,
            "userInfo": {"username": "alice", "groups": ["dev"]}}


def _wait_ready(pool, generation, timeout_s=60.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if pool.ready(generation):
            return True
        time.sleep(0.05)
    return False


@pytest.fixture
def pools():
    """A warm two-worker pool of each package over ENFORCE and
    REQUIRE_LABEL, generation 1."""
    docs = [ENFORCE, REQUIRE_LABEL]
    tpool = OraclePool(workers=2, min_cores=1)
    jpool = JaxOraclePool(workers=2, min_cores=1)
    try:
        assert tpool.enabled and jpool.enabled
        tpool.ensure(1, [load_policy(d) for d in docs])
        jpool.ensure(1, [jax_load_policy(d) for d in docs])
        assert _wait_ready(tpool, 1) and _wait_ready(jpool, 1)
        yield jpool, tpool
    finally:
        tpool.stop()
        jpool.stop()


def test_pool_safe_classification():
    assert pool_safe(load_policy(ENFORCE))
    assert not pool_safe(load_policy(CONTEXT_POLICY))


def test_worker_verdicts_match_inline_oracle_and_jax_pool(pools):
    jpool, tpool = pools
    names = ["disallow-latest", "require-team"]
    cps = CompiledPolicySet([load_policy(ENFORCE), load_policy(REQUIRE_LABEL)],
                            device="cpu")
    for resource in (pod("nginx:latest"),
                     pod("nginx:1.21", labels={"team": "x"}),
                     pod("nginx:1.21", name="other")):
        req = review(resource)
        got = tpool.evaluate(names, resource, req, {}, [], [], [])
        want = jpool.evaluate(names, copy.deepcopy(resource),
                              copy.deepcopy(req), {}, [], [], [])
        assert got is not None and got == want
        # the port's inline oracle, with the same admission payload
        inline = cps._oracle_verdicts(resource, [0, 1], context={
            "request": req, "namespace_labels": {}, "roles": [],
            "cluster_roles": [], "exclude_group_role": []})
        status = {"pass": Verdict.PASS, "fail": Verdict.FAIL,
                  "skip": Verdict.SKIP, "error": Verdict.ERROR}
        cells = {name: rules[0] for name, rules in got}
        for r, name in enumerate(names):
            _, st, msg = cells[name]
            assert inline[r] == (status[st], msg)
    assert dict(got)["disallow-latest"][0][1] == "pass"
    assert tpool.hits == 3 and tpool.misses == 0
    # evaluate_payload unpacks the host lane's payload into the same call
    bad = pod("nginx:latest")
    assert tpool.evaluate_payload(names, bad, {"request": review(bad)}) == \
        jpool.evaluate_payload(names, bad, {"request": review(bad)})


def test_generation_change_rebuilds():
    pool = OraclePool(workers=1, min_cores=1)
    try:
        pool.ensure(1, [load_policy(ENFORCE)])
        assert _wait_ready(pool, 1)
        # new generation: not ready until the background rebuild lands
        assert pool.ensure(2, [load_policy(REQUIRE_LABEL)]) is False
        assert not pool.ready(2)
        assert _wait_ready(pool, 2)
        bad = pod("nginx:latest")
        out = dict(pool.evaluate(["require-team"], bad, review(bad),
                                 {}, [], [], []))
        assert out["require-team"][0][1] == "fail"
    finally:
        pool.stop()
    assert pool.ensure(3, []) is False        # a stopped pool builds nothing


def test_disabled_below_core_floor():
    for cls in (JaxOraclePool, OraclePool):
        pool = cls(min_cores=4096)
        assert not pool.enabled
        assert pool.ensure(1, []) is False
        assert pool.evaluate(["x"], {}, {}, {}, [], [], []) is None


def test_workers_load_neither_torch_nor_jax_and_see_no_card(monkeypatch):
    """The launcher sets CUDA_VISIBLE_DEVICES to empty in the worker only;
    the parent's environment is untouched."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    pool = OraclePool(workers=1, min_cores=1)
    try:
        pool.ensure(1, [load_policy(ENFORCE)])
        assert _wait_ready(pool, 1)
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
        info = pool._pool.submit(_worker_ready).result(timeout=30)
        assert info == {"policies": 1, "cuda_visible_devices": "",
                        "torch_loaded": False, "jax_loaded": False}
        launcher = pool._launcher
        assert os.path.exists(launcher)
    finally:
        pool.stop()
    assert not os.path.exists(launcher)


def test_other_spawns_keep_the_interpreter(monkeypatch):
    """Only the pool's own workers start through its launcher: while the
    pool is up and after it stopped, multiprocessing's executable is the
    one it was, and a plain spawned process sees the parent's CUDA
    devices."""
    import multiprocessing
    import multiprocessing.spawn
    from concurrent.futures import ProcessPoolExecutor

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    executable = multiprocessing.spawn.get_executable()

    def plain_spawn():
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as ex:
            return ex.submit(os.getenv, "CUDA_VISIBLE_DEVICES").result(
                timeout=60)

    pool = OraclePool(workers=1, min_cores=1)
    try:
        pool.ensure(1, [load_policy(ENFORCE)])
        assert _wait_ready(pool, 1)
        assert multiprocessing.spawn.get_executable() == executable
        assert plain_spawn() == "0"
        info = pool._pool.submit(_worker_ready).result(timeout=30)
        assert info["cuda_visible_devices"] == ""
    finally:
        pool.stop()
    assert multiprocessing.spawn.get_executable() == executable
    assert plain_spawn() == "0"


# --------------------------------------------------- the host lane's route

@pytest.fixture
def attached():
    """Both packages' host lanes with a warm pool attached over the
    REQUEST_POLICIES, generation-matched to a policy cache; detached and
    memo-cleared afterwards."""
    out = {}
    pools = []
    try:
        for name, load, cache_cls, pool_cls, lane in (
                ("jax", jax_load_policy, JaxPolicyCache, JaxOraclePool,
                 jax_hostlane),
                ("torch", load_policy, PolicyCache, OraclePool, hostlane)):
            cache = (cache_cls() if name == "jax"
                     else cache_cls(device="cpu"))
            for d in REQUEST_POLICIES:
                cache.add(load(copy.deepcopy(d)))
            gen, policies = cache.snapshot()
            pool = pool_cls(workers=2, min_cores=1)
            pools.append(pool)
            pool.ensure(gen, policies)
            assert _wait_ready(pool, gen)
            cps = (JaxPolicySet(policies) if name == "jax"
                   else CompiledPolicySet(policies, device="cpu"))
            lane.host_cache().clear()
            lane.resolver().attach_pool(pool, cache)
            out[name] = (cps, lane, pool)
        yield out
    finally:
        for lane in (jax_hostlane, hostlane):
            lane.resolver().attach_pool(None, None)
            lane.host_cache().clear()
        for pool in pools:
            pool.stop()


def _resolve(cps, resources, payloads):
    msgs = {}
    device = np.array(cps.evaluate_device(cps.flatten_packed(resources)))
    v = cps.resolve_host_cells(resources, device, contexts=payloads,
                               messages_out=msgs)
    return np.asarray(v), msgs


def test_host_lane_pool_route_matches_inline_and_jax(attached):
    resources = request_resources(10)
    payloads = [request_payload(i, r) for i, r in enumerate(resources)]
    got = {}
    for name, (cps, lane, pool) in attached.items():
        s0 = lane.resolver().stats["pool_cells"]
        v, msgs = _resolve(cps, copy.deepcopy(resources),
                           copy.deepcopy(payloads))
        cells = lane.resolver().stats["pool_cells"] - s0
        got[name] = (v, msgs, cells, pool.hits)
    tv, tmsgs, tcells, thits = got["torch"]
    jv, jmsgs, jcells, jhits = got["jax"]
    assert np.array_equal(tv, jv) and tmsgs == jmsgs
    assert not (tv == int(Verdict.HOST)).any()
    # rows with a payload went to the workers (each may also resolve
    # inline, with equal verdicts, if the pool is busy or slow); the rest
    # resolved inline
    assert thits >= 1 and jhits >= 1
    assert tcells > 0 and jcells > 0
    # the inline route gives the same verdicts and messages
    cps, lane, _ = attached["torch"]
    lane.resolver().attach_pool(None, None)
    lane.host_cache().clear()
    iv, imsgs = _resolve(cps, copy.deepcopy(resources),
                         copy.deepcopy(payloads))
    assert np.array_equal(iv, tv) and imsgs == tmsgs


def test_context_policy_forces_inline(attached):
    """A batch with a policy that has context entries never goes to the
    workers, and neither does a row without an admission request."""
    cps, lane, pool = attached["torch"]
    ctx_cps = CompiledPolicySet(
        list(cps.policies) + [load_policy(CONTEXT_POLICY)], device="cpu")
    r = request_resources(1)[0]
    payload = request_payload(0, r)
    resolver = lane.resolver()
    last = len(ctx_cps.rule_refs) - 1
    assert resolver._pool_resolve(ctx_cps, r, [0, last], payload) is None
    assert resolver._pool_resolve(cps, r, [0], None) is None
    assert resolver._pool_resolve(cps, r, [0], {"roles": []}) is None
    assert pool.hits == 0
    routed = resolver._pool_resolve(cps, r, [0], payload)
    assert routed is not None and pool.hits == 1
    assert routed == cps._oracle_verdicts(r, [0], context=payload)


class _Stub:
    """Stand-in for the pool's process executor: ``submit`` hands out
    ``make()``'s future; nothing runs."""

    def __init__(self, make):
        self.make, self.futures = make, []

    def submit(self, fn, *args):
        fut = self.make()
        self.futures.append(fut)
        return fut

    def shutdown(self, wait=True, cancel_futures=False):
        pass


class _StalledCaller(Future):
    """A worker's answer that arrives while its caller is stalled: the
    first wait does not return for ``stall`` seconds, longer than the
    call's timeout, as when a garbage collection holds the interpreter
    lock; it then reports a timeout, as the caller's own wait would, and
    the answer is set a moment later, once the executor's thread runs."""

    def __init__(self, stall, answer):
        super().__init__()
        self.stall, self.answer, self.waits = stall, answer, 0

    def result(self, timeout=None):
        self.waits += 1
        if self.waits == 1:
            time.sleep(self.stall)
            threading.Timer(0.02, self.set_result, (self.answer,)).start()
            raise FuturesTimeout()
        return super().result(timeout)


@pytest.mark.parametrize("timeout_s", [1.0, 0.5])
def test_an_answer_read_after_the_callers_stall_is_a_hit(timeout_s):
    """A pool call whose caller stalls 1.2 s, past the call's timeout,
    while the worker answers (the parent process frozen by a collection)
    reads the answer once it runs again: a hit, not a miss, and the
    pool's breaker stays shut to nothing. The timeout counts the pool's
    time, not the caller's stall; a stall past the wall cap (0.5 s: a
    1 s cap) still gets one more slice to read the answer."""
    answer = [("p", [("r", "pass", "")])]
    pool = OraclePool(workers=2, min_cores=1)
    pool._pool = _Stub(lambda: _StalledCaller(1.2, answer))
    try:
        for _ in range(pool.miss_threshold):
            assert pool.evaluate(["p"], {}, {}, {}, [], [], [],
                                 timeout_s=timeout_s) == answer
        assert (pool.hits, pool.misses) == (pool.miss_threshold, 0)
        assert pool._disabled_until == 0.0
    finally:
        pool.stop()


def test_a_pool_that_does_not_answer_still_times_out():
    """Without a stall the timeout holds as before: a call the workers
    never answer gives up after about its timeout and is a miss, and
    ``miss_threshold`` of them in a row shut the pool's lane."""
    pool = OraclePool(workers=2, min_cores=1)
    pool._pool = _Stub(Future)
    try:
        for _ in range(pool.miss_threshold):
            t0 = time.monotonic()
            assert pool.evaluate(["p"], {}, {}, {}, [], [], [],
                                 timeout_s=0.3) is None
            assert 0.3 <= time.monotonic() - t0 < 1.5
        assert (pool.hits, pool.misses) == (0, pool.miss_threshold)
        assert pool._disabled_until > time.monotonic()
        assert pool.evaluate(["p"], {}, {}, {}, [], [], []) is None
        assert len(pool._pool.futures) == pool.miss_threshold
    finally:
        pool.stop()


class _StalledEveryWait(Future):
    """A call whose caller stalls ``stall`` seconds in every wait (the
    interpreter lock held elsewhere throughout) and whose worker never
    answers; counts the waits."""

    def __init__(self, stall):
        super().__init__()
        self.stall, self.waits = stall, 0

    def result(self, timeout=None):
        self.waits += 1
        time.sleep(self.stall)
        raise FuturesTimeout()


@pytest.mark.parametrize("stall,timeout_s,waits", [(0.65, 0.6, 3),
                                                   (0.3, 0.5, 2)])
def test_a_stalled_caller_gives_up_by_the_wall_cap(stall, timeout_s, waits):
    """Each wait counts at most its slice toward the timeout, but the
    whole wait still gives up once ``WAIT_WALL_CAP`` times the timeout
    has passed on the wall clock, after one more slice if the last was a
    stall: a caller stalled 0.65 s in every wait gives up a 0.6 s call
    after three waits (the cap, 1.2 s, passed in the second), where the
    counted timeout alone would take four; one stalled 0.3 s (no slice
    overruns by a slice) gives up a 0.5 s call after two, the timeout's
    two slices. Either call is a miss."""
    pool = OraclePool(workers=2, min_cores=1)
    pool._pool = _Stub(lambda: _StalledEveryWait(stall))
    try:
        assert pool.evaluate(["p"], {}, {}, {}, [], [], [],
                             timeout_s=timeout_s) is None
        assert pool._pool.futures[0].waits == waits
        assert (pool.hits, pool.misses) == (0, 1)
    finally:
        pool.stop()
