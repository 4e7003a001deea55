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
import time

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
