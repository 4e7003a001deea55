"""The admission path on both packages: ``AdmissionBatcher.screen`` over
``PolicyCache.compiled()``, and K6 (``evaluate_device_async(batch,
donate=True)``) on the CPU.

Each case of tests/runtime/test_admission_batch.py that goes through
neither the webhook nor the metrics registry runs on the JAX package's
batcher and on the port's (on the CPU), with the JAX tests' settings
that make routing deterministic; the two give the same status and the
same cells (policy, rule, verdict, message). A flush's HOST cells
resolve through the host lane with the waiters' admission payloads. K6's
slot ring is driven on the CPU through stand-in slots: reuse, the cap,
taking the oldest slot, the counters, and a caller's blob that is only
read.
"""

import builtins
import copy
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import flatten as jax_flatten
from kyverno_tpu.runtime import batch as jax_batch
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu.runtime.policycache import PolicyCache as JaxPolicyCache
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.models import CompiledPolicySet, Verdict
from kyverno_tpu_torch.models import engine
from kyverno_tpu_torch.models import flatten as torch_flatten
from kyverno_tpu_torch.ops import _build
from kyverno_tpu_torch.runtime import batch, hostlane
from kyverno_tpu_torch.runtime.batch import ATTENTION, CLEAN, ORACLE
from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType
from tests.torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    REQUEST_POLICIES,
    count_plain_launches,
    one_torch_thread,
    request_payload,
    request_resources,
)

ENFORCE = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "disallow-latest-tag"},
    "spec": {
        "validationFailureAction": "enforce",
        "rules": [{
            "name": "validate-image-tag",
            "match": {"resources": {"kinds": ["Pod"]}},
            "validate": {"message": "latest tag not allowed",
                         "pattern": {"spec": {"containers": [
                             {"image": "!*:latest"}]}}},
        }],
    },
}
SECOND = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "second"},
    "spec": {"validationFailureAction": "enforce", "rules": [{
        "name": "r2",
        "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {"message": "m",
                     "pattern": {"metadata": {"name": "?*"}}},
    }]},
}
ENF = int(PolicyType.VALIDATE_ENFORCE)
# a cold flush on the JAX side compiles; the screens wait for it
WAIT_S = 120.0
# the JAX tests' settings: a screen lane the cost model always favours,
# no cold-flush release, no result cache unless a case turns it on
DETERMINISTIC = dict(window_s=0.002, dispatch_cost_init_s=0.0,
                     oracle_cost_init_s=1.0, cold_flush_fallback=False,
                     result_cache_ttl_s=0.0)


def pod(image, name="p"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c", "image": image}]}}


class Side:
    """One package's loader, policy cache and batcher module."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.load, self.mod = jax_load_policy, jax_batch
            self.flatten, self.hostlane = jax_flatten, jax_hostlane
            self.new_cache = JaxPolicyCache
        else:
            self.load, self.mod = load_policy, batch
            self.flatten, self.hostlane = torch_flatten, hostlane
            self.new_cache = lambda: PolicyCache(device="cpu")

    def cache(self, docs=(ENFORCE,)):
        cache = self.new_cache()
        for d in docs:
            cache.add(self.load(copy.deepcopy(d)))
        return cache

    def batcher(self, cache, **kw):
        kw = {**DETERMINISTIC, "burst_threshold": 1, **kw}
        return self.mod.AdmissionBatcher(cache, **kw)


SIDES = (Side("jax"), Side("torch"))


@pytest.fixture(scope="module")
def caches():
    """One ENFORCE cache a package for the module: its compiled set (and
    on the JAX side the jitted programs of each shape) is shared by every
    case that does not change the policies."""
    return {s.name: s.cache() for s in SIDES}


def norm(result):
    """(status, [(policy, rule, verdict int, message)]) of either package."""
    status, row = result
    return status, [(p, r, int(v), m) for p, r, v, m in row]


def screen(b, resource, **kw):
    kw.setdefault("timeout_s", WAIT_S)
    return norm(b.screen(ENF, "Pod", "default", resource, **kw))


def stop(b):
    """Stop a batcher and join every thread it started (its worker, a
    re-warm pass, its flush pool), so that no flush of one case runs, and
    counts, beside a later one."""
    b.stop()
    b._worker.join()
    for t in threading.enumerate():
        if t.name == "adm-rewarm":
            t.join()
    b._flush_pool.shutdown(wait=True)


def both(caches, fn, **kw):
    """``fn(batcher)`` on each package's batcher over the shared cache;
    returns {package: result} after stopping both."""
    out = {}
    for side in SIDES:
        b = side.batcher(caches[side.name], **kw)
        try:
            out[side.name] = fn(b)
        finally:
            stop(b)
    return out


def concurrently(n, fn):
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = fn(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def count_flushes(cps):
    """Wrap a compiled set's two device entries; returns the list of
    batch sizes they were called with."""
    seen = []
    sync, async_ = cps.evaluate_device, cps.evaluate_device_async

    def counting(b):
        seen.append(b.n)
        return sync(b)

    def counting_async(b, donate=False):
        seen.append(b.n)
        return async_(b, donate=donate)

    cps.evaluate_device = counting
    cps.evaluate_device_async = counting_async
    return seen


# ------------------------------------------------------------- screen

@pytest.mark.parametrize("image,want", [("nginx:1.21", CLEAN),
                                        ("nginx:latest", ATTENTION),
                                        ("busybox", CLEAN)])
def test_screen_matches_jax(caches, image, want):
    got = both(caches, lambda b: [screen(b, pod(image)) for _ in range(2)])
    assert got["torch"] == got["jax"]
    status, row = got["torch"][0]
    assert status == want
    verdict = int(Verdict.PASS if want == CLEAN else Verdict.FAIL)
    assert row == [("disallow-latest-tag", "validate-image-tag", verdict, "")]


def test_no_policies_is_clean():
    for side in SIDES:
        b = side.batcher(side.new_cache(), window_s=0.001)
        try:
            assert screen(b, pod("nginx:1.21")) == (CLEAN, [])
        finally:
            stop(b)


def test_distinct_concurrent_admissions_share_one_flush(caches):
    """12 distinct admissions inside one window flush as ONE batch padded
    to the admission floor, and each waiter gets its own row."""
    pods = [pod("nginx:latest" if i % 3 == 0 else "nginx:1.21",
                name=f"pod-{i}") for i in range(12)]
    out = {}
    for side in SIDES:
        # a window long enough for every waiter to join on a loaded host
        b = side.batcher(caches[side.name], window_s=0.5)
        try:
            cps = caches[side.name].compiled(PolicyType.VALIDATE_ENFORCE,
                                             "Pod", "default")
            warm, _ = b._pad_admission(cps.flatten_packed(pods))
            cps.evaluate_device(warm)
            seen = count_flushes(cps)
            try:
                out[side.name] = concurrently(
                    12, lambda i: screen(b, pods[i]))
            finally:
                del cps.evaluate_device, cps.evaluate_device_async
            assert seen == [16], (side.name, seen)
        finally:
            stop(b)
    assert out["torch"] == out["jax"]
    for i, (status, row) in enumerate(out["torch"]):
        assert status == (ATTENTION if i % 3 == 0 else CLEAN)


def test_lone_request_routes_to_oracle(caches):
    def run(b):
        cps = b.policy_cache.compiled(PolicyType.VALIDATE_ENFORCE, "Pod",
                                      "default")
        seen = count_flushes(cps)
        try:
            return screen(b, pod("nginx:1.21")), seen, b.stats["oracle"]
        finally:
            del cps.evaluate_device, cps.evaluate_device_async
    got = both(caches, run, burst_threshold=4)
    assert got["torch"] == got["jax"] == ((ORACLE, []), [], 1)


def test_burst_routes_to_device(caches):
    """The first arrivals below the threshold go to the oracle; once the
    rate estimator sees the burst, the rest share device batches."""
    def run(b):
        results = concurrently(16, lambda i: screen(
            b, pod("nginx:1.21", name=f"p{i}")))
        return results, dict(b.stats)
    got = both(caches, run, burst_threshold=4)
    for name, (results, stats) in got.items():
        assert stats["device"] > 0, name
        assert stats["device"] + stats["oracle"] == 16, name
        for status, row in results:
            assert status in (CLEAN, ORACLE)
            if status == CLEAN:
                assert row == [("disallow-latest-tag", "validate-image-tag",
                                int(Verdict.PASS), "")]


def test_straggler_joins_forming_batch(caches):
    for side in SIDES:
        b = side.batcher(caches[side.name], burst_threshold=100)
        try:
            cps = caches[side.name].compiled(PolicyType.VALIDATE_ENFORCE,
                                             "Pod", "default")
            key = (ENF, "Pod", "default", id(cps))
            with b._lock:
                bucket = b._buckets[key] = side.mod._Bucket(cps)
                bucket.items.append((pod("nginx:1.21", "seed"), None,
                                     Future()))
                b._lock.notify()
            status, row = screen(b, pod("nginx:1.21", "straggler"))
            # joined the device batch, not the oracle
            assert status == CLEAN and row, side.name
        finally:
            stop(b)


def test_circuit_breaker_opens_on_screen_timeouts(caches):
    """Consecutive screen timeouts feed the dispatch-cost EMA the wait
    and open the breaker: the next request takes the oracle at once."""
    def run(b):
        b.circuit_cooldown_s = 30.0
        cps = b.policy_cache.compiled(PolicyType.VALIDATE_ENFORCE, "Pod",
                                      "default")
        b._seen_shapes[cps] = {(1, 1, 1)}
        b._flush = lambda *a, **k: time.sleep(0.4)
        with b.admission_in_flight(), b.admission_in_flight():
            for _ in range(b.circuit_timeout_threshold):
                screen(b, pod("nginx:1.21"), timeout_s=0.05)
        after = screen(b, pod("nginx:1.21"))
        return (b.stats.get("screen_timeout", 0) >= 3,
                b._dispatch_cost >= 0.05,
                b.stats.get("circuit_open", 0) >= 1, after)
    got = both(caches, run, dispatch_cost_init_s=0.001)
    assert got["torch"] == got["jax"] == (True, True, True, (ORACLE, []))


def test_a_burst_after_a_slow_screen_timeout_reaches_the_device(caches):
    """A timed-out screen's seconds-long wait sets the dispatch cost above
    the screen's deadline, and the next request routes ORACLE. Once the
    lane has been idle for a few half-lives the sample has lapsed toward
    the fastest warm flush, and the next burst is answered by the device,
    with the JAX batcher's answers for the same pods. (The JAX batcher
    keeps the sample: a deliberate difference of the port.)"""
    b = SIDES[1].batcher(caches["torch"], dispatch_cost_half_life_s=0.05)
    ref = SIDES[0].batcher(caches["jax"])
    try:
        now = time.monotonic()
        with b._lock:
            b._feed_dispatch_cost("flush", 0.004, now)
            b._feed_dispatch_cost("screen_timeout", 3.39, now)
            assert b._dispatch_cost == 3.39
            shut = b._device_favored(16, 1)
        assert not shut
        assert screen(b, pod("nginx:1.21", "alone")) == (ORACLE, [])
        time.sleep(0.6)
        with b._lock:
            assert b._dispatch_estimate(time.monotonic()) < 0.01
            assert b._device_favored(16, 1)
        s0 = dict(b.stats)
        pods = [pod("nginx:1.21" if i % 2 else "nginx:latest", f"b{i}")
                for i in range(16)]
        got = concurrently(16, lambda i: screen(b, pods[i]))
        assert b.stats["device"] - s0["device"] == 16
        assert b.stats["oracle"] == s0["oracle"]
        assert got == [screen(ref, p) for p in pods]
    finally:
        stop(b)
        stop(ref)


def test_dispatch_cost_holds_while_a_flush_is_in_flight(caches):
    """The idle decay counts only time with no flush in flight: a slow
    sample holds while the lane is busy, and decays once it is idle."""
    b = SIDES[1].batcher(caches["torch"], dispatch_cost_half_life_s=0.05)
    try:
        with b._lock:
            now = time.monotonic()
            b._feed_dispatch_cost("flush", 0.004, now)
            b._feed_dispatch_cost("screen_timeout", 3.0, now)
            b._pending_flushes += 1
            b._settle_dispatch_cost(now)
        time.sleep(0.3)
        with b._lock:
            assert b._dispatch_estimate(time.monotonic()) == 3.0
            b._pending_flushes -= 1
            b._dispatch_cost_at = time.monotonic()
            assert b._dispatch_estimate(b._dispatch_cost_at) == 3.0
            assert b._dispatch_estimate(b._dispatch_cost_at + 0.05) \
                == pytest.approx(0.004 + (3.0 - 0.004) / 2)
    finally:
        stop(b)


# -------------------------------------------------------- result cache

def test_flush_without_a_device_row_is_counted(caches, caplog):
    """A flush that answers its waiters without a device row is never
    silent: a failed flush (here its dispatch raises) is logged and
    counted in ``flush_error``, a cold bucket's release in
    ``cold_release``, and each waiter so answered in ``flush_fallback``.
    Either way the waiter gets (ATTENTION, []), the oracle lane."""
    cps = caches["torch"].compiled(PolicyType.VALIDATE_ENFORCE, "Pod",
                                   "default")

    def fail(*a, **k):
        raise RuntimeError("launch failed")

    b = SIDES[1].batcher(caches["torch"])
    try:
        cps.evaluate_device = cps.evaluate_device_async = fail
        with caplog.at_level("ERROR", logger=batch.__name__):
            assert screen(b, pod("nginx:1.21")) == (ATTENTION, [])
        assert b.stats["flush_error"] == 1
        assert b.stats["flush_fallback"] == 1
        assert "cold_release" not in b.stats
        assert "admission flush of 1 rows failed" in caplog.text
    finally:
        del cps.evaluate_device, cps.evaluate_device_async
        stop(b)
    b = SIDES[1].batcher(caches["torch"], cold_flush_fallback=True)
    try:
        assert screen(b, pod("nginx:1.21", "cold")) == (ATTENTION, [])
        assert b.stats["cold_release"] == 1
        assert b.stats["flush_fallback"] == 1
        assert "flush_error" not in b.stats
    finally:
        stop(b)


def test_cold_flush_releases_its_waiter_on_both_packages(caches):
    """With ``cold_flush_fallback`` on, the first flush of a new shape
    bucket releases its waiter to the oracle lane on either package:
    (ATTENTION, []). The port counts the release once in
    ``cold_release`` and the waiter once in ``flush_fallback`` (the JAX
    package counts neither), and no failed flush."""
    def run(b):
        return screen(b, pod("nginx:latest", "cold")), dict(b.stats)

    got = both(caches, run, cold_flush_fallback=True)
    assert got["torch"][0] == got["jax"][0] == (ATTENTION, [])
    stats = got["torch"][1]
    assert (stats.get("cold_release"), stats.get("flush_fallback"),
            stats.get("flush_error")) == (1, 1, None)


def test_result_cache_hit_and_expiry(caches):
    def run(b):
        first = screen(b, pod("nginx:latest"))
        second = screen(b, pod("nginx:latest"))
        hits = b.stats.get("cache", 0)
        screen(b, pod("nginx:1.21"))            # a different body misses
        return first, second, hits, b.stats.get("cache", 0)
    got = both(caches, run, result_cache_ttl_s=5.0)
    assert got["torch"] == got["jax"]
    first, second, hits, after = got["torch"]
    assert first == second and hits == 1 and after == 1

    def expire(b):
        screen(b, pod("nginx:latest"))
        time.sleep(0.08)
        screen(b, pod("nginx:latest"))
        return b.stats.get("cache", 0)
    assert both(caches, expire, result_cache_ttl_s=0.05) == \
        {"jax": 0, "torch": 0}


def test_request_identity_keys_the_cache(caches):
    def run(b):
        alice = {"operation": "CREATE", "userInfo": {"username": "alice"}}
        bob = {"operation": "CREATE", "userInfo": {"username": "bob"}}
        screen(b, pod("nginx:latest"), env=alice)
        screen(b, pod("nginx:latest"), env=bob)
        miss = b.stats.get("cache", 0)
        screen(b, pod("nginx:latest"), env=alice)
        return miss, b.stats.get("cache", 0)
    assert both(caches, run, result_cache_ttl_s=60.0) == \
        {"jax": (0, 1), "torch": (0, 1)}


def test_policy_change_rotates_cache_key():
    """A policy change bumps the generation out of every key: no stale
    hit, and the new policy's cells are in the next answer."""
    out = {}
    for side in SIDES:
        cache = side.cache()
        b = side.batcher(cache, result_cache_ttl_s=60.0)
        try:
            first = screen(b, pod("nginx:latest"))
            cache.add(side.load(copy.deepcopy(SECOND)))
            second = screen(b, pod("nginx:latest"))
            out[side.name] = (first, second, b.stats.get("cache", 0))
        finally:
            stop(b)
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == 0
    assert {t[0] for t in out["torch"][1][1]} == {"disallow-latest-tag",
                                                  "second"}


# --------------------------------------------------- flush and host lane

def test_flush_stats(caches):
    def run(b):
        screen(b, pod("nginx:1.21"))
        screen(b, pod("nginx:latest"))
        screen(b, pod("nginx:latest"))          # a row-memo hit
        return {k: v for k, v in b.stats.items()
                if k in ("flush_cells", "flagged_rules", "device", "clean",
                         "attention", "flatten_cache_hit_rows",
                         "flatten_cache_miss_rows")
                or k.startswith("esc_")}
    got = both(caches, run)
    assert got["torch"] == got["jax"]
    s = got["torch"]
    assert s["flush_cells"] == {"PASS": 1, "FAIL": 2}
    assert s["esc_clean"] == 1 and s["esc_device_fail"] == 2
    assert s["flagged_rules"] == {"validate-image-tag": 2}
    assert s["flatten_cache_hit_rows"] == 1


def test_row_memo_and_kill_switch(caches, monkeypatch):
    """A repeated body is served through the row memo with the same
    answer; KTPU_FLATTEN_PIPELINE=0 takes the plain flatten and the
    synchronous dispatch, with no memo traffic and the same answers."""
    b = SIDES[1].batcher(caches["torch"])
    try:
        first = screen(b, pod("nginx:1.21", "memo"))
        assert screen(b, pod("nginx:1.21", "memo")) == first
        assert b.stats["flatten_cache_hit_rows"] >= 1
    finally:
        stop(b)
    monkeypatch.setenv("KTPU_FLATTEN_PIPELINE", "0")
    got = both(caches, lambda b: (
        screen(b, pod("nginx:1.21")), screen(b, pod("nginx:latest")),
        "flatten_cache_hit_rows" in b.stats
        or "flatten_cache_miss_rows" in b.stats))
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == CLEAN and got["torch"][1][0] == ATTENTION
    assert got["torch"][2] is False


def memo_state(b):
    """A batcher's flatten-row memo once its flushes have ended (a flush
    stores its rows and its counters after its answers): the memo's
    counters and its rows by resource digest (the memo space is a lineage
    id of each process), and the batcher's."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        with b._lock:
            if not b._pending_flushes:
                break
        time.sleep(0.001)
    cache = b._row_cache
    with cache._lock:
        rows = {key[1]: (m.n_paths, m.epoch, m.row.bmeta,
                         np.asarray(m.row.cells).tobytes(),
                         np.asarray(m.row.str_bytes).tobytes(),
                         np.asarray(m.row.dictv).tobytes())
                for key, m in cache._rows.items()}
    st = cache.stats()
    return ({k: st[k] for k in ("rows", "hits", "misses", "extended")},
            rows, {k: b.stats.get(k, 0) for k in (
                "flatten_cache_hit_rows", "flatten_cache_miss_rows")})


def test_flush_memo_store_matches_jax(caches):
    """The flushes' row-memo stores: new bodies in one burst (a flush
    with no hit, whose rows are split and stored after its dispatch),
    the same bodies again one at a time (every row a hit, so each store
    came before the next lookup), then old and new bodies together (a
    flush with hits and misses). After each step the memo's rows, its
    hit and miss counts and the batcher's are the JAX batcher's."""
    fresh = [pod("nginx:1.21" if i % 2 else "nginx:latest", f"m{i}")
             for i in range(4)]
    mixed = fresh[:2] + [pod("busybox", f"n{i}") for i in range(2)]

    def run(b):
        states, answers = [], []
        answers.append(concurrently(4, lambda i: screen(b, fresh[i])))
        states.append(memo_state(b))
        answers.append([screen(b, r) for r in fresh])
        states.append(memo_state(b))
        answers.append(concurrently(4, lambda i: screen(b, mixed[i])))
        states.append(memo_state(b))
        return answers, states

    got = both(caches, run)
    assert got["torch"] == got["jax"]
    counts = [c for c, _, _ in got["torch"][1]]
    assert [(c["rows"], c["hits"], c["misses"]) for c in counts] == [
        (4, 0, 4), (4, 4, 4), (6, 6, 6)]


@pytest.mark.parametrize("warm", [0, 2])
def test_a_flush_held_at_its_host_join_has_stored_its_memo_rows(caches,
                                                                warm):
    """A flush held at its host-lane join (the pool's answers not in yet)
    has already put its memo rows where a concurrent flush's lookup finds
    them, as the JAX batcher has: a zero-hit flush's rows (``warm`` 0;
    the JAX batcher stores them in its dispatch's shadow) or a partial
    hit's misses (``warm`` 2 of its 4 bodies seen before; stored at its
    flatten). A second burst of the same bodies, flushed while the first
    is held, hits on every row; its answers, the memo and the counts are
    the JAX batcher's. The screens are deadline-free (no adaptive
    deadline), so a waiter of the held flush waits it out."""
    bodies = [pod("nginx:1.21" if i % 2 else "nginx:latest", f"h{i}")
              for i in range(4)]
    free = {"deadline_free": True}

    def run(b):
        if warm:
            concurrently(warm, lambda i: screen(b, bodies[i], **free))
            memo_state(b)
        gate, held = threading.Event(), threading.Event()
        join = b._resolve_flush_hosts
        calls = []

        def held_join(*args, **kw):
            calls.append(len(args[1]))
            if len(calls) == 1:
                held.set()
                assert gate.wait(WAIT_S), "the gate was never opened"
            return join(*args, **kw)

        b._resolve_flush_hosts = held_join
        first_t, first = in_thread(
            lambda: concurrently(4, lambda i: screen(b, bodies[i], **free)))
        try:
            assert held.wait(WAIT_S)
            second = concurrently(4, lambda i: screen(b, bodies[i], **free))
            during = memo_state_now(b)
        finally:
            gate.set()
            first_t.join(WAIT_S)
        return first[0], second, calls[0], during, memo_state(b)

    got = both(caches, run, window_s=0.05, resolve_host_in_flush=True)
    assert got["torch"] == got["jax"]
    first, second, held_rows, during, after = got["torch"]
    assert first == second and all(row for _, row in first)
    assert held_rows == 4
    assert (during[0]["hits"], during[0]["misses"]) == (warm + 4, 4)
    assert after[0] == during[0]


def memo_state_now(b):
    """:func:`memo_state`'s counts without waiting for the flushes to
    end."""
    st = b._row_cache.stats()
    return ({k: st[k] for k in ("rows", "hits", "misses", "extended")},
            {k: b.stats.get(k, 0) for k in (
                "flatten_cache_hit_rows", "flatten_cache_miss_rows")})


@pytest.mark.parametrize("seed", range(4))
def test_flush_scatter_matches_the_cell_loop(seed):
    """The flush's scatter in bulk (``_ScatterTable``) against a loop over
    every cell in rule order, as the JAX batcher's scatter goes: each
    row's (policy, rule, verdict, message) cells, and the counts by
    verdict, by flagged rule name (names repeat across policies) and by
    (policy, rule, verdict), their keys in the order of their first
    cell; rule columns out of order, some rows all NOT_APPLICABLE."""
    rng = np.random.default_rng(seed)
    n_rules, n_rows = 23, 9

    class Ref:
        def __init__(self, k, col):
            self.policy = type("P", (), {"name": f"pol-{k % 7}"})()
            self.rule = type("R", (), {"name": f"rule-{k % 5}"})()
            self.rule_index = col

    cols = rng.permutation(n_rules + 3)[:n_rules]
    cps = type("Set", (), {"rule_refs": [Ref(k, int(c))
                                         for k, c in enumerate(cols)]})()
    verdicts = rng.integers(0, 6, size=(n_rows + 2, n_rules + 3),
                            dtype=np.int8)
    verdicts[rng.random(verdicts.shape) < 0.4] = 0
    verdicts[3] = 0
    messages = {(b, int(c)): f"m{b}-{c}" for b in range(n_rows)
                for c in cols if rng.random() < 0.2}
    rows, by_verdict, flagged, attrib = [], {}, {}, {}
    for b in range(n_rows):
        row = []
        for ref in cps.rule_refs:
            v = Verdict(verdicts[b, ref.rule_index])
            if v is Verdict.NOT_APPLICABLE:
                continue
            p, r = ref.policy.name, ref.rule.name
            row.append((p, r, v, messages.get((b, ref.rule_index), "")))
            by_verdict[v.name] = by_verdict.get(v.name, 0) + 1
            attrib[(p, r, v.name)] = attrib.get((p, r, v.name), 0) + 1
            if v not in (Verdict.PASS, Verdict.SKIP):
                flagged[r] = flagged.get(r, 0) + 1
        rows.append(row)
    table = batch._scatter_table(cps)
    cells = verdicts[:n_rows][:, table.cols]
    per_row = {}
    for (b, r), msg in messages.items():
        per_row.setdefault(b, {})[r] = msg
    assert [table.row(cells[b], per_row.get(b))
            for b in range(n_rows)] == rows
    got = table.counts(cells)
    assert got == (by_verdict, flagged, attrib)
    assert [list(d) for d in got] == [list(by_verdict), list(flagged),
                                      list(attrib)]
    assert table.counts(cells[:, :0]) == ({}, {}, {})


def test_host_cells_resolve_in_the_flush():
    """Host-lane rules that read the admission request: one flush
    resolves every waiter's HOST cells with its payload (ctx_cb), so the
    rows carry the oracle's verdicts and messages, equal on both
    packages; the host lane counts the prefetch it applied."""
    docs = [dict(d, spec=dict(d["spec"], validationFailureAction="enforce"))
            for d in REQUEST_POLICIES]
    resources = request_resources(8)
    payloads = [request_payload(i, r) for i, r in enumerate(resources)]
    out = {}
    for side in SIDES:
        side.hostlane.host_cache().clear()
        cache = side.cache(docs)
        b = side.batcher(cache, window_s=0.05)
        try:
            res = copy.deepcopy(resources)
            pay = copy.deepcopy(payloads)
            out[side.name] = concurrently(8, lambda i: screen(
                b, res[i], ctx_cb=lambda i=i: pay[i]))
            out[side.name + "_resolved"] = b.stats.get(
                "host_cells_resolved", 0)
        finally:
            stop(b)
            side.hostlane.host_cache().clear()
    assert out["torch"] == out["jax"]
    assert out["torch_resolved"] == out["jax_resolved"] > 0
    cells = [c for _, row in out["torch"] for c in row]
    assert not any(v == int(Verdict.HOST) for _, _, v, _ in cells)
    assert any(m for _, _, _, m in cells)


def test_warmup_seeds_memo_and_shapes(caches):
    b = SIDES[1].batcher(caches["torch"])
    try:
        b.warmup(PolicyType.VALIDATE_ENFORCE, "Pod", "default",
                 pod("nginx:1.21", "warm"), batch_sizes=(1, 2))
        cps = caches["torch"].compiled(PolicyType.VALIDATE_ENFORCE, "Pod",
                                       "default")
        with b._lock:
            assert b._seen_shapes.get(cps)
        assert len(b._row_cache) >= 1
    finally:
        stop(b)


def test_screen_row_and_evaluate_block_match_screen(caches):
    """A pre-tokenized row takes the device lane and answers as screen()
    does; a whole block evaluates through K6 to the same rows."""
    b = SIDES[1].batcher(caches["torch"])
    try:
        cps = caches["torch"].compiled(PolicyType.VALIDATE_ENFORCE, "Pod",
                                       "default")
        pods = [pod("nginx:1.21", "r1"), pod("nginx:latest", "r2")]
        want = [screen(b, p) for p in pods]
        rows = torch_flatten.split_packed_rows(cps.flatten_packed(pods))
        got = [norm(b.screen_row(ENF, "Pod", "default", r, timeout_s=WAIT_S))
               for r in rows]
        assert got == want
        block = [norm(r) for r in b.evaluate_block(
            ENF, "Pod", "default", cps.flatten_packed(pods))]
        assert block == want
        assert b.stats["stream_rows"] == 2 and b.stats["stream_blocks"] == 1
    finally:
        stop(b)


def test_late_join_graft_matches_jax(caches):
    """The continuous lane's late join: items queued after a window
    drained graft into the padded flush's headroom, on both packages."""
    late = [pod("nginx:latest" if i % 2 else "nginx:1.21", f"late-{i}")
            for i in range(3)]
    base = [pod("nginx:1.21", "base")]
    got = {}
    for side in SIDES:
        b = side.batcher(caches[side.name], continuous=True)
        try:
            cps = caches[side.name].compiled(PolicyType.VALIDATE_ENFORCE,
                                             "Pod", "default")
            raw = cps.flatten_packed(base)
            v_used = int(raw.dictv.shape[0])
            padded, _ = b._pad_admission(raw)
            padded = side.flatten.grow_dict_headroom(padded, v_used // 4 + 1)
            items = [(r, None, Future()) for r in late]
            joined, left = b._graft_late(cps, padded, 1, items, v_used)
            v = np.asarray(cps.evaluate_device(padded))[:1 + len(joined)]
            got[side.name] = (len(joined), len(left), v.tolist())
        finally:
            stop(b)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 3


# ------------------------------------------------------------------ K6

@pytest.fixture
def cpu_set():
    docs = [ENFORCE, SECOND]
    cps = CompiledPolicySet([load_policy(copy.deepcopy(d)) for d in docs],
                            device="cpu")
    return cps, cps.flatten_packed([pod("nginx:latest", "a"),
                                    pod("nginx:1.21", "b")])


def test_donate_on_the_cpu_counts_and_leaves_the_blob(cpu_set):
    """donate=True on the CPU runs the plain versions, counts the
    dispatch (no buffer consumed), and only reads the caller's blob."""
    cps, b = cpu_set
    blob, _ = b.packed_blob()
    before = blob.copy()
    total = dict(engine.DONATION_STATS)
    h = cps.evaluate_device_async(b, donate=True)
    assert h.done()
    got = h.get()
    assert np.array_equal(got, cps.evaluate_device(b))
    assert np.array_equal(blob, before)
    assert cps.donation_stats == {"dispatches": 1, "donated_buffers": 0}
    assert engine.DONATION_STATS["dispatches"] >= total["dispatches"] + 1
    assert h.get() is got                      # read once, cached


def test_donate_switch_off_takes_the_plain_route(cpu_set, monkeypatch):
    cps, b = cpu_set
    monkeypatch.setenv("KTPU_DONATE", "0")
    got = cps.evaluate_device_async(b, donate=True).get()
    assert np.array_equal(got, cps.evaluate_device(b))
    assert cps.donation_stats == {"dispatches": 0, "donated_buffers": 0}


def test_donate_on_cuda_raises_without_a_card(cpu_set):
    """No fallback: with the device set to cuda and no card, K6's pinned
    allocation raises, and nothing is counted."""
    cps, b = cpu_set
    cps.device = torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        cps.evaluate_device_async(b, donate=True)
    assert cps.donation_stats == {"dispatches": 0, "donated_buffers": 0}
    assert all(not ring for ring in cps._k6.values())


class _Event:
    """Stand-in CUDA event for the CPU: every copy is already done."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def query(self):
        return True


class _CpuSlot(engine._Slot):
    """A K6 slot on CPU tensors: its own buffers and the real ``replay``
    (the launches counted). Its steps copy with torch and run the plain
    versions; its capture lists the launches of one run of them (over a
    zeroed blob), and a replay runs them again, listing their launches
    instead of counting them, as a captured graph launches without the
    wrappers."""

    def __init__(self, plan, shp, words, device):
        B, _, _, V = shp
        self.device = device
        self.exec = 0
        self.staged = torch.zeros(words, dtype=torch.int32)
        self.dblob = torch.empty(words, dtype=torch.int32)
        self.match = torch.empty((plan.nfa_char.shape[0], V),
                                 dtype=torch.bool)
        self.verdicts = torch.empty((B, plan.R), dtype=torch.int8)
        self.out = torch.empty((B, plan.R), dtype=torch.int8)
        self.event = _Event()
        self.launch = np.zeros(2, dtype=np.int32)
        self.handle = None
        self.seq = 0
        self._plan, self._shp = plan, shp
        self.kernels = self._capture(plan, shp)

    def _steps(self, plan, shp):
        self.dblob.copy_(self.staged)
        engine.ops_eval.evaluate_blob(plan, self.dblob, *shp,
                                      match=self.match, out=self.verdicts,
                                      launch=self.launch)
        self.out.copy_(self.verdicts)

    def _capture(self, plan, shp):
        with _build.launches_noted() as kernels:
            self._steps(plan, shp)
        return tuple(kernels)

    def _run(self, host):
        self.staged.copy_(torch.from_numpy(host))
        with _build.launches_noted():
            self._steps(self._plan, self._shp)


def test_k6_slot_ring(cpu_set, monkeypatch):
    """K6's ring on stand-in slots: the first dispatch of a bucket
    allocates, the next ones reuse (counted as donated buffers); with
    K6_SLOTS handles held a dispatch takes the oldest slot after copying
    its holder's verdicts out; every handle reads its own verdicts; the
    caller's blob is only read."""
    cps, b = cpu_set
    monkeypatch.setattr(engine, "_Slot", _CpuSlot)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    live = cps.tensors.n_rules_live
    want = cps.evaluate_device(b)
    blob = b.packed_blob()[0]
    before = blob.copy()
    total = dict(engine.DONATION_STATS)
    alloc = engine.K6_ALLOC["slots"]
    h1 = cps._dispatch_k6(b, live)
    assert np.array_equal(h1.get(), want)
    h2 = cps._dispatch_k6(b, live)
    assert np.array_equal(h2.get(), want)
    assert cps.donation_stats == {"dispatches": 2, "donated_buffers": 1}
    assert engine.DONATION_STATS["dispatches"] >= total["dispatches"] + 2
    assert engine.DONATION_STATS["donated_buffers"] >= \
        total["donated_buffers"] + 1
    assert engine.K6_ALLOC["slots"] == alloc + 1
    # hold every slot, then one more: the oldest holder is copied out
    held = [cps._dispatch_k6(b, live) for _ in range(engine.K6_SLOTS)]
    ring = cps._k6[b.packed_blob()[1]]
    assert len(ring) == engine.K6_SLOTS
    assert held[0]._verdicts is None
    extra = cps._dispatch_k6(b, live)
    assert len(ring) == engine.K6_SLOTS
    assert held[0]._verdicts is not None and held[0]._slot is None
    for h in held + [extra]:
        assert np.array_equal(h.get(), want)
        assert h.done()
    assert all(s.handle is None for s in ring)
    assert np.array_equal(blob, before)
    # a wider rule bucket is sliced back to the live rules
    assert want.shape[1] == live


def test_k6_slot_ring_under_threads(cpu_set, monkeypatch):
    """Eight threads dispatch through one bucket's ring and read their
    handles, as the flush pool and warmup do, switching as often as the
    interpreter allows. Each dispatch's launches stand in as a matrix
    filled with its own tag, so a handle that read another dispatch's
    slot would show it: every handle reads its own verdicts, the ring
    stays within K6_SLOTS, and every dispatch is counted once in the
    set's own counters (the process-wide ones also move with any other
    set's dispatches)."""
    cps, b = cpu_set
    monkeypatch.setattr(engine, "_Slot", _CpuSlot)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    tag = threading.local()
    monkeypatch.setattr(engine.ops_eval, "evaluate_blob",
                        lambda plan, blob, B, P, E, V, out, **kw:
                        out.fill_(tag.value))
    live = cps.tensors.n_rules_live
    per = 40
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            bad = 0
            held = []
            for k in range(per):
                tag.value = (i * per + k) % 127
                held.append((tag.value, cps._dispatch_k6(b, live)))
                if k % 3 == 2:          # hold some handles across dispatches
                    for v, h in held:
                        got = h.get()
                        bad += got.shape[1] != live or bool((got != v).any())
                    held = []
            for v, h in held:
                bad += bool((h.get() != v).any())
            return bad
        assert concurrently(8, run) == [0] * 8
    finally:
        sys.setswitchinterval(interval)
    ring = cps._k6[b.packed_blob()[1]]
    assert len(ring) <= engine.K6_SLOTS
    assert all(s.handle is None for s in ring)
    assert cps.donation_stats == {"dispatches": 8 * per,
                                  "donated_buffers": 8 * per - len(ring)}


def test_k6_holder_frees_its_slot_during_the_pick(cpu_set, monkeypatch):
    """The race behind the threaded ring test: with every slot held, a
    dispatch picks the oldest holder's slot under the ring's lock, while
    the holder may read its verdicts on its own thread, which takes only
    its handle's lock and frees the slot. Here that read lands between the
    ring's scan and the pick (it runs inside the pick's ``min``): the
    dispatch still takes that slot, every handle reads its own verdicts,
    and the ring stays at K6_SLOTS."""
    cps, b = cpu_set
    monkeypatch.setattr(engine, "_Slot", _CpuSlot)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    live = cps.tensors.n_rules_live
    want = cps.evaluate_device(b)
    held = [cps._dispatch_k6(b, live) for _ in range(engine.K6_SLOTS)]
    read = []

    def pick(items, key):
        first = builtins.min(items, key=key)
        slot = first[0] if isinstance(first, tuple) else first
        read.append(slot.handle)
        slot.handle.get()               # the holder's own read
        return first

    monkeypatch.setattr(engine, "min", pick, raising=False)
    extra = cps._dispatch_k6(b, live)
    monkeypatch.delattr(engine, "min")
    assert read == [held[0]]
    ring = cps._k6[b.packed_blob()[1]]
    assert len(ring) == engine.K6_SLOTS
    assert held[0]._slot is None and held[0]._verdicts is not None
    for h in held + [extra]:
        assert np.array_equal(h.get(), want)
    assert all(s.handle is None for s in ring)


def gated_slots(blocked: int):
    """A stand-in slot class whose ``blocked``-th capture (1-based, over
    every bucket) waits on ``gate`` after setting ``started``: a capture
    in progress for as long as a test holds it."""
    gate, started = threading.Event(), threading.Event()
    seen = []

    class Gated(_CpuSlot):
        def _capture(self, plan, shp):
            seen.append(shp)
            if len(seen) == blocked:
                started.set()
                assert gate.wait(30), "the gate was never opened"
            return super()._capture(plan, shp)

    return Gated, gate, started


def in_thread(fn):
    """``fn()`` on a thread of its own; returns (thread, results list)."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    t.start()
    return t, out


# how long a dispatch that should not wait is given to finish
NOT_HELD_S = 5.0


def test_k6_capture_does_not_block_another_buckets_dispatch(cpu_set,
                                                            monkeypatch):
    """A slot's capture runs outside the ring's lock: while bucket A's
    first slot is being captured, a dispatch on bucket B builds its own
    slot, replays and reads its verdicts; A's dispatch then completes
    with its own verdicts, each bucket with one slot."""
    cps, a = cpu_set
    b = cps.flatten_packed([pod("nginx:latest", f"b{i}") for i in range(3)])
    assert a.packed_blob()[1] != b.packed_blob()[1]
    gated, gate, started = gated_slots(blocked=1)
    monkeypatch.setattr(engine, "_Slot", gated)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    live = cps.tensors.n_rules_live
    want_a, want_b = cps.evaluate_device(a), cps.evaluate_device(b)
    ta, got_a = in_thread(lambda: cps._dispatch_k6(a, live).get())
    try:
        assert started.wait(30)
        tb, got_b = in_thread(lambda: cps._dispatch_k6(b, live).get())
        tb.join(NOT_HELD_S)
        assert not tb.is_alive(), "bucket B waited on bucket A's capture"
        assert ta.is_alive()               # A's capture is still held
        assert np.array_equal(got_b[0], want_b)
    finally:
        gate.set()
        ta.join(30)
    assert np.array_equal(got_a[0], want_a)
    assert [len(cps._k6[x.packed_blob()[1]]) for x in (a, b)] == [1, 1]
    assert cps._k6_building == {a.packed_blob()[1]: 0,
                                b.packed_blob()[1]: 0}
    assert cps.donation_stats == {"dispatches": 2, "donated_buffers": 0}


def test_k6_ready_slot_is_used_while_its_bucket_captures(cpu_set,
                                                         monkeypatch):
    """While a bucket's second slot is being captured (its first was
    held), a dispatch of the same bucket takes the first slot once it is
    free, without waiting for the capture; the ring then holds both."""
    cps, a = cpu_set
    gated, gate, started = gated_slots(blocked=2)
    monkeypatch.setattr(engine, "_Slot", gated)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    live = cps.tensors.n_rules_live
    want = cps.evaluate_device(a)
    h1 = cps._dispatch_k6(a, live)             # slot 1, held
    t2, got2 = in_thread(lambda: cps._dispatch_k6(a, live).get())
    try:
        assert started.wait(30)                # slot 2 capturing
        assert np.array_equal(h1.get(), want)  # slot 1 free again
        t3, got3 = in_thread(lambda: cps._dispatch_k6(a, live).get())
        t3.join(NOT_HELD_S)
        assert not t3.is_alive(), "a ready slot waited on the capture"
        assert np.array_equal(got3[0], want)
    finally:
        gate.set()
        t2.join(30)
    assert np.array_equal(got2[0], want)
    ring = cps._k6[a.packed_blob()[1]]
    assert len(ring) == 2 and all(s.handle is None for s in ring)
    assert cps.donation_stats == {"dispatches": 3, "donated_buffers": 1}


def test_k6_slots_being_built_count_toward_the_cap(cpu_set, monkeypatch):
    """A slot being built holds its place in the bucket: with K6_SLOTS at
    1 and that slot capturing, a second dispatch builds none and takes
    the slot once it is published and its holder's verdicts are copied
    out. A capture that fails gives its place back."""
    cps, a = cpu_set
    gated, gate, started = gated_slots(blocked=1)
    monkeypatch.setattr(engine, "_Slot", gated)
    monkeypatch.setattr(engine, "K6_SLOTS", 1)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    live = cps.tensors.n_rules_live
    want = cps.evaluate_device(a)
    shp = a.packed_blob()[1]
    alloc = engine.K6_ALLOC["slots"]
    t1, got1 = in_thread(lambda: cps._dispatch_k6(a, live))
    try:
        assert started.wait(30)
        t2, got2 = in_thread(lambda: cps._dispatch_k6(a, live).get())
        t2.join(0.2)
        assert t2.is_alive() and cps._k6[shp] == []
        assert cps._k6_building[shp] == 1
    finally:
        gate.set()
        t1.join(30)
        t2.join(30)
    assert np.array_equal(got2[0], want)
    assert np.array_equal(got1[0].get(), want)
    assert len(cps._k6[shp]) == 1 and engine.K6_ALLOC["slots"] == alloc + 1

    class Uncapturable(_CpuSlot):
        def _capture(self, plan, shp):
            raise RuntimeError("cudaErrorStreamCaptureImplicit")

    b = cps.flatten_packed([pod("nginx:1.21", f"c{i}") for i in range(3)])
    monkeypatch.setattr(engine, "_Slot", Uncapturable)
    with pytest.raises(RuntimeError, match="CaptureImplicit"):
        cps._dispatch_k6(b, live)
    assert cps._k6_building[b.packed_blob()[1]] == 0
    monkeypatch.setattr(engine, "_Slot", _CpuSlot)
    assert np.array_equal(cps._dispatch_k6(b, live).get(),
                          cps.evaluate_device(b))


def test_k6_phase_timing(cpu_set, monkeypatch):
    """With PHASE_TIMING on, a K6 dispatch times its own steps: the
    handle's phases() gives every step in ms, none negative, beside the
    same verdicts; with it off a dispatch keeps no phases."""
    cps, b = cpu_set
    monkeypatch.setattr(engine, "_Slot", _CpuSlot)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    # stand-in timing events: the host clock
    monkeypatch.setattr(engine, "_event_record",
                        lambda device: time.perf_counter())
    monkeypatch.setattr(engine, "_event_ms", lambda a, b: (b - a) * 1e3)
    monkeypatch.setattr(engine, "_event_destroy", lambda e: None)
    live = cps.tensors.n_rules_live
    want = cps.evaluate_device(b)
    h = cps._dispatch_k6(b, live, engine._Phases(cps.device))
    assert np.array_equal(h.get(), want)
    ph = h.phases()
    assert set(ph) == {"call", "replay", "read", "dispatch"}
    assert all(v >= 0.0 for v in ph.values())
    assert ph["dispatch"] >= ph["call"]
    assert cps._dispatch_k6(b, live).phases() is None
    monkeypatch.setattr(engine, "PHASE_TIMING", True)
    # the CPU route keeps none either: there is no card to time
    assert cps.evaluate_device_async(b, donate=True).phases() is None


def test_k6_dispatch_counts_one_launch_of_each_kernel(cpu_set, monkeypatch):
    """A K6 dispatch counts one launch of K1 and one of eval_rules, the
    slot's first (its capture) and the warm ones alike, through
    ``_Slot.replay``'s count of the launches its capture listed; the
    capture itself counts none. The plain calls are counted as launches
    here, as on the card the wrappers count theirs."""
    cps, b = cpu_set
    monkeypatch.setattr(engine, "_Slot", _CpuSlot)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    count_plain_launches(monkeypatch)
    live = cps.tensors.n_rules_live
    want = cps.evaluate_device(b)
    saved = dict(_build.LAUNCHES)
    try:
        _build.reset_launches()
        for n in range(1, 4):
            assert np.array_equal(cps._dispatch_k6(b, live).get(), want)
            assert _build.LAUNCHES == {
                "glob_nfa": n, "eval_rules": n, "eval_rules_scan": 0,
                "eval_rules_counts": 0, "scan_counts": 0}
        (slot,) = cps._k6[b.packed_blob()[1]]
        assert slot.kernels == ("glob_nfa", "eval_rules")
    finally:
        _build.LAUNCHES.update(saved)


def test_launches_noted_lists_on_its_thread_only():
    """Inside ``launches_noted`` a launch is listed, not counted, on that
    thread; another thread's launches count as before, and counting
    resumes on leaving it, also after a failure inside."""
    saved = dict(_build.LAUNCHES)
    try:
        _build.reset_launches()
        with pytest.raises(ValueError):
            with _build.launches_noted() as names:
                _build.note_launch("glob_nfa")
                t = threading.Thread(
                    target=_build.note_launch, args=("eval_rules",))
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
                raise ValueError("a failed capture")
        assert names == ["glob_nfa"]
        _build.note_launch("glob_nfa")
        _build.note_launches(("glob_nfa", "eval_rules"))
        assert (_build.LAUNCHES["glob_nfa"], _build.LAUNCHES["eval_rules"]) \
            == (2, 2)
    finally:
        _build.LAUNCHES.update(saved)


class _Dispatch:
    """Stand-ins for ``csrc/dispatch.cu``'s capture entries: the capture's
    end fails with ``end_error`` (901, cudaErrorStreamCaptureInvalidated,
    where the work inside broke it); calls are noted."""

    def __init__(self, end_error):
        self.end_error, self.calls = end_error, []

    def fn(self, name, entry, n_args):
        assert name == "dispatch"
        return lambda *args: self.calls.append(entry) or (
            self.end_error if entry == "ktpu_capture_end" else 0)


def test_k6_warm_dispatch_is_one_call(cpu_set, monkeypatch):
    """A warm K6 dispatch on a real slot makes one call into
    ``csrc/dispatch.cu`` (``ktpu_replay``: the blob into the staging, the
    graph, the event, on the current stream) and counts the launches its
    capture listed; nothing else reaches the runtime."""
    cps, b = cpu_set
    host = np.ascontiguousarray(b.packed_blob()[0]).view(np.int32)
    calls = []
    monkeypatch.setattr(engine._build, "fn", lambda name, entry, n: (
        lambda *args: calls.append((name, entry, args)) or 0))
    monkeypatch.setattr(engine._build, "stream_handle", lambda dev: 9)
    slot = object.__new__(engine._Slot)
    slot.device, slot.exec = cps.device, 5
    slot.staged = torch.zeros(host.size, dtype=torch.int32)
    slot.event = type("Ev", (), {"cuda_event": 11})()
    slot.kernels = ("glob_nfa", "eval_rules")
    saved = dict(_build.LAUNCHES)
    try:
        _build.reset_launches()
        slot.replay(host)
        assert (_build.LAUNCHES["glob_nfa"], _build.LAUNCHES["eval_rules"]) \
            == (1, 1)
    finally:
        _build.LAUNCHES.update(saved)
        slot.exec = 0
    assert calls == [("dispatch", "ktpu_replay", (
        5, slot.staged.data_ptr(), host.ctypes.data, host.nbytes, 11, 9))]


@pytest.mark.parametrize("broken", ["steps", "end"])
def test_k6_failed_capture_raises(monkeypatch, broken):
    """No fallback: a capture whose work fails inside (here, a call the
    capture refuses) ends the capture and raises that work's error; a
    capture that its end finds invalidated raises the runtime's error.
    Neither leaves a graph."""
    stub = _Dispatch(901 if broken == "end" else 0)
    monkeypatch.setattr(engine._build, "fn", stub.fn)

    def steps():
        if broken == "steps":
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    with pytest.raises(RuntimeError, match="not permitted" if broken ==
                       "steps" else "cudaError 901"):
        engine._captured(7, steps)
    # a capture that ended (the work raised before queueing anything
    # it refused) is instantiated, then destroyed
    assert stub.calls == ["ktpu_capture_begin", "ktpu_capture_end"] + (
        ["ktpu_graph_destroy"] if broken == "steps" else [])


def test_k6_failed_capture_or_replay_leaves_the_ring(cpu_set, monkeypatch):
    """A slot whose capture raises is never in the ring; a replay that
    raises takes its slot out of the ring (its copies may be queued).
    Both raise to the caller, and neither runs the plain route."""
    cps, b = cpu_set
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)

    def plain(*a, **k):
        raise AssertionError("K6 fell back to the plain route")

    class Uncapturable(_CpuSlot):
        def _capture(self, plan, shp):
            raise RuntimeError("cudaErrorStreamCaptureImplicit")

    monkeypatch.setattr(cps, "_launch", plain)
    monkeypatch.setattr(engine, "_Slot", Uncapturable)
    live = cps.tensors.n_rules_live
    shp = b.packed_blob()[1]
    with pytest.raises(RuntimeError, match="CaptureImplicit"):
        cps._dispatch_k6(b, live)
    assert cps._k6[shp] == []
    assert cps.donation_stats == {"dispatches": 0, "donated_buffers": 0}

    monkeypatch.setattr(engine, "_Slot", _CpuSlot)
    cps._dispatch_k6(b, live).get()
    (slot,) = cps._k6[shp]

    def lost(host):
        raise RuntimeError("CUDA kernel dispatch failed to launch: "
                           "cudaError 719")

    slot._run = lost
    with pytest.raises(RuntimeError, match="cudaError 719"):
        cps._dispatch_k6(b, live)
    assert cps._k6[shp] == []
    assert cps.donation_stats == {"dispatches": 1, "donated_buffers": 0}


def test_trace_bind_adopt_and_span():
    """The tracing the batcher uses: bind / unbind set the thread's
    trace, a waiter's trace adopts a flush's spans, and span() records a
    stage (a no-op without a trace)."""
    from kyverno_tpu_torch.runtime import tracing

    rec = tracing.recorder()
    flush = rec.start("flush", batch=2)
    waiter = rec.start("admission")
    tok = tracing.bind(flush)
    try:
        assert tracing.current() is flush
        with rec.span(tracing.current(), "flatten", rows=2) as sp:
            sp.label(memo_hits=1)
        with rec.span(None, "ignored") as none:
            assert none is None
    finally:
        tracing.unbind(tok)
    assert tracing.current() is None
    waiter.adopt_spans(flush.spans)
    assert [s.name for s in waiter.spans] == ["flatten"]
    assert waiter.spans[0].labels == {"rows": 2, "memo_hits": 1}
    rec.finish(flush)
    rec.finish(waiter)
