"""Chaos/storm scenario suite: prove the SLO loop degrades AND recovers.

Each scenario replays one synthesized trace through the replay harness
three times over a single serving stack — *baseline* (undisturbed),
*episode* (with a fault injected), *recovery* (fault reverted, after the
controller returns to healthy) — and asserts the closed-loop contract
end to end:

- the watchdog degrades during the episode and the controller engages
  its action ladder (enter/exit timestamps land in the action log and
  the run manifest);
- episode p99 stays inside the scenario's degraded budget — the actions
  (shed, geometry, host-lane bounding + circuit breaking) cap the
  damage instead of letting the fault stack latency unboundedly;
- recovery is automatic: the degraded gauge returns to 0 with no
  restart, every action exits, and the recovery run's verdict digest is
  bit-identical to the baseline;
- drift is never silent: if the episode digest differs from baseline,
  the explicitly-reported shed set must be non-empty (the only verdict
  surface any action may touch).

Four injectors, one per failure family the storm knobs model:
``arrival_storm`` (slow concurrent admission spam), ``policy_churn_storm``
(generation churn under load), ``oracle_brownout`` (a browned-out
OraclePool behind the guarded submission path), ``replica_loss`` (leader
death + lease takeover while the survivor degrades). Every scenario also
runs with ``KTPU_SLO_ACTIONS=0`` in the smoke gate to pin the
annotate-only parity floor.

Latency injection wraps ``WebhookServer._resource_validation`` — inside
``_handle``'s elapsed measurement — so the watchdog actually sees the
injected latency; wrapping ``handle`` would be invisible to it.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

SCENARIOS = ("arrival_storm", "policy_churn_storm", "oracle_brownout",
             "replica_loss")

# two enforce pattern policies over Pods — enough surface for real
# denies (digest has signal) and a non-trivial shed ranking
CHAOS_POLICY_DOCS = [
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "chaos-disallow-latest"},
     "spec": {"validationFailureAction": "enforce",
              "background": True, "rules": [{
                  "name": "validate-image-tag",
                  "match": {"resources": {"kinds": ["Pod"]}},
                  "validate": {"message": "latest tag banned",
                               "pattern": {"spec": {"containers": [
                                   {"image": "!*:latest"}]}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "chaos-require-team"},
     "spec": {"validationFailureAction": "enforce",
              "background": True, "rules": [{
                  "name": "check-team",
                  "match": {"resources": {"kinds": ["Pod"]}},
                  "validate": {"message": "team label required",
                               "pattern": {"metadata": {"labels": {
                                   "team": "?*"}}}}}]}},
]

# audit-mode churn payload: splicing it in/out bumps the policy
# generation (recompiles, pool rebuilds) without touching the enforce
# verdict surface — churn the machinery, not the answers
CHURN_POLICY_DOC = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "chaos-churn-audit"},
    "spec": {"validationFailureAction": "audit",
             "background": True, "rules": [{
                 "name": "note-owner",
                 "match": {"resources": {"kinds": ["Pod"]}},
                 "validate": {"message": "owner label suggested",
                              "pattern": {"metadata": {"labels": {
                                  "owner": "?*"}}}}}]},
}


def fast_env(actions: str = "1") -> dict:
    """Scenario knob profile: second-scale watchdog windows + hysteresis
    so a full degrade→act→recover episode fits a CI gate."""
    return {
        "KTPU_SLO": "1",
        "KTPU_SLO_BUDGET_S": "0.30",
        "KTPU_SLO_WINDOW_SHORT_S": "1.0",
        "KTPU_SLO_WINDOW_LONG_S": "2.0",
        "KTPU_SLO_MIN_SAMPLES": "4",
        "KTPU_SLO_BURN_DEGRADED": "1.0",
        "KTPU_SLO_ACTIONS": actions,
        "KTPU_SLO_TICK_S": "0.05",
        "KTPU_SLO_DEGRADE_AFTER_S": "0.0",
        "KTPU_SLO_RECOVER_AFTER_S": "0.2",
        "KTPU_SLO_MIN_DWELL_S": "0.1",
        "KTPU_SLO_SHED_MAX": "1",
        "KTPU_SLO_POOL_TIMEOUT_S": "0.05",
        "KTPU_SLO_POOL_RETRIES": "1",
        "KTPU_SLO_BREAKER_THRESHOLD": "3",
        "KTPU_SLO_BREAKER_COOLDOWN_S": "0.5",
    }


@contextmanager
def env_overrides(overrides: dict):
    """Pin environment switches for one scenario, restoring previous
    values (or absence) on exit."""
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _reset_planes() -> None:
    """Scenario isolation: pristine watchdog windows, controller state,
    and pool circuit."""
    from ..runtime import sloactions
    from ..runtime.slo import watchdog

    watchdog().clear()
    sloactions.controller().reset()
    sloactions.circuit().reset()


# --------------------------------------------------------------- injectors


@contextmanager
def inject_latency(webhook, delay_s: float):
    """Stall every resource validation by ``delay_s`` — inside the
    webhook's elapsed measurement, so the watchdog sees it."""
    orig = webhook._resource_validation

    def slow(request):
        time.sleep(delay_s)
        return orig(request)

    webhook._resource_validation = slow
    try:
        yield
    finally:
        del webhook._resource_validation


class BrownoutPool:
    """Browned-out OraclePool stand-in: always warm, every submission
    burns ``min(latency_s, timeout_s)`` of wall clock and then misses
    (returns None — the pool's miss contract, so callers fall back to
    the inline oracle and verdicts are untouched). Mirrors the
    OraclePool surface the webhook/hostlane consumers use."""

    MIN_CORES = 0

    def __init__(self, latency_s: float = 0.35):
        self.enabled = True
        self.workers = 2
        self.latency_s = latency_s
        self.stats = {"submitted": 0, "misses": 0}

    def ready(self, generation) -> bool:
        return True

    def ensure(self, generation, policies) -> None:
        pass

    def _brown(self, timeout_s: float):
        self.stats["submitted"] += 1
        self.stats["misses"] += 1
        time.sleep(min(self.latency_s, max(0.0, timeout_s)))
        return None

    def evaluate(self, policy_names, resource, request, namespace_labels,
                 roles, cluster_roles, exclude_group_role,
                 timeout_s: float = 3.0):
        return self._brown(timeout_s)

    def evaluate_payload(self, policy_names, resource, payload,
                         timeout_s: float = 3.0):
        return self._brown(timeout_s)

    def stop(self) -> None:
        pass


@contextmanager
def inject_brownout(webhook, latency_s: float = 0.35):
    """Swap a :class:`BrownoutPool` in as the webhook's oracle pool and
    route one guarded submission per admission through it — the
    protection plan (shrunk timeout, bounded retry, circuit breaking)
    is what keeps the brownout from stacking its full latency onto
    every review. The real (dormant on small hosts) pool is restored on
    exit."""
    from ..runtime import sloactions

    pool = BrownoutPool(latency_s=latency_s)
    orig_pool = webhook.oracle_pool
    orig_validation = webhook._resource_validation
    webhook.oracle_pool = pool

    def browned(request):
        gen = webhook.policy_cache.generation
        sloactions.pool_evaluate(
            pool, gen,
            lambda timeout_s: pool.evaluate_payload([], {}, {},
                                                    timeout_s=timeout_s))
        return orig_validation(request)

    webhook._resource_validation = browned
    try:
        yield pool
    finally:
        del webhook._resource_validation
        webhook.oracle_pool = orig_pool


@contextmanager
def inject_policy_churn(policy_cache, period_s: float = 0.05):
    """Background thread splicing an audit policy in and out of the
    cache — continuous generation churn (recompiles, shed re-ranks,
    pool generation invalidation) with zero enforce-verdict impact. The
    cache is restored to its original content on exit."""
    from ..api.load import load_policy

    churn_policy = load_policy(CHURN_POLICY_DOC)
    stop = threading.Event()
    flips = [0]

    def loop():
        present = False
        while not stop.wait(period_s):
            try:
                if present:
                    policy_cache.remove(churn_policy)
                else:
                    policy_cache.add(churn_policy)
                present = not present
                flips[0] += 1
            except Exception:
                pass
        if present:
            try:
                policy_cache.remove(churn_policy)
            except Exception:
                pass

    t = threading.Thread(target=loop, name="chaos-policy-churn",
                         daemon=True)
    t.start()
    try:
        yield flips
    finally:
        stop.set()
        t.join(timeout=5.0)


@contextmanager
def shrunk_lease(duration_s: float = 0.6):
    """Compress the leader-election lease constants so holder death and
    takeover play out on scenario timescales."""
    from ..runtime import leaderelection as le

    saved = (le.LEASE_DURATION_S, le.RENEW_DEADLINE_S, le.RETRY_PERIOD_S)
    le.LEASE_DURATION_S = duration_s
    le.RENEW_DEADLINE_S = duration_s * 0.66
    le.RETRY_PERIOD_S = duration_s / 10.0
    try:
        yield
    finally:
        (le.LEASE_DURATION_S, le.RENEW_DEADLINE_S,
         le.RETRY_PERIOD_S) = saved


@contextmanager
def inject_replica_loss(results: dict):
    """Two scanner replicas race a Lease on a fake cluster; the holder
    dies without releasing (thread stopped, holderIdentity left set)
    and the survivor must take over once the lease expires. Outcomes
    land in ``results``: holder identities and the takeover latency."""
    from ..runtime.client import FakeCluster
    from ..runtime.leaderelection import LeaderElector

    with shrunk_lease():
        cluster = FakeCluster()
        a = LeaderElector(cluster, identity="scanner-a",
                          name="chaos-lease")
        b = LeaderElector(cluster, identity="scanner-b",
                          name="chaos-lease")
        a.run(retry_period_s=0.05)
        b.run(retry_period_s=0.05)
        deadline = time.monotonic() + 3.0
        while (not a.is_leader()) and time.monotonic() < deadline:
            time.sleep(0.01)
        results["first_leader"] = "scanner-a" if a.is_leader() else None
        results["race_single_leader"] = (a.is_leader()
                                         and not b.is_leader())
        # holder death: stop the loop WITHOUT stop() — the lease keeps
        # scanner-a's identity and must expire before b can take over
        a._stop.set()
        t0 = time.monotonic()
        try:
            deadline = time.monotonic() + 5.0
            while (not b.is_leader()) and time.monotonic() < deadline:
                time.sleep(0.01)
            results["takeover"] = b.is_leader()
            results["takeover_s"] = round(time.monotonic() - t0, 3)
            yield results
        finally:
            b.stop()


# ----------------------------------------------------------------- runner


def _wait_healthy(timeout_s: float = 12.0) -> bool:
    """Tick the controller until it recovers (watchdog windows drain
    once the fault is reverted; the empty short window fails the
    min-samples vote, so degraded clears without traffic)."""
    from ..runtime import sloactions
    from ..runtime.slo import watchdog

    ctl = sloactions.controller()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ctl.tick(watchdog().snapshot())
        if ctl.state == "healthy" and not ctl.active_actions():
            return True
        time.sleep(0.05)
    return False


def run_scenario(name: str, events: int = 60, delay_s: float = 0.4,
                 p99_budget_ms: float | None = None, workers: int = 6,
                 actions: str = "1", seed: int = 42,
                 manifest_path: str | None = None, device=None) -> dict:
    """One full chaos episode: baseline → fault → recovery, all three
    replays stamped into a single run manifest (legs relabelled by
    phase so they can't collide). Returns a report with named boolean
    ``checks``; ``ok`` is their conjunction.

    ``p99_budget_ms=None`` derives the degraded budget from the fault
    itself: the open-loop queue drain of ``events`` stalls of
    ``delay_s`` across ``workers`` plus fixed slack — the actions must
    keep the episode inside the queueing math, not magically erase an
    injected sleep. The stack runs on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown chaos scenario {name!r}")
    if p99_budget_ms is None:
        p99_budget_ms = (events * delay_s / workers + 2.5) * 1e3
    from ..api.load import load_policy
    from ..runtime import metrics as metrics_mod
    from ..runtime import sloactions
    from ..runtime.slo import watchdog
    from .replay import ReplayDriver, build_stack, run_manifest, stop_stack
    from .trace import synthesize

    pols = [load_policy(d) for d in CHAOS_POLICY_DOCS]
    with env_overrides(fast_env(actions)):
        _reset_planes()
        trace = synthesize(events=events, namespaces=4, name_pool=24,
                           distinct_bodies=12, storm_factor=8.0,
                           storm_period=max(10, events // 3), seed=seed)
        stack = build_stack(pols, device=device)
        drv = ReplayDriver.from_stack(stack)
        ctl = sloactions.controller()
        loss: dict = {}
        try:
            # warm pass off the books: cold shape buckets blow the
            # second-scale budget and would degrade the controller
            # DURING the reference run — warm first, then reset the SLO
            # planes so the measured baseline is genuinely undisturbed
            drv.run(trace, "webhook", workers=workers)
            _reset_planes()
            baseline = drv.run(trace, "webhook", workers=workers)
            baseline_clean = ctl.stats["degraded_entered"] == 0

            if name == "arrival_storm":
                injector = inject_latency(stack["webhook"], delay_s)
            elif name == "policy_churn_storm":
                injector = inject_policy_churn(stack["policy_cache"])
            elif name == "oracle_brownout":
                injector = inject_brownout(stack["webhook"],
                                           latency_s=delay_s)
            else:
                injector = inject_replica_loss(loss)

            with injector:
                if name in ("policy_churn_storm", "replica_loss"):
                    # these faults don't slow admissions by themselves;
                    # ride a latency stall so the watchdog degrades and
                    # the actions engage *during* the fault
                    with inject_latency(stack["webhook"], delay_s):
                        episode = drv.run(trace, "webhook",
                                          workers=workers)
                else:
                    episode = drv.run(trace, "webhook", workers=workers)
                ctl.tick(watchdog().snapshot())
                mid_report = ctl.report()

            recovered = _wait_healthy()
            # the recovery proof is the line above: the gauge fell to 0
            # with no restart. Capture it now, then drain the watchdog
            # windows — the long window can hold the fault's tail for
            # seconds, and the parity leg must be judged on its own
            # samples, not the episode's
            degraded_gauge = (metrics_mod.registry().gauge_value(
                "kyverno_slo_degraded") or 0.0)
            watchdog().clear()
            recovery = drv.run(trace, "webhook", workers=workers)
            final_snap = watchdog().snapshot()
            ctl.tick(final_snap)
            record = ctl.manifest_record()
            legs = []
            for phase, r in (("baseline", baseline),
                             ("episode", episode),
                             ("recovery", recovery)):
                legs.append(dict(r, leg=f"webhook:{phase}"))
            manifest = run_manifest(trace, legs, path=manifest_path,
                                    note=f"chaos:{name}", slo=record)
        finally:
            stop_stack(stack)

        reg = metrics_mod.registry()
        log = record["action_log"]
        entered = {e["action"] for e in log if e["event"] == "enter"}
        exited = {e["action"] for e in log if e["event"] == "exit"}
        shed_reported = sorted({p for e in log
                                for p in e.get("shed", ())})
        checks = {
            "baseline_undisturbed": baseline_clean,
            "degraded_seen": ctl.stats["degraded_entered"] >= 1,
            "recovered": recovered and record["state"] == "healthy",
            "degraded_gauge_zero": degraded_gauge == 0.0,
            "p99_bounded": episode["latency_ms_p99"] <= p99_budget_ms,
            "recovery_digest_matches": (recovery["verdict_digest"]
                                        == baseline["verdict_digest"]),
            "drift_never_silent": (
                episode["verdict_digest"] == baseline["verdict_digest"]
                or bool(shed_reported) or bool(mid_report["shed"])),
            "state_seconds_accounted": (
                record["state_seconds"].get("degraded", 0.0) > 0.0),
        }
        if actions == "1":
            checks["actions_logged"] = bool(entered) and entered <= exited
        else:
            # annotate-only parity: no action may ever engage, and the
            # fault must not move a single verdict
            checks["no_actions_engaged"] = not log
            checks["episode_digest_matches"] = (
                episode["verdict_digest"] == baseline["verdict_digest"])
        if name == "oracle_brownout":
            checks["circuit_opened"] = (
                record.get("enabled", False) is False
                or sloactions.circuit().stats["opened"] >= 1
                or actions != "1")
        if name == "replica_loss":
            checks["takeover"] = bool(loss.get("takeover"))
            checks["race_single_leader"] = bool(
                loss.get("race_single_leader"))
            if actions == "1":
                checks["scale_hint_emitted"] = (
                    mid_report["scale_hint"]["replicas_delta"] >= 1)
        return {
            "scenario": name,
            "ok": all(checks.values()),
            "checks": checks,
            "episode_p99_ms": episode["latency_ms_p99"],
            "baseline_p99_ms": baseline["latency_ms_p99"],
            "recovery_p99_ms": recovery["latency_ms_p99"],
            "p99_budget_ms": p99_budget_ms,
            "action_log": log,
            "shed": shed_reported or record["shed"] or mid_report["shed"],
            "transitions": record["transitions"],
            "replica_loss": loss or None,
            "manifest": manifest,
        }


def run_suite(scenarios=SCENARIOS, **kwargs) -> dict:
    """All scenarios against fresh stacks; ``ok`` requires every
    scenario's every check."""
    reports = {name: run_scenario(name, **kwargs) for name in scenarios}
    return {"ok": all(r["ok"] for r in reports.values()),
            "scenarios": reports}
