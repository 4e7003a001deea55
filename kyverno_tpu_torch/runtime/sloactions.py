"""Closed-loop SLO degradation controller: explicit, ordered, reversible.

The watchdog (runtime/slo.py) observes burn rate and annotates; this
module closes the loop. A :class:`DegradationController` consumes watchdog
snapshots through a hysteresis state machine (degrade fast, recover slow,
minimum dwell — the controller cannot flap) and, while degraded, engages
an ordered ladder of load-shedding actions. Every action is individually
kill-switchable, reversible on recovery, and reported — never silent:

1. **shed** (``KTPU_SLO_SHED``) — drop low-severity enforce policies from
   the deny path. Candidates are policies whose static-analysis findings
   stay below ERROR (lint severities, analysis/diagnostics.py), ranked by
   per-policy attribution impact (FAIL/ERROR verdict counts from the
   metrics attribution plane) so the least-blocking policies shed first.
   The shed set is explicit: exposed on ``/healthz``, gauged in
   ``kyverno_slo_shed_policies``, and stamped into replay manifests.
2. **geometry** (``KTPU_SLO_GEOMETRY``) — switch the admission batcher to
   a latency-optimized profile: coalescing windows scaled by
   ``KTPU_SLO_WINDOW_FACTOR``, the admission pad floor shrunk to
   ``KTPU_SLO_PAD_FLOOR``, continuous late-join grafting suspended.
   Padding and windows never touch verdict values, so the non-shed set
   stays bit-identical in every state.
3. **hostbound** (``KTPU_SLO_HOSTBOUND``) — bound host-lane fan-out to
   ``KTPU_SLO_FANOUT_MAX`` concurrent rows and run every OraclePool
   submission through :func:`pool_evaluate`: shrunk timeout, bounded
   retry with backoff, and the :class:`PoolCircuit` breaker whose
   half-open probes are *generation-guarded* — a probe only closes the
   circuit if the pool generation it probed is still current, so a
   rebuilt pool (new policy generation) re-earns trust explicitly.
4. **scale_hints** (``KTPU_SLO_SCALE_HINTS``) — emit a replica scale
   hint (burn-rate proportional) on ``/healthz`` for an external
   autoscaler; advisory only.

``KTPU_SLO_ACTIONS=0`` (the default) keeps the whole plane annotate-only:
ticks still account state time into ``kyverno_slo_state_seconds_total``
(so a degraded stretch with an empty flush queue leaves evidence — the
``slo_degraded_flushes`` stat only moves when a flush fires), but no
action ever engages and every consult below degenerates to today's
behavior bit for bit. The JAX package's chaos/storm suite is its parity
gate; the port's is the JAX battery run on the port
(tests/test_torch_planes.py).
"""

from __future__ import annotations

import math
import threading
import time

from . import featureplane
from . import metrics as metrics_mod

# ladder order is report order; engagement is simultaneous on the
# degraded transition (each rung individually switchable)
ACTIONS = ("shed", "geometry", "hostbound", "scale_hints")

# OraclePool.evaluate's historical default — what an unguarded
# submission has always used; pool_evaluate restores it exactly when
# the master switch is off
POOL_TIMEOUT_DEFAULT_S = 3.0


def actions_enabled() -> bool:
    """Master switch for the closed loop; "0" (the default) restores the
    annotate-only behavior exactly."""
    return featureplane.enabled_strict("KTPU_SLO_ACTIONS")


def shed_enabled() -> bool:
    return featureplane.enabled("KTPU_SLO_SHED")


def geometry_enabled() -> bool:
    return featureplane.enabled("KTPU_SLO_GEOMETRY")


def hostbound_enabled() -> bool:
    return featureplane.enabled("KTPU_SLO_HOSTBOUND")


def scale_hints_enabled() -> bool:
    return featureplane.enabled("KTPU_SLO_SCALE_HINTS")


_ACTION_ENABLED = {"shed": shed_enabled, "geometry": geometry_enabled,
                   "hostbound": hostbound_enabled,
                   "scale_hints": scale_hints_enabled}


def _env_f(name: str, default: float) -> float:
    try:
        return float(featureplane.raw(name))
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return int(featureplane.raw(name))
    except ValueError:
        return default


def degrade_after_s() -> float:
    return max(0.0, _env_f("KTPU_SLO_DEGRADE_AFTER_S", 0.5))


def recover_after_s() -> float:
    return max(0.0, _env_f("KTPU_SLO_RECOVER_AFTER_S", 3.0))


def min_dwell_s() -> float:
    return max(0.0, _env_f("KTPU_SLO_MIN_DWELL_S", 1.0))


def tick_period_s() -> float:
    return max(0.01, _env_f("KTPU_SLO_TICK_S", 0.25))


def shed_max() -> int:
    return max(0, _env_i("KTPU_SLO_SHED_MAX", 1))


def window_factor() -> float:
    return min(1.0, max(0.01, _env_f("KTPU_SLO_WINDOW_FACTOR", 0.25)))


def degraded_pad_floor() -> int:
    return max(1, _env_i("KTPU_SLO_PAD_FLOOR", 8))


def fanout_max() -> int:
    return max(1, _env_i("KTPU_SLO_FANOUT_MAX", 2))


def pool_timeout_s() -> float:
    return max(0.001, _env_f("KTPU_SLO_POOL_TIMEOUT_S", 0.5))


def pool_retries() -> int:
    return max(0, _env_i("KTPU_SLO_POOL_RETRIES", 1))


def breaker_threshold() -> int:
    return max(1, _env_i("KTPU_SLO_BREAKER_THRESHOLD", 3))


def breaker_cooldown_s() -> float:
    return max(0.0, _env_f("KTPU_SLO_BREAKER_COOLDOWN_S", 5.0))


# ------------------------------------------------------------ pool circuit


class PoolCircuit:
    """Circuit breaker around the OraclePool lane, host-lane side.

    Distinct from OraclePool's internal consecutive-miss cooldown: this
    one is generation-aware. States: ``closed`` (calls flow), ``open``
    (calls rejected; inline oracle serves), ``half_open`` (exactly one
    probe in flight). Open → half_open on cooldown expiry OR on a pool
    generation change (a rebuilt pool deserves an immediate probe); a
    half-open probe only closes the circuit when the generation it
    probed is still the current one — success against a stale worker set
    proves nothing about the live pool."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._open_generation = None
        self._probe_generation = None
        self.stats = {"opened": 0, "closed": 0, "probes": 0,
                      "rejected": 0, "failures": 0}

    def allow(self, generation) -> bool:
        """Gate one pool submission. Always True when the master or
        hostbound switch is off — the unguarded legacy dataflow."""
        if not (actions_enabled() and hostbound_enabled()):
            return True
        now = self._clock()
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                regenerated = (self._open_generation is not None
                               and generation != self._open_generation)
                if regenerated or now - self._opened_at \
                        >= breaker_cooldown_s():
                    self.state = "half_open"
                    self._probe_generation = generation
                    self.stats["probes"] += 1
                    return True
                self.stats["rejected"] += 1
                return False
            # half_open: one probe owns the lane
            self.stats["rejected"] += 1
            return False

    def record(self, ok: bool, generation) -> None:
        """Report the outcome of an allowed submission."""
        if not (actions_enabled() and hostbound_enabled()):
            return
        with self._lock:
            if ok:
                if (self.state == "half_open"
                        and generation != self._probe_generation):
                    # stale-generation probe: ignore, stay half-open for
                    # a probe against the live pool
                    return
                if self.state != "closed":
                    self.stats["closed"] += 1
                self.state = "closed"
                self._failures = 0
                self._open_generation = None
                return
            self.stats["failures"] += 1
            self._failures += 1
            if (self.state == "half_open"
                    or self._failures >= breaker_threshold()):
                self.state = "open"
                self._opened_at = self._clock()
                self._open_generation = generation
                self._failures = 0
                self.stats["opened"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self._failures,
                    "open_generation": self._open_generation,
                    **dict(self.stats)}

    def reset(self) -> None:
        with self._lock:
            self.state = "closed"
            self._failures = 0
            self._opened_at = 0.0
            self._open_generation = None
            self._probe_generation = None
            for k in self.stats:
                self.stats[k] = 0


_circuit: PoolCircuit | None = None
_circuit_lock = threading.Lock()


def circuit() -> PoolCircuit:
    global _circuit
    if _circuit is None:
        with _circuit_lock:
            if _circuit is None:
                _circuit = PoolCircuit()
    return _circuit


def pool_evaluate(pool, generation, submit):
    """Run one OraclePool submission under the host-lane protection plan.

    ``submit(timeout_s)`` performs the actual pool call and returns the
    results or None (the pool's miss contract). Master switch off: one
    unguarded call at the pool's historical default timeout — today's
    dataflow exactly. Master on: the circuit gates the call, the timeout
    shrinks while the hostbound action is engaged, misses retry with a
    short exponential backoff, and the outcome feeds the breaker."""
    if not (actions_enabled() and hostbound_enabled()):
        return submit(POOL_TIMEOUT_DEFAULT_S)
    cb = circuit()
    if not cb.allow(generation):
        return None
    timeout = (pool_timeout_s()
               if controller().action_active("hostbound")
               else POOL_TIMEOUT_DEFAULT_S)
    attempts = 1 + pool_retries()
    result = None
    for i in range(attempts):
        try:
            result = submit(timeout)
        except Exception:
            result = None
        if result is not None:
            break
        if i + 1 < attempts:
            # bounded backoff: a browned-out pool must not stack flat
            # timeouts onto every admission
            time.sleep(min(0.05 * (2 ** i), 0.2))
    cb.record(result is not None, generation)
    return result


def fanout_bound() -> int | None:
    """Host-lane fan-out cap, or None when unbounded (healthy /
    switched off)."""
    if controller().action_active("hostbound"):
        return fanout_max()
    return None


# --------------------------------------------------------- geometry plane


def geometry_active() -> bool:
    return controller().action_active("geometry")


def window_scale() -> float:
    """Multiplier on the batcher's coalescing window (1.0 healthy)."""
    return window_factor() if geometry_active() else 1.0


def effective_pad_floor(default: int) -> int:
    """Admission pad floor under the active geometry profile."""
    if geometry_active():
        return min(default, degraded_pad_floor())
    return default


# ------------------------------------------------------------- controller


class DegradationController:
    """Hysteresis state machine over watchdog snapshots + action ladder.

    ``tick()`` is the only mutation point; call sites (webhook reviews,
    batcher flushes, /healthz scrapes, the optional ticker thread) all
    route through ``maybe_tick`` so ticking stays O(1) amortized. The
    clock is injectable for deterministic tests."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "healthy"
        self._state_since = clock()
        self._last_tick: float | None = None
        self._flip_streak_start: float | None = None
        self._engaged: set[str] = set()
        self.shed: list[str] = []
        self._policy_cache = None
        self._shed_generation = None
        self._lint_cache: tuple = (None, {})
        self._last_snapshot: dict = {}
        self._state_seconds = {"healthy": 0.0, "degraded": 0.0}
        # bounded logs: enter/exit records for manifests & /healthz
        self.transitions: list[dict] = []
        self.action_log: list[dict] = []
        self.stats = {"ticks": 0, "degraded_entered": 0,
                      "recovered": 0, "shed_recomputes": 0}
        self._ticker: threading.Thread | None = None
        self._ticker_stop = threading.Event()

    # ------------------------------------------------------------ wiring

    def attach(self, policy_cache) -> None:
        """Give the shed action a policy source (the serving cache whose
        generation counter versions the lint/shed computations)."""
        with self._lock:
            self._policy_cache = policy_cache
            self._lint_cache = (None, {})

    def ensure_ticker(self) -> None:
        """Start the idle ticker (daemon) so degraded time is accounted
        and recovery detected even with zero traffic. Idempotent."""
        with self._lock:
            if self._ticker is not None and self._ticker.is_alive():
                return
            self._ticker_stop = threading.Event()
            t = threading.Thread(target=self._tick_loop,
                                 name="slo-actions-tick", daemon=True)
            self._ticker = t
        t.start()

    def stop_ticker(self) -> None:
        self._ticker_stop.set()
        with self._lock:
            self._ticker = None

    def _tick_loop(self) -> None:
        stop = self._ticker_stop
        while not stop.wait(tick_period_s()):
            try:
                self.tick()
            except Exception:
                pass

    # -------------------------------------------------------------- tick

    def maybe_tick(self) -> None:
        """Rate-limited tick for hot call sites (per-admission, per
        flush): no-op until a tick period has elapsed."""
        with self._lock:
            last = self._last_tick
        if last is not None and self._clock() - last < tick_period_s():
            return
        self.tick()

    def tick(self, snapshot: dict | None = None) -> dict:
        """One controller step: account state time, run hysteresis,
        reconcile the engaged action set. Returns the consumed watchdog
        snapshot."""
        if snapshot is None:
            try:
                from .slo import watchdog

                snapshot = watchdog().cached_snapshot(
                    max_age_s=tick_period_s())
            except Exception:
                snapshot = {"enabled": False, "degraded": False}
        now = self._clock()
        reg = metrics_mod.registry()
        with self._lock:
            last, self._last_tick = self._last_tick, now
            self.stats["ticks"] += 1
            if last is not None and now > last:
                dt = now - last
                self._state_seconds[self.state] = (
                    self._state_seconds.get(self.state, 0.0) + dt)
                try:
                    metrics_mod.record_slo_state_seconds(reg, self.state,
                                                         dt)
                except Exception:
                    pass
            degraded_sig = bool(snapshot.get("degraded"))
            self._hysteresis(degraded_sig, now)
            self._reconcile_actions(now, reg)
            self._last_snapshot = snapshot
        return snapshot

    def _hysteresis(self, degraded_sig: bool, now: float) -> None:
        """Degrade fast, recover slow, never flap (min dwell). Caller
        holds the lock."""
        flip_wanted = (degraded_sig if self.state == "healthy"
                       else not degraded_sig)
        if not flip_wanted:
            self._flip_streak_start = None
            return
        if self._flip_streak_start is None:
            self._flip_streak_start = now
        streak = now - self._flip_streak_start
        need = (degrade_after_s() if self.state == "healthy"
                else recover_after_s())
        if streak < need or now - self._state_since < min_dwell_s():
            return
        # transition
        if self.transitions:
            self.transitions[-1].setdefault("exit_t", time.time())
        new = "degraded" if self.state == "healthy" else "healthy"
        self.state = new
        self._state_since = now
        self._flip_streak_start = None
        self.transitions.append({"state": new, "enter_t": time.time()})
        del self.transitions[:-64]
        if new == "degraded":
            self.stats["degraded_entered"] += 1
        else:
            self.stats["recovered"] += 1

    def _reconcile_actions(self, now: float, reg) -> None:
        """Engagement = degraded AND master AND per-action switch;
        recomputed every tick so a switch flipped mid-episode takes
        effect at the next tick. Caller holds the lock."""
        if self.state == "degraded" and actions_enabled():
            desired = {a for a in ACTIONS if _ACTION_ENABLED[a]()}
        else:
            desired = set()
        for a in [a for a in ACTIONS if a in desired - self._engaged]:
            self._engaged.add(a)
            entry = {"action": a, "event": "enter", "t": time.time()}
            if a == "shed":
                self._recompute_shed(reg)
                # the set rides the log entry: a shed that exits before
                # anyone reads the controller is still reported
                entry["shed"] = list(self.shed)
            self.action_log.append(entry)
            try:
                metrics_mod.record_slo_action_transition(reg, a, "enter")
            except Exception:
                pass
        for a in [a for a in ACTIONS if a in self._engaged - desired]:
            self._engaged.discard(a)
            entry = {"action": a, "event": "exit", "t": time.time()}
            if a == "shed":
                entry["shed"] = list(self.shed)
                self.shed = []
                try:
                    metrics_mod.record_slo_shed_size(reg, 0)
                except Exception:
                    pass
            self.action_log.append(entry)
            try:
                metrics_mod.record_slo_action_transition(reg, a, "exit")
            except Exception:
                pass
        del self.action_log[:-128]
        if "shed" in self._engaged:
            # policy churn mid-episode: re-rank against the new generation
            cache = self._policy_cache
            gen = getattr(cache, "generation", None)
            if gen != self._shed_generation:
                self._recompute_shed(reg)

    # -------------------------------------------------------------- shed

    def _recompute_shed(self, reg) -> None:
        """Shed set = lint-low-severity enforce policies, least
        attribution impact first, capped at KTPU_SLO_SHED_MAX. Caller
        holds the lock."""
        cache = self._policy_cache
        if cache is None:
            self.shed = []
            return
        try:
            gen, policies = cache.snapshot()
        except Exception:
            self.shed = []
            return
        self._shed_generation = gen
        self.stats["shed_recomputes"] += 1
        severities = self._lint_severities(gen, policies)
        impact = _attribution_impact()
        candidates = []
        for p in policies:
            try:
                action = (p.spec.validation_failure_action or "").lower()
            except Exception:
                action = ""
            if action != "enforce":
                continue            # audit policies never block anyway
            if severities.get(p.name, 0) >= 2:   # Severity.ERROR
                continue            # never shed an ERROR-flagged policy
            candidates.append((impact.get(p.name, 0), p.name))
        candidates.sort()
        self.shed = [name for _, name in candidates[:shed_max()]]
        try:
            metrics_mod.record_slo_shed_size(reg, len(self.shed))
        except Exception:
            pass

    def _lint_severities(self, gen, policies) -> dict:
        """{policy name: max lint severity int}, computed once per
        policy generation (analysis is static; generation versions it)."""
        cached_gen, sevs = self._lint_cache
        if cached_gen == gen:
            return sevs
        sevs = {}
        try:
            from ..analysis.analyzer import analyze_policies

            report = analyze_policies(policies, include_tensors=False)
            for d in report.diagnostics:
                if d.policy:
                    sevs[d.policy] = max(sevs.get(d.policy, 0),
                                         int(d.severity))
        except Exception:
            sevs = {}
        self._lint_cache = (gen, sevs)
        return sevs

    def shed_active_names(self) -> frozenset:
        """Enforce policies currently downgraded out of the deny path
        (empty unless the shed action is engaged)."""
        if not self.action_active("shed"):
            return frozenset()
        with self._lock:
            return frozenset(self.shed)

    # ------------------------------------------------------------- query

    def action_active(self, name: str) -> bool:
        with self._lock:
            if name not in self._engaged:
                return False
        return actions_enabled() and _ACTION_ENABLED[name]()

    def active_actions(self) -> list[str]:
        return [a for a in ACTIONS if self.action_active(a)]

    def scale_hint(self) -> dict:
        """Advisory replica delta for an external autoscaler, burn-rate
        proportional while degraded."""
        if not self.action_active("scale_hints"):
            return {"replicas_delta": 0, "reason": "inactive"}
        burn = ((self._last_snapshot.get("burn_rate") or {})
                .get("short") or 0.0)
        delta = max(1, min(4, int(math.ceil(burn))))
        return {"replicas_delta": delta,
                "reason": f"slo degraded, short burn {burn:.2f}"}

    def report(self) -> dict:
        """/healthz payload: full controller state for an operator
        reading an episode live."""
        now = self._clock()
        with self._lock:
            state = self.state
            since = now - self._state_since
            seconds = dict(self._state_seconds)
            log = list(self.action_log[-32:])
            shed = sorted(self.shed)
        return {
            "enabled": actions_enabled(),
            "state": state,
            "state_since_s": round(since, 3),
            "state_seconds": {k: round(v, 3)
                              for k, v in seconds.items()},
            "actions": {a: self.action_active(a) for a in ACTIONS},
            "shed": shed,
            "scale_hint": self.scale_hint(),
            "circuit": circuit().snapshot(),
            "action_log": log,
            "hysteresis": {"degrade_after_s": degrade_after_s(),
                           "recover_after_s": recover_after_s(),
                           "min_dwell_s": min_dwell_s()},
            "ticks": self.stats["ticks"],
        }

    def manifest_record(self) -> dict:
        """Replay-manifest stamp: enough to make a degraded A/B run
        impossible to compare silently against a healthy one."""
        with self._lock:
            return {
                "enabled": actions_enabled(),
                "state": self.state,
                "actions_active": [a for a in ACTIONS
                                   if a in self._engaged],
                "shed": sorted(self.shed),
                "state_seconds": {k: round(v, 3)
                                  for k, v in self._state_seconds.items()},
                "transitions": [dict(t) for t in self.transitions],
                "action_log": [dict(e) for e in self.action_log],
            }

    def reset(self) -> None:
        """Back to pristine healthy state (tests, scenario isolation)."""
        self.stop_ticker()
        with self._lock:
            self.state = "healthy"
            self._state_since = self._clock()
            self._last_tick = None
            self._flip_streak_start = None
            self._engaged = set()
            self.shed = []
            self._shed_generation = None
            self._last_snapshot = {}
            self._state_seconds = {"healthy": 0.0, "degraded": 0.0}
            self.transitions = []
            self.action_log = []
            for k in self.stats:
                self.stats[k] = 0


def _attribution_impact() -> dict:
    """{policy: FAIL+ERROR verdict count} from the bounded attribution
    plane — the 'which policy actually blocks' ranking."""
    impact: dict = {}
    try:
        st = metrics_mod.attrib_state()
        with st.lock:
            for (policy, _rule), verdicts in st.members.items():
                impact[policy] = (impact.get(policy, 0)
                                  + verdicts.get("FAIL", 0)
                                  + verdicts.get("ERROR", 0))
    except Exception:
        pass
    return impact


_controller: DegradationController | None = None
_controller_lock = threading.Lock()


def controller() -> DegradationController:
    global _controller
    if _controller is None:
        with _controller_lock:
            if _controller is None:
                _controller = DegradationController()
    return _controller
