"""Admission micro-batcher: the host batching shim of the device path.

The batcher coalesces concurrent admission resources into one device
evaluation: requests arriving within a micro-batch window are flattened
together, scored as one policy x resource matrix, and their verdict rows
scattered back to the waiting handlers.

The device acts as a *screen*: a resource whose row is all
PASS/SKIP/NOT_APPLICABLE is admitted without touching the CPU engine (the
common case); any FAIL/ERROR/HOST cell routes that one resource to the
full oracle for faithful rule messages and context-dependent semantics.
Wrong-way cost is therefore latency only, never correctness.

The screen is also *latency-aware and self-calibrating*: a lone request
routes straight to the CPU oracle instead of paying the micro-batch
window plus a device round trip for a batch of one — the device only
wins when there is a batch to amortize it over. The router compares a
measured EMA of device dispatch cost (updated by every flush, kept fresh
by occasional *shadow probes* that never block a request) against the
measured CPU-oracle cost times the current admission concurrency. The
whole exchange is bounded by a deadline budget derived from the
admission webhook timeout.

A warm flush dispatches through K6 (``evaluate_device_async(batch,
donate=True)``: pinned staging and a persistent device blob per shape
bucket); a flush's HOST cells resolve through the host lane, whose
admission payloads may go to an attached ``OraclePool``.

This is the JAX package's batcher. Its SLO-actions plane
(runtime/sloactions.py) scales the coalescing window, lowers the pad
floor and suspends the late-join graft while its geometry profile is
engaged, and every flush feeds the metrics registry; both sit behind a
``try`` and neither changes a verdict. With a fleet fabric attached
(``fleet/fabric.attach_stack``) and ``KTPU_FABRIC`` on, a local
result-cache miss reads through to decisions other replicas computed,
and every decision this batcher caches is published there.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from ..models import Verdict
from . import featureplane, tracing

CLEAN = "clean"          # every cell PASS/SKIP/NOT_APPLICABLE
ATTENTION = "attention"  # some cell FAIL/ERROR/HOST -> oracle lane
ORACLE = "oracle"        # low arrival rate -> skip the device entirely

_log = logging.getLogger(__name__)

# default admission webhook timeout; the screen's deadline budget is a
# fraction of it so the oracle lane always has time to answer within the
# API server's patience even after a device miss
WEBHOOK_TIMEOUT_S = 10.0
SCREEN_DEADLINE_S = WEBHOOK_TIMEOUT_S / 4


def _slo_geometry_active() -> bool:
    """Whether the SLO degradation controller's latency-optimized
    geometry profile is engaged (runtime/sloactions.py). False whenever
    the actions plane is off — the healthy geometry is the default."""
    try:
        from . import sloactions

        return sloactions.geometry_active()
    except Exception:
        return False


def _slo_window_scale() -> float:
    """Coalescing-window multiplier under the geometry profile (1.0
    healthy)."""
    try:
        from . import sloactions

        return sloactions.window_scale()
    except Exception:
        return 1.0


def stream_enabled() -> bool:
    """KTPU_STREAM=0 kill switch for continuous batching: off restores
    the window-flush semantics bit for bit (a forming batch closes at
    drain time; nothing joins a flush after padding). Dynamic, like
    every KTPU_* lane flag."""
    return featureplane.enabled("KTPU_STREAM")


def ttl_store(cache: dict, key, ttl_s: float, value: tuple,
              max_size: int = 4096) -> None:
    """Insert ``(expiry, *value)`` with the shared eviction policy:
    sweep expired entries when full, clear wholesale if still full.
    The caller holds whatever lock guards ``cache``."""
    if len(cache) >= max_size:
        cutoff = time.monotonic()
        for k in [k for k, v in cache.items() if v[0] <= cutoff]:
            del cache[k]
        if len(cache) >= max_size:
            cache.clear()
    cache[key] = (time.monotonic() + ttl_s, *value)


def verdict_to_status(verdict: Verdict):
    """Device verdict -> RuleStatus (None for non-statuses like HOST)."""
    from ..engine.response import RuleStatus

    return {
        Verdict.PASS: RuleStatus.PASS,
        Verdict.FAIL: RuleStatus.FAIL,
        Verdict.SKIP: RuleStatus.SKIP,
        Verdict.ERROR: RuleStatus.ERROR,
    }.get(verdict)


class _Bucket:
    _seq = itertools.count()

    def __init__(self, cps):
        self.cps = cps
        # (resource, ctx_cb | None, Future): ctx_cb lazily builds the
        # admission context payload a flush needs to resolve HOST cells
        self.items: list[tuple] = []
        self.seq = next(self._seq)    # stable identity (id() gets reused)


class AdmissionBatcher:
    """Micro-batching device screen over policy_cache.compiled() sets."""

    def __init__(self, policy_cache, window_s: float = 0.004,
                 max_batch: int = 512, burst_threshold: int = 4,
                 rate_window_s: float = 0.05,
                 oracle_cost_init_s: float = 0.002,
                 dispatch_cost_init_s: float = 0.150,
                 probe_interval_s: float = 10.0,
                 cold_flush_fallback: bool = True,
                 circuit_timeout_threshold: int = 3,
                 circuit_cooldown_s: float = 5.0,
                 result_cache_ttl_s: float = 1.0,
                 result_cache_max: int = 4096,
                 resolve_host_in_flush: bool = True,
                 row_cache_max: int = 4096,
                 continuous: bool = False):
        self.policy_cache = policy_cache
        self.window_s = window_s
        self.max_batch = max_batch
        # continuous batching (streaming plane): a flush that padded its
        # batch to a pow2/PAD_FLOOR bucket has free row slots — late
        # arrivals graft into that headroom until dispatch actually
        # fires, instead of waiting out the next window. Effective only
        # while the KTPU_STREAM switch is on (checked per flush).
        self.continuous = continuous
        # a device dispatch only pays off once this many requests are
        # concurrently in flight; below that the CPU oracle beats the
        # micro-batch window + device round trip for a batch of one
        self.burst_threshold = burst_threshold
        self.rate_window_s = rate_window_s
        self.probe_interval_s = probe_interval_s
        # release waiters to the oracle when a flush is the first of a new
        # shape bucket of its compiled set (tests that assert on
        # first-flush verdicts turn this off)
        self.cold_flush_fallback = cold_flush_fallback
        # cost model (seconds), self-calibrating: dispatch starts
        # pessimistic so a remote/tunneled chip is never trusted until a
        # shadow probe has actually measured it; oracle cost is tracked
        # per policy so the model scales with the enforce set size, and
        # the screen's value is discounted by the measured fraction of
        # oracle work it actually eliminates (a screen that mostly returns
        # ATTENTION saves little)
        self._oracle_policy_cost = oracle_cost_init_s
        self._dispatch_cost = dispatch_cost_init_s
        self._savings_frac = 0.5
        # HOST CPU seconds a flush burns (flatten + dispatch bookkeeping,
        # measured with thread_time so device waits don't count): the
        # device lane's true cost on the contended resource. Wall
        # dispatch time is mostly idle device wait — the GIL is released —
        # so comparing it against oracle CPU time would starve the device
        # lane exactly when the oracle queue is longest
        self._flush_cpu_cost = 0.003
        # flushes currently submitted/running: scales the latency model
        # (a new flush queues behind them on the link)
        self._pending_flushes = 0
        # realized flush size: a dispatch only amortizes over the batch
        # that actually formed, not over the instantaneous concurrency
        self._batch_size_ema = 4.0
        self._last_dispatch = 0.0
        # screen-timeout circuit breaker: consecutive *flushes* whose
        # waiters gave up are direct evidence the device lane is slower
        # than the model thinks (queue depth, a stalled device); the breaker
        # routes everything to the oracle for a cooldown instead of
        # letting new requests pile onto a lane that is already failing
        # its own deadline. Counted per flush — one slow dispatch strands
        # all its waiters but is one event, not len(waiters) events — and
        # cold-flush waits are excluded like _flush excludes them from
        # the dispatch EMA.
        self._consecutive_timeouts = 0
        self._timed_out_flushes: set[int] = set()
        self._circuit_open_until = 0.0
        self.circuit_timeout_threshold = circuit_timeout_threshold
        self.circuit_cooldown_s = circuit_cooldown_s
        self.stats = {"oracle": 0, "device": 0, "probe": 0,
                      "clean": 0, "attention": 0}
        # flush-level HOST-cell resolution: cluster-independent host-lane
        # rules (oracle_pool.pool_safe policies) resolve in ONE batched
        # oracle pass per flush instead of per-request full evaluations in
        # the webhook — the screen's answer becomes decisive for them
        self.resolve_host_in_flush = resolve_host_in_flush
        # short-TTL screen-result cache: admission bursts are dominated by
        # near-identical resources (a Deployment scaling N replicas
        # submits N near-identical Pods), and the screen row is a pure
        # function of (compiled policy set, resource bytes) — the same
        # determinism that lets CLEAN admit without the oracle. Only
        # device-answered rows cache; TTL bounds staleness and a policy
        # change rotates the CompiledPolicySet identity out of every key.
        self.result_cache_ttl_s = result_cache_ttl_s
        self.result_cache_max = result_cache_max
        self._result_cache: dict = {}
        # flatten-row memo: per-resource flattened rows keyed by
        # (tensors memo space, resource digest). Orthogonal to the
        # decision cache above: a burst of DISTINCT resources misses
        # every decision key, but repeat resource *shapes* (the same Pod
        # re-admitted, a warmup resource, a retried request) still skip
        # the flatten. The memo space is the dictionary lineage
        # (dict_base) for incremental tensor sets — rows carry their
        # epoch and survive policy updates via delta refresh — and the
        # structural fingerprint otherwise, where a recompile that moves
        # the dictionary is a new key space.
        from .resourcecache import FlattenRowCache

        self._row_cache = FlattenRowCache(max_rows=row_cache_max)
        # fleet fabric client (fleet/fabric.attach_stack); None = the
        # single-replica build, and KTPU_FABRIC gates every consult even
        # when attached
        self._fabric = None
        # warmup seeds by population, replayed on policy change so the
        # post-update first burst finds warm shape buckets and a primed
        # memo (re-warm runs on its own thread: warmup blocks on the
        # flush pool, so running it ON the pool could deadlock it)
        self._warm_seeds: dict[tuple, tuple] = {}
        self._rewarm_pending = False
        if hasattr(policy_cache, "add_listener"):
            policy_cache.add_listener(self._on_policy_change)
        # per-CompiledPolicySet shape buckets already dispatched; weak keys
        # so dead policy generations vanish (an id()-keyed set could both
        # leak and misclassify a fresh compile after id reuse)
        import weakref

        self._seen_shapes: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary())
        # the native flattener's library is built (g++, seconds) at its
        # first use in the process: build it here, so that no screen's
        # deadline pays for it (a failed build raises, as a flush would)
        if featureplane.enabled("KTPU_NATIVE"):
            from ..models import native_flatten

            native_flatten.native_available()
        self._in_flight = 0
        self._arrivals: deque[float] = deque()
        self._lock = threading.Condition()
        self._buckets: dict[tuple, _Bucket] = {}
        self._stopped = False
        # flushes run on a small pool so consecutive device dispatches
        # pipeline (the flatten and transfer of batch N+1 overlap the
        # evaluation of batch N)
        from concurrent.futures import ThreadPoolExecutor

        self._flush_pool = ThreadPoolExecutor(max_workers=4,
                                              thread_name_prefix="adm-flush")
        self._worker = threading.Thread(target=self._run, name="adm-batch",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ routing

    @contextlib.contextmanager
    def admission_in_flight(self):
        """Webhook handlers wrap each admission in this so the router sees
        true request concurrency rather than inferring it from arrival
        rate."""
        with self._lock:
            self._in_flight += 1
        try:
            yield
        finally:
            with self._lock:
                self._in_flight -= 1

    def note_oracle_cost(self, seconds: float, n_policies: int = 1,
                         full: bool = True) -> None:
        """The webhook reports measured CPU-oracle time per admission and
        how many policies that run covered. Only *full* runs update the
        per-policy EMA — hybrid runs over the few flagged policies carry
        per-request fixed overhead that would inflate the estimate."""
        if n_policies <= 0 or not full:
            return
        with self._lock:
            per = seconds / n_policies
            self._oracle_policy_cost += 0.3 * (per - self._oracle_policy_cost)

    def note_screen_savings(self, frac: float) -> None:
        """Fraction of oracle *time* a screened admission avoided
        (1.0 for a CLEAN row)."""
        with self._lock:
            self._savings_frac += 0.3 * (frac - self._savings_frac)

    def note_hybrid_cost(self, seconds: float, n_enforce: int) -> None:
        """A hybrid merge still paid ``seconds`` of CPU; convert that to a
        time-savings fraction against the estimated full-oracle cost —
        policy counts overstate savings because per-request fixed work
        (context build, userinfo) doesn't scale with policy count."""
        with self._lock:
            full = n_enforce * self._oracle_policy_cost
            frac = max(0.0, 1.0 - seconds / full) if full > 0 else 0.0
            self._savings_frac += 0.3 * (frac - self._savings_frac)

    def _device_favored(self, est_batch: int, n_policies: int,
                        deadline_free: bool = False) -> bool:
        # amortize over the batch size dispatches actually realize, not
        # the instantaneous concurrency (the window only captures what
        # arrives within it); allow 2x headroom so the lane can bootstrap
        eff_batch = min(float(est_batch),
                        max(float(self.burst_threshold),
                            2.0 * self._batch_size_ema))
        # what the oracle alternative costs: these requests serialize on
        # the CPU (one GIL), so the queue's wall-clock drain time IS the
        # summed per-request cost
        oracle_drain = eff_batch * n_policies * self._oracle_policy_cost
        # CPU economics: the flush's host CPU (flatten + dispatch) must be
        # cheaper than the oracle CPU it replaces. Wall dispatch time is
        # NOT on this axis — the device wait holds no GIL.
        cpu_won = oracle_drain * self._savings_frac > self._flush_cpu_cost
        # latency: the device answer (behind any flushes already in
        # flight) must beat the oracle queue's drain time, and fit the
        # deadline budget. Deadline-free callers (the audit queue — no
        # one is waiting on an admission response) skip this gate: for
        # them the device wins whenever it saves CPU, period.
        if deadline_free:
            return cpu_won
        device_latency = (self._dispatch_cost * (1 + self._pending_flushes)
                          + self._window())
        lat_ok = device_latency < min(oracle_drain, SCREEN_DEADLINE_S)
        return cpu_won and lat_ok

    # batch-axis floor for admission flushes: every burst-sized batch
    # (<= this) pads to ONE shape, so warmup's single shape covers the
    # whole burst regime — without it, a 16-way burst's first flushes of
    # 4/8 rows each hit a cold bucket and fall back to the oracle
    PAD_FLOOR = 16

    def _window(self) -> float:
        """Effective coalescing window: the configured window scaled
        down by the SLO geometry profile while degraded (1x healthy)."""
        return self.window_s * _slo_window_scale()

    @classmethod
    def _pad_admission(cls, batch, floor: int | None = None):
        """Power-of-two bucket padding with the admission batch floor
        (``floor`` overrides it — the SLO geometry profile passes a
        smaller one while degraded; padding never touches verdicts)."""
        from ..models.flatten import pad_packed, pad_to_buckets_packed
        from dataclasses import replace

        pad_floor = cls.PAD_FLOOR if floor is None else floor
        padded, n0 = pad_to_buckets_packed(batch)
        if padded.cells.shape[0] < pad_floor:
            cells, bmeta, _ = pad_packed(
                padded.cells, padded.bmeta, pad_floor)
            padded = replace(padded, n=pad_floor, cells=cells,
                             bmeta=bmeta)
        return padded, n0

    def warmup(self, ptype, kind: str, namespace: str, resource: dict,
               batch_sizes: tuple = (1, 16)) -> None:
        """Warm the screen for the common shape buckets and prime the
        dispatch-cost EMA — the controller calls this at startup and after
        policy changes, so the first real burst never pays a cold bucket
        inline. With the admission pad floor, every size in
        ``batch_sizes`` up to PAD_FLOOR lands on one shape."""
        with self._lock:
            self._warm_seeds[(int(ptype), kind, namespace)] = (
                ptype, kind, namespace, resource, batch_sizes)
        try:
            cps = self.policy_cache.compiled(ptype, kind, namespace)
        except Exception:
            return
        if not cps.policies:
            return
        # each size warms on a flush-pool worker through the same
        # memoized-flatten + async-dispatch path live flushes use, so a
        # warmup triggered by a policy change can't serialize in front of
        # a live flush on the caller's thread (it competes for a pool
        # slot like any other flush, nothing more). [resource] * b also
        # seeds the flatten-row memo: one miss, b-1 hits.
        futs = [self._flush_pool.submit(self._warmup_one, cps, resource, b)
                for b in batch_sizes]
        for f in futs:
            with contextlib.suppress(Exception):
                f.result()

    def _warmup_one(self, cps, resource: dict, b: int) -> None:
        raw, _, _, deferred = self._flatten_flush(cps, [resource] * b)
        batch, _ = self._pad_admission(raw)
        shape_key = (batch.n, batch.e, int(batch.dictv.shape[0]))
        handle = cps.evaluate_device_async(batch)   # cold: first use
        self._store_deferred(deferred)
        handle.get()
        t0 = time.monotonic()
        cps.evaluate_device_async(batch).get()      # measure steady state
        dt = time.monotonic() - t0
        with self._lock:
            self._seen_shapes.setdefault(cps, set()).add(shape_key)
            self._dispatch_cost += 0.3 * (dt - self._dispatch_cost)
            self._last_dispatch = time.monotonic()

    def _on_policy_change(self, event: str, policy) -> None:
        """Policy-cache listener: replay the recorded warmup seeds so the
        freshly-spliced tensor set gets its shape buckets warmed and its
        memo rows refreshed BEFORE the next admission burst arrives.
        Coalesced — a storm of updates triggers one re-warm pass at a
        time — and run on a dedicated thread (never the flush pool:
        warmup waits on flush-pool futures). With a fabric attached the
        churn also purges the shared decision/host tiers fleet-wide —
        every replica's stale rows, not just ours."""
        if self._fabric is not None:
            from ..fleet import fabric as fabric_mod

            fabric_mod.publish_policy_change(self._fabric, event, policy)
        with self._lock:
            if self._stopped or not self._warm_seeds or self._rewarm_pending:
                return
            self._rewarm_pending = True
        threading.Thread(target=self._rewarm, name="adm-rewarm",
                         daemon=True).start()

    def _rewarm(self) -> None:
        try:
            with self._lock:
                seeds = list(self._warm_seeds.values())
                self.stats["rewarm"] = self.stats.get("rewarm", 0) + 1
            for ptype, kind, ns, resource, sizes in seeds:
                with contextlib.suppress(Exception):
                    self.warmup(ptype, kind, ns, resource,
                                batch_sizes=sizes)
        finally:
            with self._lock:
                self._rewarm_pending = False

    # ------------------------------------------------------------- cache

    def _cache_key(self, ptype, kind: str, namespace: str, resource: dict,
                   env: dict | None = None):
        """``env`` carries the request-identity fields rule outcomes can
        depend on beyond the resource body (operation, userInfo,
        oldObject): the ORACLE lane evaluates request.* conditions and
        RBAC matches, so two admissions of the same resource by
        different users must never share a cache row. Cluster-state
        context (ConfigMap/APICall) is bounded by the TTL only — the
        same staleness window an informer-backed lookup has. The policy
        generation counter keys the policy-set identity (NOT id(cps):
        cache entries outlive the compiled set, and a recycled address
        would serve the old generation's verdicts)."""
        try:
            import hashlib
            import json as _json

            digest = hashlib.blake2b(
                _json.dumps([resource, env]).encode("utf-8"),
                digest_size=16).digest()
            generation = getattr(self.policy_cache, "generation", 0)
            return (generation, int(ptype), kind, namespace, digest)
        except (TypeError, ValueError):
            return None

    def _cache_store(self, cache_key, status, row) -> None:
        """Caller holds self._lock."""
        ttl_store(self._result_cache, cache_key, self.result_cache_ttl_s,
                  (status, row), max_size=self.result_cache_max)

    def decision_key(self, ptype, kind: str, namespace: str, resource: dict,
                     env: dict | None = None):
        """Stable cache key for this admission's enforce decision (the
        webhook's decision cache shares the batcher's keying and TTL
        semantics); None when caching is off or the input is unkeyable."""
        if self.result_cache_ttl_s <= 0:
            return None
        return self._cache_key(ptype, kind, namespace, resource, env)

    def store_result(self, ptype, kind: str, namespace: str, resource: dict,
                     row, env: dict | None = None) -> None:
        """Cache a verdict row produced by the ORACLE lane (the webhook
        calls this after a full or hybrid run): the decision is the same
        pure function of (policy set, resource) the device rows are, so
        a warm system serves repeat admissions at cache speed through
        either lane. Same TTL bound; a policy change bumps the cache
        generation out of every key."""
        if self.result_cache_ttl_s <= 0:
            return
        key = self._cache_key(ptype, kind, namespace, resource, env)
        if key is None:
            return
        clean = all(t[2] in (Verdict.PASS, Verdict.SKIP) for t in row)
        status = CLEAN if clean else ATTENTION
        with self._lock:
            self._cache_store(key, status, row)
        if self._fabric is not None:
            from ..fleet import fabric as fabric_mod

            fabric_mod.decision_fabric_put(self, ptype, kind, namespace,
                                           resource, env, status, row)

    def cache_fingerprint(self) -> str:
        """Digest of every live decision the batcher holds: result-cache
        entries (expiry timestamps excluded — they move on their own)
        and the routing counters. The dry-run quiescent probe compares
        this before/after a candidate evaluation to prove the service
        touched no live state."""
        import hashlib

        h = hashlib.sha256()
        with self._lock:
            for key in sorted(self._result_cache, key=repr):
                entry = self._result_cache[key]
                h.update(repr((key, entry[1:])).encode())
            h.update(repr(sorted(self.stats.items())).encode())
        h.update(str(getattr(self.policy_cache, "generation", 0)).encode())
        return h.hexdigest()[:16]

    # ------------------------------------------------------------ enqueue

    def screen(self, ptype, kind: str, namespace: str, resource: dict,
               timeout_s: float = SCREEN_DEADLINE_S,
               env: dict | None = None, deadline_free: bool = False,
               ctx_cb=None):
        """Returns (CLEAN | ATTENTION | ORACLE,
        [(policy, rule, Verdict, message), ...]).

        ``message`` is non-empty only for cells the flush resolved through
        the batched host oracle (faithful oracle text the caller can deny
        with directly); device-computed cells carry "".

        ``ctx_cb`` (optional, zero-arg) lazily builds this admission's
        context payload ({"request", "namespace_labels", "roles",
        "cluster_roles", "exclude_group_role"}) — only invoked when the
        flush actually has HOST cells to resolve for this row.

        ORACLE means "the device does not pay for this request — evaluate
        on CPU inline"; the caller treats it exactly like ATTENTION but no
        time was spent. On any failure — timeout, compile error, device
        error — returns (ATTENTION, []) so the caller takes the oracle
        lane."""
        trace = tracing.current()
        rec = tracing.recorder()
        try:
            cps = self.policy_cache.compiled(ptype, kind, namespace)
        except Exception:
            return ATTENTION, []
        if not cps.policies:
            return CLEAN, []
        cache_key = None
        if self.result_cache_ttl_s > 0:
            cache_key = self._cache_key(ptype, kind, namespace,
                                        resource, env)
            if cache_key is not None:
                hit = self._result_cache.get(cache_key)
                if hit is not None and hit[0] > time.monotonic():
                    with self._lock:
                        self.stats["cache"] = self.stats.get("cache", 0) + 1
                        self.stats["clean" if hit[1] == CLEAN
                                   else "attention"] += 1
                    now_pc = time.perf_counter()
                    rec.add_span(trace, "screen", now_pc, now_pc,
                                 lane="result_cache", status=hit[1])
                    return hit[1], hit[2]
                if self._fabric is not None:
                    # local miss → fleet fabric read-through: a decision
                    # another replica already computed for this exact
                    # (policy set, body, env) serves at cache speed here
                    from ..fleet import fabric as fabric_mod

                    far = fabric_mod.decision_fabric_get(
                        self, ptype, kind, namespace, resource, env)
                    if far is not None:
                        status, row = far
                        with self._lock:
                            self.stats["fabric"] = (
                                self.stats.get("fabric", 0) + 1)
                            self.stats["clean" if status == CLEAN
                                       else "attention"] += 1
                            self._cache_store(cache_key, status, row)
                        now_pc = time.perf_counter()
                        rec.add_span(trace, "screen", now_pc, now_pc,
                                     lane="fabric", status=status)
                        return status, row
        fut: Future = Future()
        now = time.monotonic()
        with self._lock:
            if self._stopped:
                return ATTENTION, []
            if now < self._circuit_open_until:
                self.stats["oracle"] += 1
                now_pc = time.perf_counter()
                rec.add_span(trace, "screen", now_pc, now_pc,
                             lane="circuit_open", status=ORACLE)
                return ORACLE, []
            self._arrivals.append(now)
            while self._arrivals and now - self._arrivals[0] > self.rate_window_s:
                self._arrivals.popleft()
            # concurrency estimate: true in-flight count when the webhook
            # wraps admissions, else the recent-arrival window (direct
            # callers); a sequential client always estimates 1 and a
            # device batch of one never beats the oracle
            est_batch = (self._in_flight if self._in_flight > 0
                         else len(self._arrivals))
            key = (int(ptype), kind, namespace, id(cps))
            bucket = self._buckets.get(key)
            # ride an already-forming batch regardless of the cost model:
            # joining costs only the remainder of the open window
            joining = bucket is not None and bool(bucket.items)
            if not joining:
                if est_batch < self.burst_threshold:
                    self.stats["oracle"] += 1
                    now_pc = time.perf_counter()
                    rec.add_span(trace, "screen", now_pc, now_pc,
                                 lane="below_burst", status=ORACLE)
                    return ORACLE, []
                if not self._device_favored(est_batch, len(cps.policies),
                                            deadline_free):
                    # keep the dispatch-cost EMA honest without making any
                    # request wait: occasionally send a fire-and-forget
                    # shadow copy of this burst member to the device — in a
                    # dedicated bucket, so no real request "joins" a probe
                    # and blocks on a device the model just rejected
                    if now - self._last_dispatch > self.probe_interval_s:
                        self._last_dispatch = now
                        self.stats["probe"] += 1
                        pkey = key + ("probe",)
                        b = self._buckets.get(pkey)
                        if b is None:
                            b = self._buckets[pkey] = _Bucket(cps)
                        b.items.append((resource, None, Future()))
                        self._lock.notify()
                    self.stats["oracle"] += 1
                    now_pc = time.perf_counter()
                    rec.add_span(trace, "screen", now_pc, now_pc,
                                 lane="cost_model", status=ORACLE)
                    return ORACLE, []
            self.stats["device"] += 1
            if bucket is None:
                bucket = self._buckets[key] = _Bucket(cps)
            fut.ktpu_trace = trace
            bucket.items.append((resource, ctx_cb, fut))
            self._lock.notify()
            # bound the wrong-way cost: if the dispatch estimate turns out
            # optimistic, bail to the oracle after ~4x the expected RTT
            # (scaled by the flushes already queued on the link) instead
            # of eating the full deadline budget. Cold sets keep the full
            # budget — their first flush legitimately pays first use
            adaptive = bool(self._seen_shapes.get(cps))
            deadline_budget = timeout_s
            if adaptive and not deadline_free:
                timeout_s = min(timeout_s,
                                max(0.05, 4 * self._dispatch_cost
                                    + self._window())
                                * (1 + self._pending_flushes))
        wait_start = time.monotonic()
        wait_pc = time.perf_counter()
        try:
            try:
                status, row, device_answered = fut.result(timeout=timeout_s)
            except FuturesTimeout:
                # the adaptive deadline expired — but if OUR flush has
                # already started (flatten/dispatch under way), bailing
                # now wastes the in-flight work AND re-serializes this
                # request onto the oracle the burst is already choking;
                # keep waiting up to the full deadline budget instead
                remaining = deadline_budget - (time.monotonic() - wait_start)
                if not getattr(fut, "ktpu_started", False) or remaining <= 0:
                    raise
                status, row, device_answered = fut.result(timeout=remaining)
        except Exception:
            elapsed = time.monotonic() - wait_start
            with self._lock:
                self.stats["screen_timeout"] = (
                    self.stats.get("screen_timeout", 0) + 1)
                # cold shapes waited on a first use — a one-time cost the
                # EMA and breaker must not treat as lane slowness
                # (mirrors _flush's cold exclusion)
                if adaptive:
                    # the wait itself is a dispatch-cost measurement the
                    # EMA must not ignore: the lane was at LEAST this slow
                    self._dispatch_cost = max(self._dispatch_cost, elapsed)
                    if bucket.seq not in self._timed_out_flushes:
                        if len(self._timed_out_flushes) >= 64:
                            self._timed_out_flushes.clear()
                        self._timed_out_flushes.add(bucket.seq)
                        self._consecutive_timeouts += 1
                    now2 = time.monotonic()
                    if (self._consecutive_timeouts
                            >= self.circuit_timeout_threshold
                            and now2 >= self._circuit_open_until):
                        self._circuit_open_until = (
                            now2 + self.circuit_cooldown_s)
                        self.stats["circuit_open"] = (
                            self.stats.get("circuit_open", 0) + 1)
            rec.add_span(trace, "coalesce_wait", wait_pc,
                         time.perf_counter(), lane="timeout",
                         status=ATTENTION)
            return ATTENTION, []
        rec.add_span(trace, "coalesce_wait", wait_pc, time.perf_counter(),
                     lane="device" if device_answered else "fallback",
                     status=status)
        if trace is not None:
            flush_spans = getattr(fut, "ktpu_flush_spans", None)
            if flush_spans:
                trace.adopt_spans(flush_spans)
        with self._lock:
            if device_answered:
                # only a flush the device actually served proves the lane
                # healthy; cold-fallback and error resolutions do not
                self._consecutive_timeouts = 0
                self._timed_out_flushes.clear()
                if cache_key is not None:
                    self._cache_store(cache_key, status, row)
            else:
                # a flush answered this waiter without a device row (a
                # cold bucket's release, or a failed flush)
                self.stats["flush_fallback"] = (
                    self.stats.get("flush_fallback", 0) + 1)
            self.stats["clean" if status == CLEAN else "attention"] += 1
        if (device_answered and cache_key is not None
                and self._fabric is not None):
            from ..fleet import fabric as fabric_mod

            fabric_mod.decision_fabric_put(self, ptype, kind, namespace,
                                           resource, env, status, row)
        return status, row

    # ----------------------------------------------------- streaming lane

    def _row_cache_key(self, ptype, kind: str, namespace: str, row):
        """Result-cache key for a pre-tokenized wire row: blake2b over
        the packed arrays stands in for the JSON digest of _cache_key
        (same generation scoping). Wire rows carry no request-identity
        env — the stream lane serves resource-pure policy verdicts, so
        the key is the row bytes alone."""
        try:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            h.update(np.ascontiguousarray(row.cells).tobytes())
            h.update(int(row.bmeta).to_bytes(4, "little"))
            h.update(np.ascontiguousarray(row.str_bytes).tobytes())
            h.update(np.ascontiguousarray(row.dictv).tobytes())
            generation = getattr(self.policy_cache, "generation", 0)
            return (generation, int(ptype), kind, namespace, h.digest())
        except Exception:
            return None

    def screen_row(self, ptype, kind: str, namespace: str, row,
                   timeout_s: float = SCREEN_DEADLINE_S,
                   deadline_free: bool = False):
        """Streaming enqueue of a pre-tokenized ``PackedRow``: the wire
        row joins the same forming batch webhook admissions ride, so the
        two planes coalesce into one device dispatch.

        Wire rows ALWAYS take the device lane — the client already paid
        tokenization, and a row with no JSON body has no cheap oracle
        alternative — so the burst-threshold/cost-model gates don't
        apply. Same (status, verdict_row) contract as screen(); HOST
        cells stay unresolved (message "") and the caller escalates
        them."""
        trace = tracing.current()
        rec = tracing.recorder()
        try:
            cps = self.policy_cache.compiled(ptype, kind, namespace)
        except Exception:
            return ATTENTION, []
        if not cps.policies:
            return CLEAN, []
        if int(row.cells.shape[0]) != int(cps.tensors.n_paths):
            # client tokenized against a stale schema generation — its
            # path axis no longer matches the compiled tensors
            with self._lock:
                self.stats["stream_shape_reject"] = (
                    self.stats.get("stream_shape_reject", 0) + 1)
            return ATTENTION, []
        cache_key = None
        if self.result_cache_ttl_s > 0:
            cache_key = self._row_cache_key(ptype, kind, namespace, row)
            if cache_key is not None:
                hit = self._result_cache.get(cache_key)
                if hit is not None and hit[0] > time.monotonic():
                    with self._lock:
                        self.stats["cache"] = self.stats.get("cache", 0) + 1
                        self.stats["clean" if hit[1] == CLEAN
                                   else "attention"] += 1
                    now_pc = time.perf_counter()
                    rec.add_span(trace, "screen_row", now_pc, now_pc,
                                 lane="result_cache", status=hit[1])
                    return hit[1], hit[2]
        fut: Future = Future()
        now = time.monotonic()
        with self._lock:
            if self._stopped:
                return ATTENTION, []
            if now < self._circuit_open_until:
                self.stats["oracle"] += 1
                now_pc = time.perf_counter()
                rec.add_span(trace, "screen_row", now_pc, now_pc,
                             lane="circuit_open", status=ATTENTION)
                return ATTENTION, []
            self._arrivals.append(now)
            while (self._arrivals
                   and now - self._arrivals[0] > self.rate_window_s):
                self._arrivals.popleft()
            key = (int(ptype), kind, namespace, id(cps))
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = _Bucket(cps)
            self.stats["device"] += 1
            self.stats["stream_rows"] = (
                self.stats.get("stream_rows", 0) + 1)
            fut.ktpu_trace = trace
            bucket.items.append((row, None, fut))
            self._lock.notify()
            adaptive = bool(self._seen_shapes.get(cps))
            deadline_budget = timeout_s
            if adaptive and not deadline_free:
                timeout_s = min(timeout_s,
                                max(0.05, 4 * self._dispatch_cost
                                    + self._window())
                                * (1 + self._pending_flushes))
        wait_start = time.monotonic()
        wait_pc = time.perf_counter()
        try:
            try:
                status, vrow, device_answered = fut.result(timeout=timeout_s)
            except FuturesTimeout:
                remaining = deadline_budget - (time.monotonic() - wait_start)
                if not getattr(fut, "ktpu_started", False) or remaining <= 0:
                    raise
                status, vrow, device_answered = fut.result(timeout=remaining)
        except Exception:
            with self._lock:
                self.stats["stream_timeout"] = (
                    self.stats.get("stream_timeout", 0) + 1)
            rec.add_span(trace, "coalesce_wait", wait_pc,
                         time.perf_counter(), lane="timeout",
                         status=ATTENTION)
            return ATTENTION, []
        rec.add_span(trace, "coalesce_wait", wait_pc, time.perf_counter(),
                     lane="device" if device_answered else "fallback",
                     status=status)
        if trace is not None:
            flush_spans = getattr(fut, "ktpu_flush_spans", None)
            if flush_spans:
                trace.adopt_spans(flush_spans)
        with self._lock:
            if device_answered:
                self._consecutive_timeouts = 0
                self._timed_out_flushes.clear()
                if cache_key is not None:
                    self._cache_store(cache_key, status, vrow)
            self.stats["clean" if status == CLEAN else "attention"] += 1
        return status, vrow

    def evaluate_block(self, ptype, kind: str, namespace: str, block):
        """Whole-block evaluation for the columnar stream path: the
        client ships a ``PackedBatch`` it tokenized itself; the server
        pads to the shape bucket, dispatches through K6, and
        scatters per-live-row verdicts. Zero per-row re-intern and zero
        row rebuild by construction — the block IS the device transfer
        format (stream_wire_rows / stream_reintern_rows counters don't
        move on this path, which is the steady-state zero-copy proof).

        HOST cells stay unresolved (no JSON bodies to re-walk): rows
        carrying one escalate. Returns
        ``[(CLEAN | ATTENTION, [(policy, rule, Verdict, ""), ...]), ...]``
        one per live row, or None when the set can't serve the block."""
        rec = tracing.recorder()
        trace = rec.start("stream_block", rows=int(block.n))
        if trace is not None:
            trace.labels.update(kind=kind, namespace=namespace)
        tok = tracing.bind(trace)
        try:
            try:
                cps = self.policy_cache.compiled(ptype, kind, namespace)
            except Exception:
                return None
            live_rows = [b for b in range(int(block.n))
                         if (int(block.bmeta[b]) >> 17) & 1]
            if not cps.policies:
                return [(CLEAN, []) for _ in live_rows]
            if int(block.cells.shape[1]) != int(cps.tensors.n_paths):
                with self._lock:
                    self.stats["stream_shape_reject"] = (
                        self.stats.get("stream_shape_reject", 0) + 1)
                return None
            padded, _ = self._pad_admission(block)
            shape_key = (padded.n, padded.e, int(padded.dictv.shape[0]))
            with self._lock:
                cold = shape_key not in self._seen_shapes.setdefault(
                    cps, set())
            d0 = time.perf_counter()
            verdicts = cps.evaluate_device_async(padded, donate=True).get()
            rec.add_span(trace, "cold_dispatch" if cold else "device_dispatch",
                         d0, time.perf_counter(), lane="stream_block",
                         batch=padded.n)
            if cold:
                with self._lock:
                    self._seen_shapes[cps].add(shape_key)
            s0 = time.perf_counter()
            out = []
            attrib: dict[tuple, int] = {}
            for b in live_rows:
                vrow = []
                clean = True
                for ref in cps.rule_refs:
                    v = Verdict(verdicts[b, ref.rule_index])
                    if v is Verdict.NOT_APPLICABLE:
                        continue
                    vrow.append((ref.policy.name, ref.rule.name, v, ""))
                    ak = (ref.policy.name, ref.rule.name, v.name)
                    attrib[ak] = attrib.get(ak, 0) + 1
                    if v not in (Verdict.PASS, Verdict.SKIP):
                        clean = False
                out.append((CLEAN if clean else ATTENTION, vrow))
            if attrib:
                try:
                    from . import metrics as metrics_mod

                    metrics_mod.record_policy_verdicts(
                        metrics_mod.registry(),
                        [(p, r, v, n) for (p, r, v), n in attrib.items()],
                        lane="block", namespace=namespace)
                except Exception:
                    pass
            rec.add_span(trace, "scatter", s0, time.perf_counter(),
                         rows=len(out), lane="stream_block")
            with self._lock:
                self.stats["stream_blocks"] = (
                    self.stats.get("stream_blocks", 0) + 1)
                self.stats["stream_block_rows"] = (
                    self.stats.get("stream_block_rows", 0) + len(out))
            return out
        except Exception:
            return None
        finally:
            tracing.unbind(tok)
            rec.finish(trace)

    def _graft_late(self, cps, batch, at, late_items, v_used):
        """Convert late-arriving bucket items to PackedRows and graft
        them into the padded batch's headroom slots starting at row
        ``at``. Returns (joined_items, leftover_items) — leftovers keep
        arrival order and go back to the bucket front."""
        from ..models.flatten import (PackedRow, graft_packed_rows,
                                      pipeline_enabled, split_packed_rows)

        use_memo = pipeline_enabled()
        tensors = cps.tensors
        converted: list = []
        n_ok = len(late_items)
        for idx, it in enumerate(late_items):
            payload = it[0]
            if isinstance(payload, PackedRow):
                converted.append((it, payload))
                continue
            try:
                prow = None
                if use_memo:
                    d = self._row_cache.digest(payload)
                    prow = self._row_cache.get_row(tensors.memo_space, d,
                                                   payload, tensors)
                if prow is None:
                    prow = split_packed_rows(
                        cps.flatten_packed([payload]))[0]
                    if use_memo:
                        self._row_cache.put_row(
                            tensors.memo_space, d, prow, tensors.n_paths,
                            tensors.dict_epoch,
                            fingerprint=tensors.fingerprint)
                converted.append((it, prow))
            except Exception:
                # an unconvertible payload ends the join here; it and
                # everything after it wait for the next flush
                n_ok = idx
                break
        grafted = graft_packed_rows(batch, [r for _, r in converted],
                                    at, v_used)
        joined = [it for it, _ in converted[:grafted]]
        leftovers = ([it for it, _ in converted[grafted:]]
                     + late_items[n_ok:])
        return joined, leftovers

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._stopped and not any(
                        b.items for b in self._buckets.values()):
                    self._lock.wait()
                if self._stopped:
                    for b in self._buckets.values():
                        for *_, fut in b.items:
                            fut.set_result((ATTENTION, [], False))
                    return
            # adaptive micro-batch window: let concurrent requests pile
            # in, but flush EARLY once every admission the router knows
            # about has joined (queued >= in-flight) or the batch is full
            # — at low depth there is nothing left to wait for, and the
            # full 4ms window would be pure added latency
            deadline = time.monotonic() + self._window()
            with self._lock:
                while not self._stopped:
                    queued = sum(len(b.items)
                                 for b in self._buckets.values())
                    if queued >= self.max_batch:
                        self.stats["flush_early_full"] = (
                            self.stats.get("flush_early_full", 0) + 1)
                        break
                    if 0 < self._in_flight <= queued:
                        self.stats["flush_early_joined"] = (
                            self.stats.get("flush_early_joined", 0) + 1)
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(timeout=remaining)
            with self._lock:
                work = [(b.cps, b.items[:self.max_batch],
                         k and k[-1] == "probe", k)
                        for k, b in self._buckets.items() if b.items]
                for b in self._buckets.values():
                    del b.items[:self.max_batch]
                # drained buckets go away: bucket keys embed id(cps), so a
                # policy-cache generation change would otherwise leak the
                # old CompiledPolicySet forever
                self._buckets = {k: b for k, b in self._buckets.items()
                                 if b.items}
            for cps, items, is_probe, key in work:
                with self._lock:
                    self._pending_flushes += 1
                self._flush_pool.submit(self._flush_tracked, cps, items,
                                        is_probe, key)

    def _flush_tracked(self, cps, items, is_probe: bool,
                       flush_key=None) -> None:
        try:
            self._flush(cps, items, is_probe, flush_key=flush_key)
        finally:
            with self._lock:
                self._pending_flushes -= 1

    def _flatten_flush(self, cps, resources):
        """Row-memoized flatten for one flush window.

        Returns ``(batch, n_hits, n_miss, deferred)`` — hit/miss counts
        are memo traffic, so both stay 0 when the kill-switch bypasses
        the memo entirely. On zero memo hits the
        directly-flattened batch comes back untouched (bit-identical to
        the pre-memo path) and ``deferred`` carries what the caller
        splits+stores INSIDE the async-dispatch shadow; on any hit the
        hit rows splice with a single flatten of the misses (stored
        immediately — the split already happened). Kill-switch off means
        plain flatten, no memo traffic at all."""
        from ..models.flatten import (PackedRow, pipeline_enabled,
                                      split_packed_rows, splice_packed_rows)

        wire_idx = [i for i, r in enumerate(resources)
                    if isinstance(r, PackedRow)]
        if wire_idx:
            # columnar stream payloads ride the flush pre-tokenized: no
            # JSON walk, no server-side flatten — straight to the splice.
            # (They do pay the splice's re-intern; the zero-re-intern
            # granularity is the block path, evaluate_block.)
            rows: list = [None] * len(resources)
            for i in wire_idx:
                rows[i] = resources[i]
            dict_idx = [i for i, r in enumerate(rows) if r is None]
            n_hits = n_miss = 0
            if dict_idx:
                if pipeline_enabled():
                    tensors = cps.tensors
                    space = tensors.memo_space
                    cache = self._row_cache
                    digests = {i: cache.digest(resources[i])
                               for i in dict_idx}
                    for i in dict_idx:
                        rows[i] = cache.get_row(space, digests[i],
                                                resources[i], tensors)
                        if rows[i] is not None:
                            n_hits += 1
                    miss_idx = [i for i in dict_idx if rows[i] is None]
                    if miss_idx:
                        miss_rows = split_packed_rows(cps.flatten_packed(
                            [resources[i] for i in miss_idx]))
                        for j, i in enumerate(miss_idx):
                            rows[i] = miss_rows[j]
                            cache.put_row(space, digests[i], miss_rows[j],
                                          tensors.n_paths,
                                          tensors.dict_epoch,
                                          fingerprint=tensors.fingerprint)
                        n_miss = len(miss_idx)
                else:
                    miss_rows = split_packed_rows(cps.flatten_packed(
                        [resources[i] for i in dict_idx]))
                    for j, i in enumerate(dict_idx):
                        rows[i] = miss_rows[j]
                    n_miss = len(dict_idx)
            with self._lock:
                self.stats["stream_wire_rows"] = (
                    self.stats.get("stream_wire_rows", 0) + len(wire_idx))
                # wire rows re-intern once at the splice below; the
                # rebuild counter must NOT move — these rows never see
                # the flattener again
                self.stats["stream_reintern_rows"] = (
                    self.stats.get("stream_reintern_rows", 0)
                    + len(wire_idx))
            return splice_packed_rows(rows), n_hits, n_miss, None
        if not pipeline_enabled():
            return cps.flatten_packed(resources), 0, 0, None
        tensors = cps.tensors
        space = tensors.memo_space
        cache = self._row_cache
        digests = [cache.digest(r) for r in resources]
        # epoch-aware lookup: a memo row cut at an older dict epoch of
        # the same lineage is delta-refreshed (only the appended paths
        # flatten) and still counts as a hit — the survival that keeps a
        # policy-update storm from flushing the memo
        rows = [cache.get_row(space, d, r, tensors)
                for d, r in zip(digests, resources)]
        n_hits = sum(r is not None for r in rows)
        if n_hits == 0:
            batch = cps.flatten_packed(resources)
            return batch, 0, len(resources), (space, digests, batch,
                                              tensors)
        miss_idx = [i for i, r in enumerate(rows) if r is None]
        if miss_idx:
            miss_rows = split_packed_rows(
                cps.flatten_packed([resources[i] for i in miss_idx]))
            for j, i in enumerate(miss_idx):
                rows[i] = miss_rows[j]
                cache.put_row(space, digests[i], miss_rows[j],
                              tensors.n_paths, tensors.dict_epoch,
                              fingerprint=tensors.fingerprint)
        return splice_packed_rows(rows), n_hits, len(miss_idx), None

    def _store_deferred(self, deferred) -> None:
        """Split a zero-hit flush's fresh batch into memo rows and store
        them with their dictionary coordinates (runs inside the async
        dispatch's shadow on the hot path)."""
        if deferred is None:
            return
        from ..models.flatten import split_packed_rows

        space, digests, fresh, tensors = deferred
        for d, row in zip(digests, split_packed_rows(fresh)):
            self._row_cache.put_row(space, d, row, tensors.n_paths,
                                    tensors.dict_epoch,
                                    fingerprint=tensors.fingerprint)

    def _flush(self, cps, items, is_probe: bool = False,
               flush_key=None) -> None:
        # everything — including the verdict scatter — must resolve every
        # future: an escaped exception would kill the worker thread and
        # leave all subsequent admissions blocking on their timeout
        rec = tracing.recorder()
        ft = rec.start("flush", batch=len(items),
                       probe="probe" if is_probe else "live")
        _trace_tok = tracing.bind(ft)
        try:
            from ..models.flatten import PackedRow, pipeline_enabled

            for *_, fut in items:
                # waiters whose adaptive deadline expires while this
                # flush is under way keep waiting (screen() checks this)
                fut.ktpu_started = True
            resources = [r for r, _, _ in items]
            t0 = time.monotonic()
            cpu0 = time.thread_time()
            fl0 = time.perf_counter()
            raw, n_hits, n_miss, deferred = self._flatten_flush(cps,
                                                                resources)
            rec.add_span(ft, "flatten", fl0, time.perf_counter(),
                         memo_hits=n_hits, memo_misses=n_miss,
                         lane=("memo" if pipeline_enabled()
                               else "kill_switch"))
            v_used = int(raw.dictv.shape[0])
            # bucket the batch shape (pow2 + admission floor) so nearby
            # batch sizes share one shape bucket and its K6 slots; the
            # SLO geometry profile shrinks the floor while degraded
            try:
                from . import sloactions

                floor = sloactions.effective_pad_floor(self.PAD_FLOOR)
            except Exception:
                floor = self.PAD_FLOOR
            batch, _ = self._pad_admission(raw, floor=floor)
            if (self.continuous and stream_enabled() and not is_probe
                    and flush_key is not None):
                # continuous batches keep string-table headroom (>= 25%
                # of the live table) so a late arrival whose strings
                # aren't all interned yet can still graft; the growth
                # happens BEFORE the cold check so the headroom shape is
                # the bucket that warms. KTPU_STREAM=0 skips this,
                # restoring the window-mode shapes bit for bit.
                from ..models.flatten import grow_dict_headroom

                batch = grow_dict_headroom(batch, v_used // 4 + 1)
            shape_key = (batch.n, batch.e, int(batch.dictv.shape[0]))
            with self._lock:
                cold = shape_key not in self._seen_shapes.setdefault(cps,
                                                                     set())
                queue_depth = self._pending_flushes
            if cold and self.cold_flush_fallback and not is_probe:
                # the first flush of a shape bucket — release the waiters
                # to the oracle now and let this flush warm the bucket in
                # the background for the next burst. Wire rows stay: they
                # have no JSON body the oracle could walk (released, they
                # would escalate with no verdicts), and on the card a cold
                # bucket is a K6 slot's first use, not a compile. A
                # stream flush of more distinct rows than any before it
                # lands on a larger string-table bucket, so this is no
                # rarity under a stream burst.
                released = [fut for r, _, fut in items
                            if not isinstance(r, PackedRow)
                            and not fut.done()]
                if released:
                    with self._lock:
                        self.stats["cold_release"] = (
                            self.stats.get("cold_release", 0) + 1)
                for fut in released:
                    if not fut.done():
                        # cold-fallback release: the device did NOT answer
                        if ft is not None:
                            fut.ktpu_flush_spans = list(ft.spans)
                        fut.set_result((ATTENTION, [], False))
            # continuous batching (streaming plane): the padded batch has
            # batch.n - len(items) free row slots; admissions that arrived
            # since the window drained graft into that headroom NOW —
            # before dispatch fires — instead of waiting out the next
            # window. KTPU_STREAM=0 skips this block entirely, restoring
            # the window semantics bit for bit.
            if (self.continuous and stream_enabled() and not is_probe
                    and not cold and flush_key is not None
                    and batch.n > len(items)
                    and not _slo_geometry_active()):
                # geometry action suspends late-join grafting: while
                # degraded the profile trades fill for latency, and a
                # graft extends exactly the flush we want out the door
                late_items: list = []
                with self._lock:
                    lb = self._buckets.get(flush_key)
                    if lb is not None and lb.items:
                        late_items = lb.items[:batch.n - len(items)]
                        del lb.items[:len(late_items)]
                if late_items:
                    lj0 = time.perf_counter()
                    joined, leftovers = self._graft_late(
                        cps, batch, len(items), late_items, v_used)
                    if leftovers:
                        with self._lock:
                            lb = self._buckets.get(flush_key)
                            if lb is None:
                                lb = self._buckets[flush_key] = _Bucket(cps)
                            lb.items[:0] = leftovers
                            self._lock.notify()
                    if joined:
                        for *_, fut in joined:
                            fut.ktpu_started = True
                        items = items + joined
                        resources = resources + [r for r, _, _ in joined]
                        rec.add_span(ft, "late_join", lj0,
                                     time.perf_counter(), rows=len(joined),
                                     lane="continuous")
                        with self._lock:
                            self.stats["stream_late_join_rows"] = (
                                self.stats.get("stream_late_join_rows", 0)
                                + len(joined))
            # columnar wire payloads carry no JSON body the oracle could
            # re-walk: the flush's host-lane resolution only runs over
            # all-dict flushes (wire rows' HOST cells stay unresolved and
            # the stream response escalates them)
            wire_present = any(isinstance(r, PackedRow) for r in resources)
            # async dispatch: the device starts on this batch NOW; the
            # host thread spends the flight time on work
            # that used to run after the blocking eval — splitting and
            # storing this window's memo rows — and only materializes
            # verdicts when the scatter below needs them. With the 4-way
            # flush pool this also lets flush N+1's flatten (its own
            # worker) overlap flush N's device time.
            overlap_s = 0.0
            host_pf = None
            if pipeline_enabled() and not cold:
                d0 = time.perf_counter()
                # warm stable-shape dispatch goes through K6 (KTPU_DONATE
                # gates inside evaluate_device_async)
                handle = cps.evaluate_device_async(batch, donate=True)
                t_disp = time.monotonic()
                # predictive host-lane prefetch: the flush's statically
                # host-only cells start oracle-resolving NOW, inside the
                # same dispatch shadow, and join at the scatter below
                # (_resolve_flush_hosts) instead of running serially
                # after the device verdicts land
                if (self.resolve_host_in_flush and not is_probe
                        and not wire_present):
                    host_pf = self._start_host_prefetch(cps, items,
                                                        resources)
                if deferred is not None:
                    m0 = time.perf_counter()
                    self._store_deferred(deferred)
                    overlap_s = time.monotonic() - t_disp
                    rec.add_span(ft, "memo_store", m0, time.perf_counter(),
                                 lane="dispatch_shadow")
                verdicts = handle.get()
                rec.add_span(ft, "device_dispatch", d0, time.perf_counter(),
                             lane="async", batch=batch.n)
            else:
                # cold flush: the first use of the bucket (the kill switch
                # too) — overlap buys nothing, keep it simple
                d0 = time.perf_counter()
                verdicts = np.asarray(cps.evaluate_device(batch))
                rec.add_span(ft, "cold_dispatch" if cold else "device_dispatch",
                             d0, time.perf_counter(),
                             lane="cold" if cold else "serial",
                             batch=batch.n)
                if deferred is not None:
                    m0 = time.perf_counter()
                    self._store_deferred(deferred)
                    rec.add_span(ft, "memo_store", m0, time.perf_counter(),
                                 lane="inline")
            dt = time.monotonic() - t0
            cpu_dt = time.thread_time() - cpu0
            with self._lock:
                # a cold-entry flush paid (or was blocked behind) a first
                # use — a one-time cost, not the steady-state dispatch
                # price. The flag captured BEFORE eval governs: a
                # concurrent flush of the same shape that raced it must
                # not feed its dt to the EMA either, even though the
                # shape is in the set by now
                if not cold:
                    self._dispatch_cost += 0.3 * (dt - self._dispatch_cost)
                    # host CPU actually burned (thread_time: link waits
                    # excluded) — the cost-model side of the device lane
                    self._flush_cpu_cost += 0.3 * (cpu_dt
                                                   - self._flush_cpu_cost)
                else:
                    self._seen_shapes[cps].add(shape_key)
                if not is_probe:
                    # probes are batches of one by construction — feeding
                    # them to the realized-batch EMA would drag it to 1
                    # and lock the device lane out permanently
                    self._batch_size_ema += 0.3 * (len(items)
                                                   - self._batch_size_ema)
                self._last_dispatch = time.monotonic()
            # batched HOST-cell resolution: every cluster-independent
            # host-lane cell of the whole flush resolves through ONE
            # oracle pass (request-aware contexts from the waiters'
            # ctx_cb), so a row whose only flags were pool-safe host
            # rules comes back CLEAN/FAIL-with-message instead of
            # dumping each waiter onto a per-request full evaluation
            messages: dict = {}
            host_resolved = 0
            live = any(not fut.done() for *_, fut in items)
            if (self.resolve_host_in_flush and live and not is_probe
                    and not wire_present):
                h0 = time.perf_counter()
                host_resolved = self._resolve_flush_hosts(
                    cps, items, resources, verdicts, messages,
                    prefetch=host_pf)
                rec.add_span(ft, "host_resolve", h0, time.perf_counter(),
                             cells=host_resolved,
                             prefetch_cells=(host_pf.applied_cells
                                             if host_pf is not None else 0),
                             lane=("prefetch" if host_pf is not None
                                   else "post_pass"))
            flush_cells: dict[str, int] = {}
            flagged_rules: dict[str, int] = {}
            esc: dict[str, int] = {}
            # per-flush attribution aggregate: (policy, rule, verdict) ->
            # count, folded into the bounded top-K registry feed at
            # _note_flush_stats (one recorder call per flush, never one
            # per cell — the scatter loop stays a dict increment)
            attrib: dict[tuple, int] = {}
            base_spans = list(ft.spans) if ft is not None else None
            for b, (_, _, fut) in enumerate(items):
                s0 = time.perf_counter()
                row = []
                clean = True
                saw = {"host": False, "error": False, "fail": False}
                for ref in cps.rule_refs:
                    v = Verdict(verdicts[b, ref.rule_index])
                    if v is Verdict.NOT_APPLICABLE:
                        continue
                    msg = messages.get((b, ref.rule_index), "")
                    row.append((ref.policy.name, ref.rule.name, v, msg))
                    flush_cells[v.name] = flush_cells.get(v.name, 0) + 1
                    ak = (ref.policy.name, ref.rule.name, v.name)
                    attrib[ak] = attrib.get(ak, 0) + 1
                    if v not in (Verdict.PASS, Verdict.SKIP):
                        clean = False
                        flagged_rules[ref.rule.name] = (
                            flagged_rules.get(ref.rule.name, 0) + 1)
                        if v is Verdict.HOST:
                            saw["host"] = True
                        elif v is Verdict.ERROR:
                            saw["error"] = True
                        else:
                            saw["fail"] = True
                # escalation reason, most-blocking first: an unresolved
                # HOST cell forces the webhook's oracle no matter what
                # else the row says; ERROR next; FAIL may still deny
                # directly from the device row
                if clean:
                    reason = "clean"
                elif saw["host"]:
                    reason = "host_unresolved"
                elif saw["error"]:
                    reason = "device_error"
                else:
                    reason = "device_fail"
                esc[reason] = esc.get(reason, 0) + 1
                if not fut.done():
                    sp = rec.add_span(ft, "scatter", s0,
                                      time.perf_counter(), row=b,
                                      reason=reason)
                    if base_spans is not None:
                        fut.ktpu_flush_spans = base_spans + [sp]
                    fut.set_result((CLEAN if clean else ATTENTION, row, True))
            # SLO load-shed annotation: a degraded fleet stamps the
            # flush trace + a stat counter; verdicts are untouched by
            # construction. The controller tick rides along so flush
            # traffic keeps the degradation state machine current (the
            # state-seconds counter accounts idle stretches separately).
            try:
                from . import sloactions
                from .slo import watchdog

                sloactions.controller().maybe_tick()
                ann = watchdog().annotation(max_age_s=1.0)
                if ann is not None:
                    if ft is not None:
                        ft.labels.update(ann)
                    with self._lock:
                        self.stats["slo_degraded_flushes"] = (
                            self.stats.get("slo_degraded_flushes", 0) + 1)
            except Exception:
                pass
            self._note_flush_stats(len(items), host_resolved, flush_cells,
                                   flagged_rules, esc, n_hits=n_hits,
                                   n_miss=n_miss,
                                   queue_depth=queue_depth,
                                   overlap_s=overlap_s,
                                   host_prefetch_cells=(
                                       host_pf.applied_cells
                                       if host_pf is not None else 0),
                                   host_overlap_s=(
                                       host_pf.overlap_s()
                                       if host_pf is not None else 0.0),
                                   batch_fill=(len(items) / batch.n
                                               if batch.n else 0.0),
                                   attrib=attrib,
                                   namespace=(flush_key[2]
                                              if flush_key else None),
                                   flush_s=time.monotonic() - t0)
        except Exception:
            # the waiters still get an answer (ATTENTION: the oracle
            # lane), but a failed flush is counted and logged, never
            # silent: on the card it is a failed staging, copy or launch
            _log.exception("admission flush of %d rows failed", len(items))
            with self._lock:
                self.stats["flush_error"] = (
                    self.stats.get("flush_error", 0) + 1)
            for *_, fut in items:
                if not fut.done():
                    fut.set_result((ATTENTION, [], False))
        finally:
            tracing.unbind(_trace_tok)
            rec.finish(ft)

    def _host_eligible_rules(self, cps) -> frozenset:
        """Rule indices whose policy the flush may resolve host-side:
        cluster-independent policies only (oracle_pool.pool_safe) — a
        policy that needs a live cluster client keeps its HOST cells and
        escalates to the webhook's inline oracle. Cached on the compiled
        set (one id per policy generation)."""
        cached = getattr(cps, "_ktpu_host_eligible", None)
        if cached is None:
            from .oracle_pool import pool_safe

            safe_by_policy: dict[int, bool] = {}
            idx = set()
            for ref in cps.rule_refs:
                pid = id(ref.policy)
                ok = safe_by_policy.get(pid)
                if ok is None:
                    ok = safe_by_policy[pid] = pool_safe(ref.policy)
                if ok:
                    idx.add(ref.rule_index)
            cached = cps._ktpu_host_eligible = frozenset(idx)
        return cached

    def _start_host_prefetch(self, cps, items, resources):
        """Kick off dispatch-time resolution of the flush's statically
        host-only eligible cells (runtime/hostlane prefetch). Contexts
        come from the waiters' ctx_cb, built lazily — only rows that
        actually have host-only candidate rules pay the payload build.
        Returns the HostPrefetch join handle or None (disabled, no
        candidates, or any failure — the post-pass still covers
        everything)."""
        try:
            from . import hostlane

            eligible = self._host_eligible_rules(cps)
            if not eligible:
                return None

            def context_for(b):
                cb = items[b][1]
                return cb() if cb is not None else None

            return hostlane.resolver().prefetch(
                cps, resources, rule_filter=eligible,
                context_for=context_for)
        except Exception:
            return None

    def _resolve_flush_hosts(self, cps, items, resources, verdicts,
                             messages: dict, prefetch=None) -> int:
        """One batched oracle pass over the flush's eligible HOST cells;
        returns how many cells were resolved. A ``prefetch`` handle
        started at dispatch time joins first (its verdicts scatter into
        device-confirmed HOST cells only); the pass below covers
        whatever the prefetch didn't. Failures leave cells HOST (the
        webhook's oracle lane remains the correctness backstop)."""
        try:
            eligible = self._host_eligible_rules(cps)
            if not eligible:
                return 0
            v_live = verdicts[:len(items)]
            if prefetch is not None:
                applied = prefetch.apply(v_live, messages)
                if applied:
                    from . import hostlane

                    hostlane.resolver().note_applied(applied)
            host_cells = np.argwhere(v_live == Verdict.HOST)
            rows_with_host = sorted({int(b) for b, r in host_cells
                                     if int(r) in eligible})
            if not rows_with_host:
                return len(messages)
            contexts: list = [None] * len(items)
            for b in rows_with_host:
                cb = items[b][1]
                if cb is not None:
                    try:
                        contexts[b] = cb()
                    except Exception:
                        contexts[b] = None
            cps.resolve_host_cells(resources, v_live, contexts=contexts,
                                   rule_filter=eligible,
                                   messages_out=messages)
            return len(messages)
        except Exception:
            return len(messages)

    def _note_flush_stats(self, batch_size: int, host_resolved: int,
                          flush_cells: dict, flagged_rules: dict,
                          esc: dict, n_hits: int = 0, n_miss: int = 0,
                          queue_depth: int = 0,
                          overlap_s: float = 0.0,
                          host_prefetch_cells: int = 0,
                          host_overlap_s: float = 0.0,
                          batch_fill: float = 0.0,
                          attrib: dict | None = None,
                          namespace: str | None = None,
                          flush_s: float = 0.0) -> None:
        """Fold one flush's diagnostics into stats + the metrics registry
        (the routing split must be observable, not just in bench
        output)."""
        with self._lock:
            if host_resolved:
                self.stats["host_cells_resolved"] = (
                    self.stats.get("host_cells_resolved", 0) + host_resolved)
            cells = self.stats.setdefault("flush_cells", {})
            for k, n in flush_cells.items():
                cells[k] = cells.get(k, 0) + n
            flagged = self.stats.setdefault("flagged_rules", {})
            for k, n in flagged_rules.items():
                flagged[k] = flagged.get(k, 0) + n
            for k, n in esc.items():
                self.stats[f"esc_{k}"] = self.stats.get(f"esc_{k}", 0) + n
            # pipeline stage counters: rows served from the flatten memo
            # vs flattened fresh, and host seconds spent inside the async
            # dispatch's shadow (work that used to serialize after eval)
            if n_hits:
                self.stats["flatten_cache_hit_rows"] = (
                    self.stats.get("flatten_cache_hit_rows", 0) + n_hits)
            if n_miss:
                self.stats["flatten_cache_miss_rows"] = (
                    self.stats.get("flatten_cache_miss_rows", 0) + n_miss)
            if overlap_s > 0:
                self.stats["overlap_s_saved"] = (
                    self.stats.get("overlap_s_saved", 0.0) + overlap_s)
            # host-lane counters: cells answered by the dispatch-time
            # prefetch, and oracle seconds that ran inside the device
            # flight instead of after it
            if host_prefetch_cells:
                self.stats["host_prefetch_cells"] = (
                    self.stats.get("host_prefetch_cells", 0)
                    + host_prefetch_cells)
            if host_overlap_s > 0:
                self.stats["host_resolve_overlap_s"] = (
                    self.stats.get("host_resolve_overlap_s", 0.0)
                    + host_overlap_s)
        # cumulative memo survival (exact hits + epoch-extended rows over
        # all lookups) — the number that must stay high through a
        # policy-update storm
        memo = self._row_cache.stats()
        host_memo_delta = (0, 0)
        try:
            from .hostlane import host_cache

            hc = host_cache().stats()
            with self._lock:
                last = getattr(self, "_host_memo_last", (0, 0))
                host_memo_delta = (hc["hits"] - last[0],
                                   hc["misses"] - last[1])
                self._host_memo_last = (hc["hits"], hc["misses"])
                # process-wide host-verdict memo traffic, mirrored into
                # stats as absolute totals (bench reads the delta)
                self.stats["host_memo_hit"] = hc["hits"]
                self.stats["host_memo_miss"] = hc["misses"]
        except Exception:
            pass
        with self._lock:
            self.stats["flatten_memo_survival_ratio"] = (
                memo["survival_ratio"])
            self.stats["flatten_memo_extended_rows"] = memo["extended"]
        try:
            from . import metrics as metrics_mod

            reg = metrics_mod.registry()
            metrics_mod.record_flush_batch(reg, batch_size,
                                           host_resolved=host_resolved)
            for k, n in esc.items():
                metrics_mod.record_screen_escalation(reg, k, n)
            metrics_mod.record_flatten_rows(reg, hits=n_hits, misses=n_miss)
            if overlap_s > 0:
                metrics_mod.record_pipeline_overlap(reg, overlap_s)
            metrics_mod.record_flush_queue_depth(reg, queue_depth)
            if batch_fill > 0:
                metrics_mod.record_stream_gauges(reg,
                                                 inflight_fill=batch_fill)
            if memo["hits"] or memo["misses"]:
                metrics_mod.record_memo_survival(reg,
                                                 memo["survival_ratio"])
            metrics_mod.record_host_lane(
                reg, prefetch_cells=host_prefetch_cells,
                memo_hits=max(0, host_memo_delta[0]),
                memo_misses=max(0, host_memo_delta[1]),
                overlap_s=host_overlap_s)
            # per-policy attribution (bounded top-K + __other__) and
            # per-policy flush-latency observations — one call per
            # flush, fed from the scatter loop's aggregate
            if attrib:
                metrics_mod.record_policy_verdicts(
                    reg, [(p, r, v, n) for (p, r, v), n in attrib.items()],
                    lane="flush", namespace=namespace)
                if flush_s > 0:
                    metrics_mod.record_policy_flush_latency(
                        reg, {p for (p, _, _) in attrib}, flush_s)
        except Exception:
            pass

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._lock.notify()
        self._worker.join(timeout=2.0)
        self._flush_pool.shutdown(wait=False)
