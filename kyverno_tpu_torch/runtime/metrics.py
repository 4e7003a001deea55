"""Prometheus-format metrics registry.

Mirrors kyverno/pkg/metrics/metrics.go:43-100 — the same six
vectors with the same names — exposed in text format on /metrics
(prometheus_client is not baked into the image, so the exposition is
implemented directly; the format is the stable text/plain 0.0.4 protocol).
A periodic reset clears the registry like PromConfig's cron (metrics.go:17).
"""

from __future__ import annotations

import bisect
import platform
import threading
import time

from . import featureplane

METRIC_NAMES = (
    "kyverno_policy_results_total",
    "kyverno_policy_rule_info_total",
    "kyverno_policy_changes_total",
    "kyverno_policy_execution_duration_seconds",
    "kyverno_admission_review_duration_seconds",
    "kyverno_admission_requests_total",
)

# default cumulative-bucket ladder for latency histograms (seconds):
# spans the sub-ms device dispatch through the 10s webhook deadline so
# p50/p99 per pipeline stage are readable straight off the _bucket lines
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# per-metric ladders for histograms that aren't latencies
BUCKET_OVERRIDES = {
    "kyverno_admission_flush_batch_size": (
        1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0),
    # stream round-trips skip the webhook's HTTP/JSON tax — the ladder
    # keeps sub-ms resolution where the columnar path actually lands
    # while still covering queue-wait tails under saturation
    "kyverno_stream_request_duration_seconds": (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
        0.5, 1.0, 2.5),
    # replay latency is measured from the *scheduled* arrival, so the
    # ladder must cover queue-wait tails well past the per-event cost
    "kyverno_replay_latency_seconds": (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
        0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
}


def _escape_label_value(v) -> str:
    """Text 0.0.4 label-value escaping: backslash, double-quote, newline.
    Policy/rule names are user-controlled — an unescaped quote corrupts
    the whole scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_bound(b: float) -> str:
    """le= bound formatting: integral bounds render without the trailing
    .0 churn ("1" not "1.0" is what prometheus client_golang emits)."""
    return f"{b:g}"


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        # name -> frozenset(label items) -> value
        self._counters: dict[str, dict[frozenset, float]] = {}
        self._gauges: dict[str, dict[frozenset, float]] = {}
        # histogram series value: [count, sum, per-bucket counts] where
        # the per-bucket list is non-cumulative (bucket i counts values in
        # (bound[i-1], bound[i]], last slot = > last bound); render()
        # emits the cumulative le= form the text protocol requires
        self._histograms: dict[str, dict[frozenset, list]] = {}
        self._buckets: dict[str, tuple] = dict(BUCKET_OVERRIDES)
        self._last_reset = time.time()
        self._seed_static_series()

    def _seed_static_series(self) -> None:
        """Series that must exist on a fresh/reset registry: build info
        (one constant gauge a scraper can join on) and the reset stamp —
        the periodic PromConfig reset() is VISIBLE to scrapers instead of
        silently zeroing counters mid-rate()."""
        from .. import __version__

        self._gauges["kyverno_tpu_build_info"] = {
            frozenset({
                "version": __version__,
                "engine": "torch",
                "python": platform.python_version(),
            }.items()): 1.0}
        self._gauges["kyverno_metrics_last_reset_timestamp_seconds"] = {
            frozenset(): self._last_reset}

    # ------------------------------------------------------------ writes

    def inc_counter(self, name: str, labels: dict | None = None, value: float = 1.0) -> None:
        with self._lock:
            series = self._counters.setdefault(name, {})
            key = frozenset((labels or {}).items())
            series[key] = series.get(key, 0.0) + value

    def set_gauge(self, name: str, labels: dict | None = None, value: float = 0.0) -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[frozenset((labels or {}).items())] = value

    def set_buckets(self, name: str, bounds: tuple | list) -> None:
        """Per-metric bucket-ladder override; applies to observations made
        after the call (already-recorded series keep their shape)."""
        with self._lock:
            self._buckets[name] = tuple(sorted(set(float(b)
                                                   for b in bounds)))

    def observe(self, name: str, labels: dict | None = None, value: float = 0.0) -> None:
        self._observe_key(name, frozenset((labels or {}).items()), value)

    def _observe_key(self, name: str, key: frozenset,
                     value: float) -> None:
        """observe() with a pre-built label key — the tracing feed calls
        this once per span per trace and caches its frozensets."""
        with self._lock:
            bounds = self._buckets.get(name, DEFAULT_LATENCY_BUCKETS)
            series = self._histograms.setdefault(name, {})
            h = series.get(key)
            if h is None or len(h[2]) != len(bounds) + 1:
                h = series[key] = [0, 0.0, [0] * (len(bounds) + 1)]
            h[0] += 1
            h[1] += value
            # bisect_left: value == bound lands in le=bound, per protocol
            h[2][bisect.bisect_left(bounds, value)] += 1

    def reset(self) -> None:
        """PromConfig periodic registry reset (metrics.go:17)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._last_reset = time.time()
            self._seed_static_series()

    # ------------------------------------------------------------ reads

    @staticmethod
    def _fmt_labels(key: frozenset, extra: str = "") -> str:
        if not key and not extra:
            return ""
        inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                         for k, v in sorted(key))
        if extra:
            inner = f"{inner},{extra}" if inner else extra
        return "{" + inner + "}"

    def expose(self) -> str:
        """text/plain 0.0.4 exposition: counters, gauges, and real
        histograms (cumulative ``_bucket`` lines with ``le=`` labels plus
        ``+Inf``, then ``_sum``/``_count``)."""
        lines = []
        with self._lock:
            for name, series in sorted(self._counters.items()):
                lines.append(f"# TYPE {name} counter")
                for key, value in series.items():
                    lines.append(f"{name}{self._fmt_labels(key)} {value:g}")
            for name, series in sorted(self._gauges.items()):
                lines.append(f"# TYPE {name} gauge")
                for key, value in series.items():
                    lines.append(f"{name}{self._fmt_labels(key)} {value:g}")
            for name, series in sorted(self._histograms.items()):
                lines.append(f"# TYPE {name} histogram")
                bounds = self._buckets.get(name, DEFAULT_LATENCY_BUCKETS)
                for key, (count, total, per_bucket) in series.items():
                    cum = 0
                    for b, c in zip(bounds, per_bucket):
                        cum += c
                        le = 'le="' + _fmt_bound(b) + '"'
                        lines.append(f"{name}_bucket"
                                     f"{self._fmt_labels(key, le)} {cum:g}")
                    inf = 'le="+Inf"'
                    lines.append(f"{name}_bucket"
                                 f"{self._fmt_labels(key, inf)} {count:g}")
                    lines.append(f"{name}_count{self._fmt_labels(key)} {count:g}")
                    lines.append(f"{name}_sum{self._fmt_labels(key)} {total:g}")
        return "\n".join(lines) + "\n"

    # the exposition under its protocol-spec name; expose() predates it
    def render(self) -> str:
        return self.expose()

    def gauge_value(self, name: str,
                    labels: dict | None = None) -> float | None:
        """Current value of one gauge series (None if never set) — how
        the SLO watchdog and /healthz read pressure signals back out of
        the registry without scraping themselves."""
        with self._lock:
            series = self._gauges.get(name)
            if not series:
                return None
            return series.get(frozenset((labels or {}).items()))

    def counter_value(self, name: str,
                      labels: dict | None = None) -> float | None:
        """Current value of one counter series (None if never touched)."""
        with self._lock:
            series = self._counters.get(name)
            if not series:
                return None
            return series.get(frozenset((labels or {}).items()))

    def counter_total(self, name: str) -> float:
        """Sum over every label combination of one counter family."""
        with self._lock:
            return float(sum(self._counters.get(name, {}).values()))

    def histogram_count(self, name: str,
                        labels: dict | None = None) -> float:
        """Observation count of one histogram family; with ``labels``,
        summed over series whose labels are a superset of them."""
        want = set((labels or {}).items())
        with self._lock:
            series = self._histograms.get(name, {})
            return float(sum(h[0] for key, h in series.items()
                             if want <= set(key)))

    def series_count(self, name: str) -> int:
        """Label-combination cardinality of one metric family — what the
        attribution top-K bound is bounding."""
        with self._lock:
            for pop in (self._counters, self._gauges, self._histograms):
                if name in pop:
                    return len(pop[name])
            return 0

    def histogram_quantile(self, name: str, q: float,
                           labels: dict | None = None) -> float | None:
        """Bucket-interpolated quantile (the PromQL histogram_quantile
        recipe) straight off the registry — bench and the autotuner read
        p50/p99 per stage here without scraping themselves."""
        with self._lock:
            series = self._histograms.get(name, {})
            h = series.get(frozenset((labels or {}).items()))
            if h is None or h[0] == 0:
                return None
            bounds = self._buckets.get(name, DEFAULT_LATENCY_BUCKETS)
            count, _, per_bucket = h
            rank = q * count
            cum = 0
            for i, c in enumerate(per_bucket):
                cum += c
                if cum >= rank and c:
                    if i >= len(bounds):
                        return bounds[-1] if bounds else None
                    lo = bounds[i - 1] if i else 0.0
                    frac = (rank - (cum - c)) / c
                    return lo + (bounds[i] - lo) * frac
            return bounds[-1] if bounds else None


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


# ---------------------------------------------------------------- recorders
# (the per-metric subpackages of pkg/metrics)


def record_policy_results(registry: MetricsRegistry, policy: str, rule: str,
                          status: str, policy_type: str = "cluster",
                          validation_mode: str = "audit",
                          resource_kind: str = "", request_operation: str = "CREATE") -> None:
    registry.inc_counter("kyverno_policy_results_total", {
        "policy_name": policy,
        "rule_name": rule,
        "rule_result": status,
        "policy_type": policy_type,
        "policy_validation_mode": validation_mode,
        "resource_kind": resource_kind,
        "resource_request_operation": request_operation,
    })


def record_policy_rule_info(registry: MetricsRegistry, policy: str, rule: str,
                            rule_type: str, active: bool) -> None:
    registry.set_gauge("kyverno_policy_rule_info_total", {
        "policy_name": policy, "rule_name": rule, "rule_type": rule_type,
    }, 1.0 if active else 0.0)


def record_policy_change(registry: MetricsRegistry, policy: str, change: str) -> None:
    registry.inc_counter("kyverno_policy_changes_total", {
        "policy_name": policy, "policy_change_type": change,
    })


def record_policy_execution_duration(registry: MetricsRegistry, policy: str,
                                     rule: str, seconds: float) -> None:
    registry.observe("kyverno_policy_execution_duration_seconds", {
        "policy_name": policy, "rule_name": rule,
    }, seconds)


def record_admission_review_duration(registry: MetricsRegistry, operation: str,
                                     kind: str, seconds: float) -> None:
    registry.observe("kyverno_admission_review_duration_seconds", {
        "resource_request_operation": operation, "resource_kind": kind,
    }, seconds)


def record_admission_request(registry: MetricsRegistry, operation: str,
                             kind: str, allowed: bool) -> None:
    registry.inc_counter("kyverno_admission_requests_total", {
        "resource_request_operation": operation,
        "resource_kind": kind,
        "request_allowed": str(allowed).lower(),
    })


def record_flush_batch(registry: MetricsRegistry, size: int,
                       host_resolved: int = 0) -> None:
    """Per-flush device batch observability (runtime/batch.py _flush):
    realized batch size distribution plus how many HOST cells the flush
    resolved in its batched oracle pass."""
    registry.observe("kyverno_admission_flush_batch_size", {}, float(size))
    if host_resolved:
        registry.inc_counter("kyverno_admission_flush_host_cells_resolved_total",
                             {}, float(host_resolved))


def record_device_decidability(registry: MetricsRegistry, policy: str,
                               score: float) -> None:
    """Fraction of a policy's validate rules that compile to the device
    lattice (0.0 = pure CPU-oracle policy, 1.0 = fully device-decided).
    Set by the static analyzer at policy-cache admission and surfaced by
    bench.py next to the routing counters; a drop after a policy edit
    means the edit silently widened the host fallback."""
    registry.set_gauge("kyverno_policy_device_decidability",
                       {"policy_name": policy}, score)


def record_host_rule_info(registry: MetricsRegistry, policy: str, rule: str,
                          reason: str) -> None:
    """One gauge row per host-only rule, labelled with the
    ``EscalationReason`` value (models/ir.py) — the same taxonomy the
    KT101 lint diagnostic reports, so dashboards and lint output agree
    on why a rule escalates."""
    registry.set_gauge("kyverno_policy_host_rule_info", {
        "policy_name": policy, "rule_name": rule, "reason": reason,
    }, 1.0)


def record_flatten_rows(registry: MetricsRegistry, hits: int = 0,
                        misses: int = 0) -> None:
    """Flatten-row memo traffic (runtime/batch.py _flatten_flush): a row
    served from the content-addressed cache skipped its share of the
    host flatten entirely. Hit ratio ~0 on cache-adversarial workloads
    is expected — the memo keys resource *content*, not decisions."""
    if hits:
        registry.inc_counter("kyverno_flatten_rows_total",
                             {"result": "hit"}, float(hits))
    if misses:
        registry.inc_counter("kyverno_flatten_rows_total",
                             {"result": "miss"}, float(misses))


def record_pipeline_overlap(registry: MetricsRegistry,
                            seconds: float) -> None:
    """Host seconds spent doing useful work (the host lane's prefetch
    start, next window's flatten) inside an async device dispatch's
    shadow — time the serial dataflow would have added to the critical
    path."""
    registry.inc_counter("kyverno_pipeline_overlap_seconds_total", {},
                         seconds)


def record_flush_queue_depth(registry: MetricsRegistry, depth: int) -> None:
    """Flushes already submitted/in flight when a new flush dispatches —
    the pipeline's fill level. 0 = every flush ran alone (no cross-flush
    overlap); sustained depth near the pool size means the device lane
    is saturated and the window should widen."""
    registry.set_gauge("kyverno_admission_flush_queue_depth", {},
                       float(depth))


def record_policy_compile(registry: MetricsRegistry, seconds: float,
                          mode: str) -> None:
    """Tensor-set compile time per population rebuild, labelled
    ``mode="full"`` (from-scratch CompiledPolicySet) or
    ``mode="incremental"`` (segment splice — only the touched policy's
    segment recompiled). The incremental/full ratio under a policy-update
    storm is the headline number of bench config 6."""
    registry.observe("kyverno_policy_compile_seconds", {"mode": mode},
                     seconds)


def record_segments_spliced(registry: MetricsRegistry, count: int) -> None:
    """Segments reused verbatim (spliced, not recompiled) across
    incremental tensor-set refreshes. For an N-policy population, a
    single-policy update should splice N-1."""
    if count:
        registry.inc_counter("kyverno_policy_segments_spliced_total", {},
                             float(count))


def record_memo_survival(registry: MetricsRegistry, ratio: float) -> None:
    """Fraction of flatten-row memo lookups served without a full
    re-flatten (exact hits + epoch-extended rows) since startup. Falling
    toward 0 after policy churn means memos are being evicted instead of
    revalidated — the storm regression this PR's epoch keying prevents."""
    registry.set_gauge("kyverno_flatten_memo_survival_ratio", {}, ratio)


def record_dict_epoch(registry: MetricsRegistry, population: str,
                      epoch: int) -> None:
    """Append counter of a population's tensor dictionary. Monotonically
    increasing by small steps is healthy churn; a reset to a small value
    means the lineage was rebuilt and every memo keyed on it died."""
    registry.set_gauge("kyverno_policy_dict_epoch",
                       {"population": population}, float(epoch))


def record_host_lane(registry: MetricsRegistry, prefetch_cells: int = 0,
                     memo_hits: int = 0, memo_misses: int = 0,
                     overlap_s: float = 0.0, pool_cells: int = 0) -> None:
    """Host-lane resolution counters (runtime/hostlane — BENCH.md "Host
    lane" section). ``prefetch_cells``: HOST cells answered by the
    dispatch-time predictive prefetch instead of the post-device pass;
    ``memo_hits``/``memo_misses``: host-verdict memo traffic
    (HostVerdictCache); ``overlap_s``: oracle seconds that ran inside a
    device flight's shadow rather than on the serial tail;
    ``pool_cells``: cells resolved by OraclePool worker processes."""
    if prefetch_cells:
        registry.inc_counter("kyverno_host_prefetch_cells_total", {},
                             float(prefetch_cells))
    if memo_hits:
        registry.inc_counter("kyverno_host_memo_total",
                             {"result": "hit"}, float(memo_hits))
    if memo_misses:
        registry.inc_counter("kyverno_host_memo_total",
                             {"result": "miss"}, float(memo_misses))
    if overlap_s > 0:
        registry.inc_counter("kyverno_host_resolve_overlap_seconds_total",
                             {}, overlap_s)
    if pool_cells:
        registry.inc_counter("kyverno_host_pool_cells_total", {},
                             float(pool_cells))


_stage_labels_cache: dict = {}


def record_stage_duration(registry: MetricsRegistry, stage: str,
                          seconds: float, kind: str = "") -> None:
    """Per-pipeline-stage latency histogram (runtime/tracing feeds one
    observation per recorded span at trace finish). The ``stage`` label
    is the span name — flatten / coalesce_wait / device_dispatch /
    cold_dispatch / host_prefetch / host_resolve / scatter /
    response_marshal — and ``kind`` the trace kind (admission / flush /
    scan / scan_chunk), so `/metrics` answers "p99 of device dispatch
    under admission load" from the ``_bucket`` lines alone. The label
    keys are cached: this runs once per span per trace on the hot path
    and the (stage, kind) vocabulary is a couple dozen entries."""
    ck = (stage, kind)
    key = _stage_labels_cache.get(ck)
    if key is None:
        key = _stage_labels_cache[ck] = frozenset(
            {"stage": stage, "kind": kind}.items())
    registry._observe_key("kyverno_stage_duration_seconds", key, seconds)


_trace_kind_cache: dict = {}


def record_trace(registry: MetricsRegistry, kind: str,
                 seconds: float) -> None:
    """One finished trace: count by kind + end-to-end duration histogram
    (the flight recorder's scrape-side shadow)."""
    cached = _trace_kind_cache.get(kind)
    if cached is None:
        cached = _trace_kind_cache[kind] = (
            {"kind": kind}, frozenset({"kind": kind}.items()))
    labels, key = cached
    registry.inc_counter("kyverno_traces_total", labels)
    registry._observe_key("kyverno_trace_duration_seconds", key, seconds)


def record_stream_frame(registry: MetricsRegistry, ftype: str,
                        transport: str, seconds: float | None = None,
                        rows: int = 1, error: bool = False) -> None:
    """One streaming-plane admission frame (runtime/stream_server).
    ``ftype`` is the wire frame kind (json / row / block), ``transport``
    grpc or socket. ``seconds`` is ingest-to-response-encode, including
    time spent waiting inside a forming batch — the open-loop latency
    of the streaming plane."""
    registry.inc_counter("kyverno_stream_frames_total",
                         {"type": ftype, "transport": transport,
                          "result": "error" if error else "ok"})
    if rows > 1:
        registry.inc_counter("kyverno_stream_rows_total",
                             {"type": ftype}, float(rows))
    else:
        registry.inc_counter("kyverno_stream_rows_total", {"type": ftype})
    if seconds is not None:
        registry.observe("kyverno_stream_request_duration_seconds",
                         {"type": ftype, "transport": transport}, seconds)


def record_stream_gauges(registry: MetricsRegistry,
                         open_streams: int | None = None,
                         inflight_fill: float | None = None) -> None:
    """Streaming-plane fill levels: ``kyverno_stream_open_streams`` is
    the live bidirectional connection/stream count;
    ``kyverno_stream_inflight_batch_fill`` the live-row fraction of the
    most recent padded flush (1.0 = continuous batching packed every
    headroom slot; chronically low means the window fires too early for
    the offered rate)."""
    if open_streams is not None:
        registry.set_gauge("kyverno_stream_open_streams", {},
                           float(open_streams))
    if inflight_fill is not None:
        registry.set_gauge("kyverno_stream_inflight_batch_fill", {},
                           float(inflight_fill))


def record_stream_zero_copy(registry: MetricsRegistry, wire_rows: int = 0,
                            block_rows: int = 0, late_joins: int = 0,
                            donated: int = 0) -> None:
    """Zero-copy accounting for the columnar ingest path: rows spliced
    straight from wire bytes (no server-side flatten), rows evaluated
    in-place from a client block (no re-intern at all), late arrivals
    grafted into an in-flight batch's padding, and device dispatches
    whose input buffer was donated (steady state never copies)."""
    if wire_rows:
        registry.inc_counter("kyverno_stream_wire_rows_total", {},
                             float(wire_rows))
    if block_rows:
        registry.inc_counter("kyverno_stream_block_rows_total", {},
                             float(block_rows))
    if late_joins:
        registry.inc_counter("kyverno_stream_late_join_rows_total", {},
                             float(late_joins))
    if donated:
        registry.inc_counter("kyverno_stream_donated_dispatches_total", {},
                             float(donated))


def record_screen_escalation(registry: MetricsRegistry, reason: str,
                             value: float = 1.0) -> None:
    """Why a screened admission row escalated past CLEAN — the routing
    split the bench reports, as a production counter. Reasons:
    ``device_fail`` / ``device_error`` / ``host_unresolved`` (cells the
    flush could not resolve device-side) and ``clean`` for rows that
    short-circuited."""
    registry.inc_counter("kyverno_admission_screen_escalations_total",
                         {"reason": reason}, value)


# ------------------------------------------------- per-policy attribution
#
# kyverno_policy_verdicts_total{policy,rule,verdict,lane} answers "which
# policy is burning the budget", but an unbounded label space over a
# 10k-rule library would explode the registry (and every scrape). The
# bound: the first KTPU_ATTRIB_TOP_K distinct (policy, rule) pairs get
# real label values; everything past the cap folds into one
# policy="__other__",rule="__other__" overflow series per (verdict,
# lane). Exact per-pair totals are still kept in a plain dict (ints are
# cheap; label cardinality is what costs), so /debug/policies reports
# true counts for every pair including the suppressed tail.

ATTRIB_OTHER = "__other__"

_VERDICT_NAMES = ("NOT_APPLICABLE", "PASS", "FAIL", "SKIP", "ERROR", "HOST")


def attrib_top_k() -> int:
    """KTPU_ATTRIB_TOP_K: how many distinct (policy, rule) pairs get
    their own labelled series before overflow (default 64). Dynamic so
    tests/smokes can shrink it; shrinking does not retract already
    admitted pairs."""
    try:
        return max(1, featureplane.int_value("KTPU_ATTRIB_TOP_K"))
    except ValueError:
        return 64


_MAX_TENANTS = 256


class _AttributionState:
    """Bounded attribution accounting shared by every feed point (flush
    scatter, block eval, host-lane resolve, mesh scan chunks)."""

    def __init__(self):
        self.lock = threading.Lock()
        # (policy, rule) -> {verdict_name: count}; membership in this
        # dict == the pair owns labelled registry series
        self.members: dict[tuple, dict] = {}
        # exact totals for EVERY pair ever seen (member or overflow)
        self.totals: dict[tuple, int] = {}
        self.other_cells = 0
        # namespace -> {verdict_name: count}, bounded at _MAX_TENANTS
        self.tenants: dict[str, dict] = {}
        # label-key cache for the registry fast path: only member pairs
        # and the overflow series get keys, so this stays ~K*|verdicts|
        self.key_cache: dict[tuple, frozenset] = {}

    def reset(self) -> None:
        with self.lock:
            self.members.clear()
            self.totals.clear()
            self.tenants.clear()
            self.key_cache.clear()
            self.other_cells = 0


_attrib = _AttributionState()


def attrib_state() -> _AttributionState:
    return _attrib


def record_policy_verdicts(registry: MetricsRegistry, cells,
                           lane: str = "flush",
                           namespace: str | None = None) -> None:
    """Feed one batch of attribution cells. ``cells`` is an iterable of
    ``(policy, rule, verdict_name, count)`` aggregated by the caller per
    flush/chunk (the hot scatter loop builds a small dict, not one call
    per cell). No-op under KTPU_ATTRIB=0."""
    from .tracing import attrib_enabled

    if not attrib_enabled():
        return
    st = _attrib
    k = attrib_top_k()
    with st.lock:
        for policy, rule, verdict, count in cells:
            pair = (policy, rule)
            st.totals[pair] = st.totals.get(pair, 0) + count
            mem = st.members.get(pair)
            if mem is None:
                if len(st.members) < k:
                    mem = st.members[pair] = {}
                else:
                    st.other_cells += count
                    policy = rule = ATTRIB_OTHER
            if mem is not None:
                mem[verdict] = mem.get(verdict, 0) + count
            ck = (policy, rule, verdict, lane)
            key = st.key_cache.get(ck)
            if key is None:
                key = st.key_cache[ck] = frozenset({
                    "policy": policy, "rule": rule,
                    "verdict": verdict, "lane": lane}.items())
            # inc under the registry's own lock; st.lock -> registry
            # lock is the only nesting direction used anywhere
            with registry._lock:
                series = registry._counters.setdefault(
                    "kyverno_policy_verdicts_total", {})
                series[key] = series.get(key, 0.0) + count
        if namespace is not None:
            if namespace not in st.tenants and \
                    len(st.tenants) >= _MAX_TENANTS:
                namespace = ATTRIB_OTHER
            roll = st.tenants.setdefault(namespace, {})
            for _, _, verdict, count in cells:
                roll[verdict] = roll.get(verdict, 0) + count


def record_policy_verdict_matrix(registry: MetricsRegistry, rule_refs,
                                 verdicts, lane: str,
                                 namespace: str | None = None) -> None:
    """Vectorized attribution feed for whole verdict matrices ([B, R]
    numpy) — the scan/mesh paths. One (verdicts == v).sum(axis=0) pass
    per verdict value, then the same bounded recorder as the scatter
    loop; never one python iteration per cell."""
    from .tracing import attrib_enabled

    if not attrib_enabled() or verdicts is None or not len(rule_refs):
        return
    import numpy as np

    v = np.asarray(verdicts)
    if v.ndim != 2 or not v.shape[0]:
        return
    cells = []
    n_rules = min(v.shape[1], len(rule_refs))
    for code, vname in enumerate(_VERDICT_NAMES):
        counts = np.count_nonzero(v[:, :n_rules] == code, axis=0)
        for r in np.nonzero(counts)[0]:
            ref = rule_refs[int(r)]
            cells.append((ref.policy.name, ref.rule.name, vname,
                          int(counts[r])))
    record_policy_verdicts(registry, cells, lane=lane, namespace=namespace)


_policy_latency_keys: dict = {}


def record_policy_flush_latency(registry: MetricsRegistry, policies,
                                seconds: float) -> None:
    """Per-policy latency accounting: every policy that participated in
    a flush observes the flush's wall time in
    ``kyverno_policy_latency_seconds{policy}`` — so "p99 of admissions
    involving policy X" reads off histogram_quantile. Bounded by the
    same top-K membership as the verdict counter (non-member policies
    observe under ``__other__``)."""
    from .tracing import attrib_enabled

    if not attrib_enabled():
        return
    st = _attrib
    with st.lock:
        member_policies = {p for p, _ in st.members}
    for policy in policies:
        if policy not in member_policies:
            policy = ATTRIB_OTHER
        key = _policy_latency_keys.get(policy)
        if key is None:
            key = _policy_latency_keys[policy] = frozenset(
                {"policy": policy}.items())
        registry._observe_key("kyverno_policy_latency_seconds", key,
                              seconds)


def attribution_snapshot(limit: int = 0) -> dict:
    """/debug/policies payload: the labelled (top-K) pairs with their
    verdict breakdowns, exact totals for the suppressed tail, and the
    per-tenant (namespace) rollups."""
    st = _attrib
    with st.lock:
        rows = [{"policy": p, "rule": r,
                 "total": st.totals.get((p, r), 0),
                 "verdicts": dict(v)}
                for (p, r), v in st.members.items()]
        rows.sort(key=lambda d: -d["total"])
        if limit:
            rows = rows[:limit]
        tail = sorted(
            ((p, r, t) for (p, r), t in st.totals.items()
             if (p, r) not in st.members),
            key=lambda x: -x[2])
        return {
            "top_k": attrib_top_k(),
            "labelled_pairs": len(st.members),
            "tracked_pairs": len(st.totals),
            "other_cells": st.other_cells,
            "policies": rows,
            "overflow": [{"policy": p, "rule": r, "total": t}
                         for p, r, t in tail[:32]],
            "tenants": {ns: dict(v) for ns, v in st.tenants.items()},
        }


# ------------------------------------------------------- lint / certify


def record_lint_finding(registry: MetricsRegistry, code: str,
                        severity: str) -> None:
    """One static-analysis finding (KT1xx-KT5xx); the analyzer calls
    this per diagnostic so dashboards can rate() on lint regressions."""
    registry.inc_counter("kyverno_lint_findings_total",
                         {"code": code, "severity": severity})


def record_certified_rules(registry: MetricsRegistry,
                           counts: dict) -> None:
    """KT4xx certification outcome of the last splice, one gauge series
    per status ("certified" | "incomplete" | "host" | "divergent" |
    "unchecked"). Absent statuses are zeroed so a rule population
    shrinking out of "divergent" is visible as 0, not as a stale
    series."""
    for status in ("certified", "incomplete", "host", "divergent",
                   "unchecked"):
        registry.set_gauge("kyverno_certified_rules",
                           {"status": status},
                           float(counts.get(status, 0)))


def lint_findings_snapshot(registry: MetricsRegistry) -> dict:
    """/debug/policies payload fragment: per-code finding totals."""
    with registry._lock:
        series = registry._counters.get("kyverno_lint_findings_total", {})
        out: dict = {}
        for key, v in series.items():
            labels = dict(key)
            out[labels.get("code", "?")] = {
                "severity": labels.get("severity", "?"), "total": int(v)}
        certified = {
            dict(k).get("status", "?"): int(v)
            for k, v in registry._gauges.get(
                "kyverno_certified_rules", {}).items()}
    return {"lint_findings": out, "certified_rules": certified}


# ------------------------------------------------------------ SLO gauges


def record_slo_gauges(registry: MetricsRegistry, p99_short: float,
                      p99_long: float, burn_short: float,
                      burn_long: float, queue_pressure: float,
                      inflight_fill: float, degraded: bool,
                      budget_s: float) -> None:
    """The SLO watchdog's scrape surface (runtime/slo.py settles these
    at read time, mirroring the trace recorder's deferred-settle
    design). Burn rate is observed p99 over the deadline budget — 1.0
    means the window's p99 sits exactly at the budget."""
    registry.set_gauge("kyverno_slo_admission_p99_seconds",
                       {"window": "short"}, p99_short)
    registry.set_gauge("kyverno_slo_admission_p99_seconds",
                       {"window": "long"}, p99_long)
    registry.set_gauge("kyverno_slo_burn_rate", {"window": "short"},
                       burn_short)
    registry.set_gauge("kyverno_slo_burn_rate", {"window": "long"},
                       burn_long)
    registry.set_gauge("kyverno_slo_queue_pressure", {}, queue_pressure)
    registry.set_gauge("kyverno_slo_inflight_fill", {}, inflight_fill)
    registry.set_gauge("kyverno_slo_degraded", {},
                       1.0 if degraded else 0.0)
    registry.set_gauge("kyverno_slo_budget_seconds", {}, budget_s)


def record_slo_state_seconds(registry: MetricsRegistry, state: str,
                             seconds: float) -> None:
    """Wall time the degradation controller spent in ``state``
    (runtime/sloactions.py ticks this) — the fix for degraded stretches
    with an empty flush queue leaving no evidence: the counter moves on
    every controller tick, not only when a flush fires."""
    if seconds > 0:
        registry.inc_counter("kyverno_slo_state_seconds_total",
                             {"state": state}, float(seconds))


def record_slo_action_transition(registry: MetricsRegistry, action: str,
                                 direction: str) -> None:
    """One degradation-action engagement edge (``enter`` | ``exit``)."""
    registry.inc_counter("kyverno_slo_action_transitions_total",
                         {"action": action, "direction": direction})


def record_slo_shed_size(registry: MetricsRegistry, n: int) -> None:
    """Current size of the explicit shed set (0 when healthy)."""
    registry.set_gauge("kyverno_slo_shed_policies", {}, float(n))


def record_queue_shed(registry: MetricsRegistry, queue: str,
                      reason: str) -> None:
    """One bounded-queue shed, tagged with why (``slo`` =
    controller-driven, ``full`` = overflow) so dashboards can tell
    deliberate degradation from capacity loss."""
    registry.inc_counter("kyverno_queue_sheds_total",
                         {"queue": queue, "reason": reason})


# ------------------------------------- reports / events (reference ports)


def record_report_queue_depth(registry: MetricsRegistry, queued: int,
                              pending: int = 0) -> None:
    """Depth of the report generator's async change-request writer queue
    plus its unaggregated pending set (runtime/reports.py) — the fan-in
    backlog the reference tracks via its RCR workqueue."""
    registry.set_gauge("kyverno_report_queue_depth", {}, float(queued))
    registry.set_gauge("kyverno_report_pending_results", {}, float(pending))


def record_events(registry: MetricsRegistry, emitted: int = 0,
                  dropped: int = 0) -> None:
    """Cluster-event emission counters (runtime/events.py): events
    written vs events the rate-limited queue dropped."""
    if emitted:
        registry.inc_counter("kyverno_events_emitted_total", {},
                             float(emitted))
    if dropped:
        registry.inc_counter("kyverno_events_rate_limited_total", {},
                             float(dropped))


# ------------------------------------- workload plane (replay / dry-run)


def record_replay_events(registry: MetricsRegistry, leg: str,
                         n: int = 0, dropped: int = 0) -> None:
    """Per-leg replay delivery counters (workload/replay.py): events the
    worker pool processed vs events the bounded queue shed."""
    if n:
        registry.inc_counter("kyverno_replay_events_total",
                             {"leg": leg}, float(n))
    if dropped:
        registry.inc_counter("kyverno_replay_events_dropped_total",
                             {"leg": leg}, float(dropped))


def record_replay_latency(registry: MetricsRegistry, leg: str,
                          seconds: float) -> None:
    """One replayed event's latency from its *scheduled* arrival —
    queue wait included, so backlog is visible (open-loop semantics)."""
    registry.observe("kyverno_replay_latency_seconds", {"leg": leg},
                     seconds)


def record_replay_queue_depth(registry: MetricsRegistry, leg: str,
                              depth: int) -> None:
    """Dispatcher-side queue depth sampled at every release."""
    registry.set_gauge("kyverno_replay_queue_depth", {"leg": leg},
                       float(depth))


def record_dryrun_request(registry: MetricsRegistry, status: str,
                          seconds: float) -> None:
    """One dry-run evaluation (workload/dryrun.py): count by outcome +
    wall time."""
    registry.inc_counter("kyverno_dryrun_requests_total",
                         {"status": status})
    registry.observe("kyverno_dryrun_duration_seconds", {}, seconds)


def record_dryrun_blast_radius(registry: MetricsRegistry, policy: str,
                               newly_failing: int,
                               newly_passing: int) -> None:
    """Blast-radius gauges of the most recent dry-run per candidate —
    what a rollout dashboard plots before flipping enforcement."""
    registry.set_gauge("kyverno_dryrun_newly_failing",
                       {"policy": policy}, float(newly_failing))
    registry.set_gauge("kyverno_dryrun_newly_passing",
                       {"policy": policy}, float(newly_passing))


# ------------------------------------------------------------- profiling


def record_xla_compile(registry: MetricsRegistry, seconds: float,
                       what: str = "eval") -> None:
    """One kernel build: count + cumulative seconds, labelled by which
    kernel compiled. The JAX package records each XLA executable build
    here; the port has one ``nvcc`` build per CUDA source (ops/_build.py,
    at first use, or never when the hashed library is already built),
    and records that, under the same metric names."""
    registry.inc_counter("kyverno_xla_compiles_total", {"fn": what})
    registry.inc_counter("kyverno_xla_compile_seconds_total",
                         {"fn": what}, seconds)


def cuda_memory_stats(device=0) -> dict:
    """One card's memory in the gauge kinds of
    :func:`record_device_memory`: ``bytes_in_use`` and
    ``peak_bytes_in_use`` from the caching allocator's
    ``allocated_bytes.all.current`` / ``.peak`` in
    ``torch.cuda.memory_stats``, ``bytes_limit`` the card's total memory
    (``torch.cuda.mem_get_info``). Torch has no ``largest_alloc_size``,
    so that kind is left out. Raises where there is no card."""
    import torch

    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.mem_get_info(device)[1])}


def record_device_memory(registry: MetricsRegistry, stats: dict,
                         device: str = "0") -> None:
    """Device memory gauges (bytes_in_use / peak_bytes_in_use /
    bytes_limit / largest_alloc_size when the source reports them; on a
    card, :func:`cuda_memory_stats`)."""
    for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
              "largest_alloc_size"):
        if k in stats:
            registry.set_gauge("kyverno_device_memory_bytes",
                               {"device": device, "kind": k},
                               float(stats[k]))


def record_profile_capture(registry: MetricsRegistry,
                           seconds: float) -> None:
    """One completed /debug/profile window capture."""
    registry.inc_counter("kyverno_profile_captures_total", {})
    registry.inc_counter("kyverno_profile_capture_seconds_total", {},
                         seconds)


def record_mesh_devices(registry: MetricsRegistry, count: int,
                        platform_name: str) -> None:
    """Device inventory gauge stamped when a mesh is built
    (parallel/mesh.py make_mesh) — the denominator for any per-device
    rate an operator derives from the scan counters."""
    registry.set_gauge("kyverno_mesh_devices",
                       {"platform": platform_name}, float(count))
    _MESH_GEOMETRY["devices"] = int(count)
    _MESH_GEOMETRY["platform"] = str(platform_name)


# host-side snapshot of the last-built mesh + policy partition, embedded
# in /healthz (obs_http) so geometry is visible without scraping gauge
# label sets — and without /healthz touching a device
_MESH_GEOMETRY: dict = {"devices": 0, "platform": None, "axes": {},
                        "shard_rules": {}}


def record_mesh_shape(registry: MetricsRegistry, axis_names: tuple,
                      shape: tuple) -> None:
    """``kyverno_mesh_shape{axis}`` gauges for the mesh geometry the
    scan plane selected — a 1D mesh stamps only its data axis, a 2D
    ``(policy, data)`` mesh stamps both, so the kill-switch position of
    KTPU_MESH_SHAPE is scrape-visible."""
    for ax, size in zip(axis_names, shape):
        registry.set_gauge("kyverno_mesh_shape", {"axis": str(ax)},
                           float(size))
    # a geometry change replaces the whole axis map (stale axes from the
    # previous shape must not linger in the /healthz snapshot)
    _MESH_GEOMETRY["axes"] = {str(ax): int(size)
                              for ax, size in zip(axis_names, shape)}


def record_mesh_shard_rules(registry: MetricsRegistry,
                            counts: dict) -> None:
    """``kyverno_mesh_shard_rules{shard}`` — live rules per policy shard
    after a ShardedPolicySet refresh. The spread across shards is the
    partitioner's balance; the max is the per-device rule memory bound."""
    for shard, n in counts.items():
        registry.set_gauge("kyverno_mesh_shard_rules",
                           {"shard": str(shard)}, float(n))
    _MESH_GEOMETRY["shard_rules"] = {str(k): int(v)
                                     for k, v in counts.items()}


def mesh_geometry_snapshot() -> dict:
    """The /healthz mesh block: device inventory, selected axes, and the
    per-shard rule distribution (empty axes = no mesh built yet)."""
    return {"devices": _MESH_GEOMETRY["devices"],
            "platform": _MESH_GEOMETRY["platform"],
            "axes": dict(_MESH_GEOMETRY["axes"]),
            "shard_rules": dict(_MESH_GEOMETRY["shard_rules"])}


def record_fabric_frame(registry: MetricsRegistry, op: str,
                        tier: str) -> None:
    """One CACHE_GET/PUT/INVALIDATE frame handled by a fabric hub."""
    registry.inc_counter("kyverno_fabric_frames_total",
                         {"op": op, "tier": tier or "all"})


def record_fabric_lookup(registry: MetricsRegistry, tier: str,
                         hit: bool) -> None:
    """One client-side fabric lookup outcome, per cache tier. Hit rate
    across replicas is the fabric's reason to exist — a repeated-body
    lane with zero cross-replica hits means keys stopped being
    content-addressed somewhere."""
    name = ("kyverno_fabric_hits_total" if hit
            else "kyverno_fabric_misses_total")
    registry.inc_counter(name, {"tier": tier})


def record_fabric_invalidation(registry: MetricsRegistry, tier: str,
                               purged: int) -> None:
    """One epoch-bumping invalidation and how many rows it purged."""
    registry.inc_counter("kyverno_fabric_invalidations_total",
                         {"tier": tier or "all"})
    if purged:
        registry.inc_counter("kyverno_fabric_purged_rows_total",
                             {"tier": tier or "all"}, float(purged))


def record_fabric_failover(registry: MetricsRegistry,
                           replica: str) -> None:
    """One router failover away from a replica (error, F_ERROR reply,
    or open breaker at submit time)."""
    registry.inc_counter("kyverno_fabric_failovers_total",
                         {"replica": replica})


def record_scan_partition_rows(registry: MetricsRegistry, part: int,
                               rows: int) -> None:
    """``kyverno_scan_partition_rows{range}`` — rows this replica scanned
    in one partition on its last partitioned pass; the spread across
    ranges is the namespace-hash balance an operator checks before
    raising KTPU_SCAN_PARTITIONS."""
    registry.set_gauge("kyverno_scan_partition_rows",
                       {"range": str(part)}, float(rows))


def fleet_snapshot() -> dict:
    """The /healthz fleet block: fabric hub/client stats and scan
    coordinator state. Import is lazy and failure-proof so /healthz
    keeps answering on builds where the fleet plane never loaded."""
    try:
        from ..fleet import fabric as _fabric

        return _fabric.health_snapshot()
    except Exception:
        return {"enabled": False}
