"""SLO watchdog: rolling burn-rate tracking of admission latency against
the webhook deadline budget.

A Kubernetes ValidatingWebhookConfiguration gives the webhook at most
``timeoutSeconds`` (10s max) before the API server fails open or closed;
the fleet-level question is not "did one request blow it" but "is the
p99 *trending* into the budget". The watchdog keeps two rolling windows
(multi-window burn rate, the SRE-workbook alerting recipe: a short
window that reacts fast and a long window that suppresses blips) of
admission durations, computes p99 per window, and derives

    burn_rate = window_p99 / budget

1.0 means the window's p99 sits exactly at the deadline. ``degraded``
flips when BOTH windows burn past their thresholds — the short window
alone is noise, the long window alone is stale. Queue-depth and
inflight-fill pressure gauges (read back from the metrics registry) ride
along so an operator sees *why* the burn rose.

Observation only: the watchdog never touches a verdict. The batcher may
consult :func:`annotation` for load-shed *annotations* (labels on
flush traces/stats); acting on them is future work. ``KTPU_SLO=0``
turns the whole thing off — ``observe`` becomes a no-op and ``/healthz``
reports ``slo: {"enabled": false}`` with status ``ok``.

Knobs (all dynamic):

- ``KTPU_SLO_BUDGET_S``         deadline budget, default 10.0
- ``KTPU_SLO_WINDOW_SHORT_S``   short window, default 60
- ``KTPU_SLO_WINDOW_LONG_S``    long window, default 600
- ``KTPU_SLO_BURN_DEGRADED``    burn threshold for degraded, default 1.0
- ``KTPU_SLO_MIN_SAMPLES``      samples before a window votes, default 8

Same deferred-settle design as the trace recorder: ``observe()`` is a
lock-free deque append on the admission path; window eviction, p99, and
the ``kyverno_slo_*`` gauge updates all happen in :meth:`snapshot` on
the reader's thread (scrape, /healthz, watchdog consumers).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from . import featureplane
from . import metrics as metrics_mod
from .tracing import slo_enabled


def _env_f(name: str, default: float) -> float:
    try:
        return float(featureplane.raw(name))
    except ValueError:
        return default


def budget_s() -> float:
    return max(1e-9, _env_f("KTPU_SLO_BUDGET_S", 10.0))


def _p99(durations: list) -> float:
    if not durations:
        return 0.0
    xs = sorted(durations)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


class SLOWatchdog:
    """Rolling multi-window admission-latency burn tracker."""

    def __init__(self):
        # (monotonic timestamp, duration_s); appends are GIL-atomic, so
        # the admission path never takes a lock here
        self._samples: deque = deque(maxlen=65536)
        self._lock = threading.Lock()      # snapshot/evict only
        self._last_snap: tuple = (0.0, None)   # (monotonic, snapshot)
        self.stats = {"observed": 0, "degraded_snapshots": 0}

    # --------------------------------------------------------- hot path

    def observe(self, duration_s: float) -> None:
        """One finished admission (webhook review or stream frame).
        Lock-free; no-op under KTPU_SLO=0."""
        if not slo_enabled():
            return
        self._samples.append((time.monotonic(), duration_s))
        self.stats["observed"] += 1

    # ------------------------------------------------------- settle/read

    def snapshot(self) -> dict:
        """Settle and report: evict expired samples, compute per-window
        p99/burn, read pressure gauges, update kyverno_slo_* gauges.
        Runs on the reader's thread (scrape / healthz / batcher hook)."""
        if not slo_enabled():
            return {"enabled": False, "degraded": False}
        short_s = max(1.0, _env_f("KTPU_SLO_WINDOW_SHORT_S", 60.0))
        long_s = max(short_s, _env_f("KTPU_SLO_WINDOW_LONG_S", 600.0))
        threshold = _env_f("KTPU_SLO_BURN_DEGRADED", 1.0)
        min_n = max(1, int(_env_f("KTPU_SLO_MIN_SAMPLES", 8)))
        b = budget_s()
        now = time.monotonic()
        with self._lock:
            while self._samples and now - self._samples[0][0] > long_s:
                self._samples.popleft()
            snap = list(self._samples)
        short = [d for t, d in snap if now - t <= short_s]
        long_ = [d for _, d in snap]
        p99_short, p99_long = _p99(short), _p99(long_)
        burn_short, burn_long = p99_short / b, p99_long / b
        degraded = (len(short) >= min_n and burn_short >= threshold
                    and burn_long >= threshold)
        if degraded:
            self.stats["degraded_snapshots"] += 1

        reg = metrics_mod.registry()
        queue_depth = reg.gauge_value(
            "kyverno_admission_flush_queue_depth") or 0.0
        inflight_fill = reg.gauge_value(
            "kyverno_stream_inflight_batch_fill") or 0.0
        try:
            metrics_mod.record_slo_gauges(
                reg, p99_short=p99_short, p99_long=p99_long,
                burn_short=burn_short, burn_long=burn_long,
                queue_pressure=queue_depth, inflight_fill=inflight_fill,
                degraded=degraded, budget_s=b)
        except Exception:
            pass
        return {
            "enabled": True,
            "degraded": degraded,
            "budget_s": b,
            "burn_rate": {"short": round(burn_short, 4),
                          "long": round(burn_long, 4),
                          "threshold": threshold},
            "p99_s": {"short": round(p99_short, 6),
                      "long": round(p99_long, 6)},
            "windows_s": {"short": short_s, "long": long_s},
            "samples": {"short": len(short), "long": len(long_),
                        "min_for_vote": min_n},
            "pressure": {"flush_queue_depth": queue_depth,
                         "inflight_batch_fill": inflight_fill},
        }

    def cached_snapshot(self, max_age_s: float = 1.0) -> dict:
        """:meth:`snapshot`, amortized for per-flush consumers: reuse
        the last settle when it's younger than ``max_age_s`` so the
        flush hot path never re-sorts the sample windows."""
        now = time.monotonic()
        ts, snap = self._last_snap
        if snap is not None and now - ts <= max_age_s:
            return snap
        snap = self.snapshot()
        self._last_snap = (now, snap)
        return snap

    def degraded(self) -> bool:
        return bool(self.snapshot().get("degraded"))

    def annotation(self, max_age_s: float = 0.0) -> dict | None:
        """Load-shed annotation for the batcher: a small label dict when
        the fleet is degraded, else None. Annotate-only — callers stamp
        it on flush traces/stats and change no behavior. Positive
        ``max_age_s`` serves from the snapshot cache."""
        snap = (self.cached_snapshot(max_age_s) if max_age_s > 0
                else self.snapshot())
        if not snap.get("degraded"):
            return None
        return {"slo": "degraded",
                "slo_burn_short": snap["burn_rate"]["short"]}

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()
        self._last_snap = (0.0, None)
        self.stats["observed"] = 0
        self.stats["degraded_snapshots"] = 0


_watchdog: SLOWatchdog | None = None
_watchdog_lock = threading.Lock()


def watchdog() -> SLOWatchdog:
    global _watchdog
    if _watchdog is None:
        with _watchdog_lock:
            if _watchdog is None:
                _watchdog = SLOWatchdog()
    return _watchdog
