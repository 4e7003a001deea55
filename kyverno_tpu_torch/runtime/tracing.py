"""End-to-end admission/scan tracing: span recorder + flight recorder.

Every admission request and scan chunk gets a trace id; the stages it
passes through (flatten, memo hit/miss, coalesce wait, device dispatch,
a shape bucket's cold dispatch, host-lane prefetch/memo/pool, scatter,
response marshal)
record spans with *lane provenance* — which KTPU_* kill-switch path and
which cache served the stage — so "where did THIS slow request spend its
time" is answerable from the runtime, not from bench printouts.

Design constraints, in order:

1. **Low overhead, on by default.** ``KTPU_TRACE=0`` is the kill switch
   (read dynamically, like every other KTPU_* switch); with it off,
   :meth:`TraceRecorder.start` returns ``None`` and every instrumentation
   site degenerates to a ``None`` check plus a shared no-op context
   manager — no allocation, no lock. With it on, a span is one
   ``perf_counter`` pair, one small object, and one lock-free list
   append; ring admission and histogram observation are deferred to
   :meth:`TraceRecorder.feed_metrics`.
2. **Bounded memory.** The flight recorder keeps the last ``ring_size``
   completed traces (deque) plus the ``keep_slowest`` slowest (min-heap
   by duration) — the two populations a latency investigation actually
   needs. Traces cap their span count (``max_spans``) with an explicit
   ``spans_dropped`` counter instead of silent truncation.
3. **Cross-thread attribution.** The webhook thread owns the admission
   trace (propagated via a ``contextvars.ContextVar``); the flush runs
   on a pool thread serving MANY waiters, so it records into its own
   ``kind="flush"`` trace and the batcher copies the flush's spans into
   every waiter's trace at scatter time (span objects are immutable
   after end, so sharing is safe). Spans carry a ``tid`` (thread lane)
   so a Chrome/Perfetto render puts webhook wait and flush work on
   separate tracks, properly nested in wall time.

Exports: Chrome ``trace_event`` JSON (``chrome_trace``) loadable in
chrome://tracing / Perfetto, and a plain-JSON schema (``to_dict``)
served by ``/debug/traces`` (runtime/obs_http.py). Stage latencies feed
``kyverno_stage_duration_seconds`` bucket histograms in the metrics
registry at settle time (:meth:`TraceRecorder.feed_metrics`, which every
read calls first), which is where /metrics p50/p99 per stage come from.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import itertools
import threading
import time
from collections import deque

from . import featureplane


def trace_enabled() -> bool:
    """KTPU_TRACE=0 kill switch — dynamic, like every KTPU_* lane flag."""
    return featureplane.enabled("KTPU_TRACE")


# the kill-switch matrix snapshot attached to every trace: which lane
# each subsystem will take for this request (provenance for "why was
# this one slow" — a flipped switch shows up right in the trace)
_LANE_SWITCHES = (
    ("flatten_pipeline", "KTPU_FLATTEN_PIPELINE"),
    ("incremental", "KTPU_INCREMENTAL"),
    ("host_prefetch", "KTPU_HOST_PREFETCH"),
    ("host_memo", "KTPU_HOST_MEMO"),
    ("host_fanout", "KTPU_HOST_FANOUT"),
    ("stream", "KTPU_STREAM"),
    ("donate", "KTPU_DONATE"),
    ("attrib", "KTPU_ATTRIB"),
    ("slo", "KTPU_SLO"),
    ("propagate", "KTPU_PROPAGATE"),
)


def attrib_enabled() -> bool:
    """KTPU_ATTRIB=0 kill switch for per-policy attribution metrics."""
    return featureplane.enabled("KTPU_ATTRIB")


def slo_enabled() -> bool:
    """KTPU_SLO=0 kill switch for the SLO watchdog (observation only —
    the watchdog never changes verdicts either way)."""
    return featureplane.enabled("KTPU_SLO")


def propagate_enabled() -> bool:
    """KTPU_PROPAGATE=0 kill switch for cross-process trace-context
    propagation (stream frames, webhook headers, oracle-pool payloads)."""
    return featureplane.enabled("KTPU_PROPAGATE")


def killswitch_lanes() -> dict:
    """{switch: "on"|"off"} for the runtime's KTPU_* lane matrix."""
    return {name: ("on" if featureplane.enabled(env) else "off")
            for name, env in _LANE_SWITCHES}


_lanes_cache: tuple | None = None       # (env snapshot, rendered label)


def _lanes_label() -> str:
    """The trace's ``lanes`` provenance label, cached on the env
    snapshot — trace start is the hot path and the switches flip rarely,
    so re-rendering the string per trace is pure overhead."""
    global _lanes_cache
    snap = tuple(not featureplane.enabled(env)
                 for _, env in _LANE_SWITCHES)
    cached = _lanes_cache
    if cached is not None and cached[0] == snap:
        return cached[1]
    rendered = ",".join(f"{name}=off" for (name, _), off
                        in zip(_LANE_SWITCHES, snap) if off) or "all-on"
    _lanes_cache = (snap, rendered)
    return rendered


_trace_seq = itertools.count(1)
_span_seq = itertools.count(1)

_metrics_mod = None


def _metrics():
    """metrics module, imported lazily once (layering: metrics must not
    import tracing) and memoized off the finish() hot path."""
    global _metrics_mod
    if _metrics_mod is None:
        from . import metrics as metrics_mod

        _metrics_mod = metrics_mod
    return _metrics_mod


class Span:
    """One timed stage. Immutable once ``end`` has stamped ``t1``."""

    __slots__ = ("name", "t0", "t1", "tid", "labels", "_counted")

    def __init__(self, name: str, t0: float, t1: float, tid: str,
                 labels: dict | None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.labels = labels or {}
        # shared flush spans are adopted into many waiter traces; the
        # stage histogram must observe each measured interval once
        self._counted = False

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_dict(self, origin: float) -> dict:
        return {
            "name": self.name,
            "t0_us": int((self.t0 - origin) * 1e6),
            "dur_us": int(self.duration_s * 1e6),
            "tid": self.tid,
            "labels": {k: str(v) for k, v in self.labels.items()},
        }


class Trace:
    """One admission request / scan chunk / flush worth of spans."""

    __slots__ = ("seq", "t_wall", "_trace_id", "kind", "t_start", "t_end",
                 "spans", "labels", "max_spans", "spans_dropped",
                 "_finished")

    def __init__(self, kind: str, labels: dict, max_spans: int):
        # id parts captured now, rendered lazily — formatting is pure
        # overhead for the many traces nobody ever exports
        self.seq = next(_trace_seq)
        self.t_wall = time.time()
        self._trace_id: str | None = None
        self.kind = kind
        self.t_start = time.perf_counter()
        self.t_end: float | None = None
        self.spans: list[Span] = []      # append is atomic under the GIL
        self.labels = labels
        self.max_spans = max_spans
        self.spans_dropped = 0
        self._finished = False

    @property
    def trace_id(self) -> str:
        if self._trace_id is None:
            self._trace_id = f"{int(self.t_wall):x}-{self.seq:06x}"
        return self._trace_id

    @property
    def duration_s(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return max(0.0, end - self.t_start)

    def add_span(self, span: Span) -> None:
        if len(self.spans) >= self.max_spans:
            self.spans_dropped += 1
            return
        self.spans.append(span)

    def adopt_spans(self, spans: list[Span]) -> None:
        """Attach another trace's (finished, immutable) spans — how a
        shared flush's work is attributed to every waiter's trace."""
        for s in spans:
            self.add_span(s)

    def stage_names(self) -> set:
        return {s.name for s in self.spans}

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "duration_us": int(self.duration_s * 1e6),
            "labels": {k: str(v) for k, v in self.labels.items()},
            "spans_dropped": self.spans_dropped,
            "spans": [s.to_dict(self.t_start)
                      for s in sorted(self.spans, key=lambda s: s.t0)],
        }


class _NoOpSpan:
    """Shared no-op context manager: the disabled/no-trace fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoOpSpan()


class _LiveSpan:
    __slots__ = ("_trace", "_name", "_labels", "_t0")

    def __init__(self, trace: Trace, name: str, labels: dict | None):
        self._trace = trace
        self._name = name
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def label(self, **kv) -> None:
        """Stamp labels discovered mid-stage (memo hit counts, lanes)."""
        if self._labels is None:
            self._labels = {}
        self._labels.update(kv)

    def __exit__(self, *exc):
        self._trace.add_span(Span(
            self._name, self._t0, time.perf_counter(),
            threading.current_thread().name, self._labels))
        return False


class TraceRecorder:
    """Flight recorder: last-N ring + K-slowest heap of finished traces."""

    def __init__(self, ring_size: int = 256, keep_slowest: int = 32,
                 max_spans: int = 512):
        self.ring_size = ring_size
        self.keep_slowest = keep_slowest
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._ring: deque[Trace] = deque(maxlen=ring_size)
        # min-heap of (duration_s, seq, Trace): the root is the FASTEST
        # of the kept-slowest set, evicted first
        self._slowest: list[tuple] = []
        # finished traces whose spans haven't fed the stage histograms
        # yet — feeding is deferred off the finish() hot path (finish
        # runs on the admission/pipeline critical path) and drained at
        # read time (scrape, export) or at the backstop bound
        self._pending_metrics: deque[Trace] = deque()
        self.stats = {"started": 0, "finished": 0, "dropped_unfinished": 0}

    # ------------------------------------------------------------ record

    def start(self, kind: str, **labels) -> Trace | None:
        """New trace, or None when tracing is off (every instrumentation
        site must tolerate None). Lane provenance (the KTPU_* switch
        matrix) is stamped once at start."""
        if not trace_enabled():
            return None
        labels.setdefault("lanes", _lanes_label())
        t = Trace(kind, labels, self.max_spans)
        # unlocked increment: trace start is the hot path, and a lock
        # here measurably stalls the pipeline (GIL handoff against the
        # prefetch/flush threads). A lost count under a concurrent-start
        # race only skews a monitoring counter, never a trace.
        self.stats["started"] += 1
        return t

    def span(self, trace: Trace | None, name: str, **labels):
        """Context manager recording one stage span onto ``trace``."""
        if trace is None:
            return _NOOP
        return _LiveSpan(trace, name, labels or None)

    def add_span(self, trace: Trace | None, name: str, t0: float,
                 t1: float, tid: str | None = None, **labels) -> Span | None:
        """Explicit-timestamp span (perf_counter seconds) — for stages
        measured on threads that can't hold a context manager open.
        Returns the Span (callers share it with sibling traces)."""
        if trace is None:
            return None
        span = Span(name, t0, t1,
                    tid or threading.current_thread().name,
                    labels or None)
        trace.add_span(span)
        return span

    def finish(self, trace: Trace | None, **labels) -> None:
        """Seal the trace and queue it. Ring/heap admission and the
        histogram feed happen at settle time, NOT here: finish() sits on
        the admission/pipeline critical path, where even an uncontended
        lock acquisition measurably stalls the next window's dispatch
        (GIL handoff against the prefetch/flush threads). The deque
        append is GIL-atomic, so the seal is lock-free."""
        if trace is None or trace._finished:
            return
        trace._finished = True
        trace.t_end = time.perf_counter()
        if labels:
            trace.labels.update(labels)
        self._pending_metrics.append(trace)
        # backstop: never let an unscraped burst hold more than one
        # ring's worth unsettled — settle inline (rare, amortized)
        if len(self._pending_metrics) >= self.ring_size:
            self.feed_metrics()

    def feed_metrics(self) -> None:
        """Settle every pending finished trace: admit it to the ring and
        K-slowest heap and feed its spans into the per-stage latency
        histograms (kyverno_stage_duration_seconds / traces_total).
        Reads (scrape, export, /debug/traces) call this first, so the
        deferral is invisible to consumers. Shared adopted spans observe
        once — the _counted flag survives the span being queued under
        several traces."""
        try:
            metrics_mod = _metrics()
            reg = metrics_mod.registry()
        except Exception:
            metrics_mod = reg = None
        while True:
            try:
                trace = self._pending_metrics.popleft()
            except IndexError:
                return
            with self._lock:
                self.stats["finished"] += 1
                self._ring.append(trace)
                entry = (trace.duration_s, next(_span_seq), trace)
                if len(self._slowest) < self.keep_slowest:
                    heapq.heappush(self._slowest, entry)
                elif self._slowest and entry[0] > self._slowest[0][0]:
                    heapq.heapreplace(self._slowest, entry)
            if reg is None:
                continue
            try:
                metrics_mod.record_trace(reg, trace.kind, trace.duration_s)
                for span in trace.spans:
                    if span._counted:
                        continue
                    span._counted = True
                    metrics_mod.record_stage_duration(
                        reg, span.name, span.duration_s, kind=trace.kind)
            except Exception:
                pass

    # ------------------------------------------------------------- reads

    def traces(self, n: int = 32, slowest: bool = False) -> list[Trace]:
        self.feed_metrics()             # reads settle the deferred feed
        with self._lock:
            if slowest:
                pool = sorted(self._slowest, reverse=True)[:n]
                return [t for _, _, t in pool]
            ring = list(self._ring)
        return ring[-n:][::-1]          # newest first

    def slowest(self, n: int = 32) -> list[Trace]:
        return self.traces(n, slowest=True)

    def export(self, n: int = 32, slowest: bool = False) -> list[dict]:
        return [t.to_dict() for t in self.traces(n, slowest=slowest)]

    def chrome_trace(self, n: int = 32, slowest: bool = False) -> dict:
        """Chrome trace_event JSON ("X" complete events, µs timestamps on
        the shared perf_counter timeline) — load in chrome://tracing or
        Perfetto. One pid per trace so concurrent requests stack instead
        of interleaving."""
        events = []
        tids: dict[str, int] = {}
        for pid, trace in enumerate(self.traces(n, slowest=slowest), 1):
            events.append({
                "name": f"{trace.kind}:{trace.trace_id}",
                "ph": "X",
                "ts": trace.t_start * 1e6,
                "dur": trace.duration_s * 1e6,
                "pid": pid, "tid": 0, "cat": trace.kind,
                "args": {k: str(v) for k, v in trace.labels.items()},
            })
            for span in sorted(trace.spans, key=lambda s: s.t0):
                tid = tids.setdefault(span.tid, len(tids) + 1)
                events.append({
                    "name": span.name,
                    "ph": "X",
                    "ts": span.t0 * 1e6,
                    "dur": span.duration_s * 1e6,
                    "pid": pid, "tid": tid, "cat": trace.kind,
                    "args": {k: str(v) for k, v in span.labels.items()},
                })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"source": "kyverno-tpu flight recorder"}}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slowest.clear()
            self._pending_metrics.clear()


_recorder: TraceRecorder | None = None
_recorder_lock = threading.Lock()


def recorder() -> TraceRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = TraceRecorder()
    return _recorder


# ------------------------------------------------------- thread context

_current: contextvars.ContextVar[Trace | None] = contextvars.ContextVar(
    "ktpu_trace", default=None)


def current() -> Trace | None:
    """The thread's active trace (None off / outside any trace)."""
    return _current.get()


@contextlib.contextmanager
def active(trace: Trace | None):
    """Bind ``trace`` as the thread's current trace for the block — how
    instrumented callees (hostlane, flatten) attribute their spans
    without threading a trace argument through every signature."""
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)


def bind(trace: Trace | None):
    """Imperative form of :func:`active` for frames whose try/finally
    structure can't nest a with-block; pair with :func:`unbind`."""
    return _current.set(trace)


def unbind(token) -> None:
    _current.reset(token)


# ------------------------------------------- cross-process propagation
#
# W3C-traceparent-style context: ``00-<trace-id 32hex>-<span-id 16hex>-01``.
# The 32-hex trace-id field carries the recorder's native trace id
# (ascii, e.g. "688f3c1a-00012f") hex-encoded and zero-padded, so the id
# an operator sees at /debug/traces on the client is the byte-identical
# id on the server — no lossy re-mapping. Ids longer than 16 bytes
# (already-W3C remote ids re-propagated downstream) pass through as raw
# 32-hex. The span-id field is informational (we propagate trace
# identity, not parent-span causality — span nesting is reconstructed
# from wall time).

TRACEPARENT_HEADER = "traceparent"

_TP_VERSION = "00"


def make_traceparent(trace: Trace | None) -> str | None:
    """Render ``trace``'s id as a traceparent string, or None when
    there is nothing to propagate (no trace, or KTPU_PROPAGATE=0)."""
    if trace is None or not propagate_enabled():
        return None
    tid = trace.trace_id
    raw = tid.encode()
    if len(raw) <= 16:
        hex32 = raw.hex().ljust(32, "0")
    elif len(tid) == 32 and all(c in "0123456789abcdef" for c in tid):
        hex32 = tid                      # already a W3C-format id
    else:
        import hashlib

        hex32 = hashlib.blake2b(raw, digest_size=16).hexdigest()
    return f"{_TP_VERSION}-{hex32}-{trace.seq & 0xFFFFFFFFFFFFFFFF:016x}-01"


def parse_traceparent(value) -> str | None:
    """Native trace id carried by a traceparent string, or None when the
    header is absent/malformed (the caller keeps its local id). Inverse
    of :func:`make_traceparent` for ids we minted; foreign W3C ids come
    back as their raw 32-hex form."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32:
        return None
    hex32 = parts[1].lower()
    if any(c not in "0123456789abcdef" for c in hex32):
        return None
    if hex32 == "0" * 32:
        return None                      # invalid per the W3C spec
    try:
        raw = bytes.fromhex(hex32).rstrip(b"\x00")
        decoded = raw.decode("ascii")
        # our minted ids are printable "<hex>-<hex>"; anything else is a
        # foreign id and keeps its 32-hex spelling
        if decoded and all(33 <= b < 127 for b in raw):
            return decoded
    except (ValueError, UnicodeDecodeError):
        pass
    return hex32


def adopt_remote_id(trace: Trace | None, remote_id: str | None) -> bool:
    """Install a propagated trace id onto a locally-started trace, so
    the client-side and server-side halves of one admission export under
    a single id. Must run before the trace's id is first read. Returns
    True when adopted."""
    if trace is None or not remote_id or not propagate_enabled():
        return False
    trace._trace_id = remote_id
    trace.labels.setdefault("remote", "1")
    return True
