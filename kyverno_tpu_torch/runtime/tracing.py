"""Span recorder + flight recorder for scan chunks and host-lane work.

Every scan chunk and admission flush gets a trace; the stages it passes
through (flatten, device dispatch, host-lane prefetch / memo / join, host
resolve, scatter) record
spans with *lane provenance* — which KTPU_* kill-switch path served the
stage — so "where did this chunk spend its time" is answerable from the
runtime.

Design constraints, in order:

1. **Low overhead, on by default.** ``KTPU_TRACE=0`` is the kill switch
   (read dynamically, like every other KTPU_* switch); with it off,
   :meth:`TraceRecorder.start` returns ``None`` and every instrumentation
   site degenerates to a ``None`` check — no allocation, no lock. With
   it on, a span is one ``perf_counter`` pair, one small object, and one
   lock-free list append; ring admission is deferred to
   :meth:`TraceRecorder.settle`.
2. **Bounded memory.** The flight recorder keeps the last ``ring_size``
   completed traces (deque) plus the ``keep_slowest`` slowest (min-heap
   by duration). Traces cap their span count (``max_spans``) with an
   explicit ``spans_dropped`` counter instead of silent truncation.
3. **Cross-thread attribution.** The thread that owns a trace binds it
   with :func:`active` or :func:`bind` (a ``contextvars.ContextVar``);
   a flush's spans are adopted by every waiter's trace
   (:meth:`Trace.adopt_spans`); work handed to
   executor threads carries the trace explicitly. Spans carry a ``tid``
   (thread lane).

Reads: :meth:`TraceRecorder.traces` (newest first, or the slowest kept).
The JAX package's exports (Chrome trace JSON, ``/debug/traces``), its
metrics feed and its cross-process propagation come with the planes
that read them.
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
# each subsystem will take (provenance for "why was this one slow" — a
# flipped switch shows up right in the trace)
_LANE_SWITCHES = (
    ("flatten_pipeline", "KTPU_FLATTEN_PIPELINE"),
    ("host_prefetch", "KTPU_HOST_PREFETCH"),
    ("host_memo", "KTPU_HOST_MEMO"),
    ("host_fanout", "KTPU_HOST_FANOUT"),
)

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


class Span:
    """One timed stage. Immutable once ``end`` has stamped ``t1``."""

    __slots__ = ("name", "t0", "t1", "tid", "labels")

    def __init__(self, name: str, t0: float, t1: float, tid: str,
                 labels: dict | None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.labels = labels or {}

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)


class Trace:
    """One scan chunk (or other unit of work) worth of spans."""

    __slots__ = ("seq", "kind", "t_start", "t_end", "spans", "labels",
                 "max_spans", "spans_dropped", "_finished")

    def __init__(self, kind: str, labels: dict, max_spans: int):
        self.seq = next(_trace_seq)
        self.kind = kind
        self.t_start = time.perf_counter()
        self.t_end: float | None = None
        self.spans: list[Span] = []      # append is atomic under the GIL
        self.labels = labels
        self.max_spans = max_spans
        self.spans_dropped = 0
        self._finished = False

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
        # finished traces not yet admitted to the ring and heap —
        # admission is deferred off the finish() hot path and drained at
        # read time or at the backstop bound
        self._pending: deque[Trace] = deque()
        self.stats = {"started": 0, "finished": 0}

    # ------------------------------------------------------------ record

    def start(self, kind: str, **labels) -> Trace | None:
        """New trace, or None when tracing is off (every instrumentation
        site must tolerate None). Lane provenance (the KTPU_* switch
        matrix) is stamped once at start."""
        if not trace_enabled():
            return None
        labels.setdefault("lanes", _lanes_label())
        t = Trace(kind, labels, self.max_spans)
        # unlocked increment: a lost count under a concurrent-start race
        # only skews a monitoring counter, never a trace
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
        """Seal the trace and queue it. Ring/heap admission happens at
        settle time, not here: the deque append is GIL-atomic, so the
        seal is lock-free."""
        if trace is None or trace._finished:
            return
        trace._finished = True
        trace.t_end = time.perf_counter()
        if labels:
            trace.labels.update(labels)
        self._pending.append(trace)
        # backstop: never let an unread burst hold more than one ring's
        # worth unsettled — settle inline (rare, amortized)
        if len(self._pending) >= self.ring_size:
            self.settle()

    def settle(self) -> None:
        """Admit every pending finished trace to the ring and the
        K-slowest heap. Reads call this first, so the deferral is
        invisible to them."""
        while True:
            try:
                trace = self._pending.popleft()
            except IndexError:
                return
            with self._lock:
                self.stats["finished"] += 1
                self._ring.append(trace)
                entry = (trace.duration_s, trace.seq, trace)
                if len(self._slowest) < self.keep_slowest:
                    heapq.heappush(self._slowest, entry)
                elif self._slowest and entry[0] > self._slowest[0][0]:
                    heapq.heapreplace(self._slowest, entry)

    # ------------------------------------------------------------- reads

    def traces(self, n: int = 32, slowest: bool = False) -> list[Trace]:
        self.settle()
        with self._lock:
            if slowest:
                pool = sorted(self._slowest, reverse=True)[:n]
                return [t for _, _, t in pool]
            ring = list(self._ring)
        return ring[-n:][::-1]          # newest first

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slowest.clear()
            self._pending.clear()


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
    instrumented callees (hostlane) attribute their spans without
    threading a trace argument through every signature."""
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
