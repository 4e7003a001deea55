"""Profiling hooks: the port's counterpart of the reference's pprof.

The reference serves net/http/pprof on :6060 behind ``--profile``
(cmd/kyverno/main.go:119-128). Here the equivalent is an on-demand
``torch.profiler`` window capture: host operations and, on the card,
every kernel with its device time, written as a Chrome trace. Per-rule
wall times remain embedded in engine responses (RuleStats.ProcessingTime
parity), which covers the host-side view.

Torch has no trace server of its own (the JAX package starts
``jax.profiler.start_server``). ``maybe_start_profiler`` therefore
serves the on-demand capture, ``/debug/profile``, through the port's
observability routes on ``KTPU_PROFILE_PORT``.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time

from . import featureplane

TRACE_FILE = "trace.json"

_server_started = False
_server = None


def maybe_start_profiler(port: int | None = None) -> bool:
    """Serve the on-demand capture when asked to. ``port`` defaults to
    the KTPU_PROFILE_PORT env var; unset/0 disables — the --profile-gated
    behavior of the reference."""
    global _server_started, _server
    if _server_started:
        return True
    if port is None:
        try:
            port = featureplane.int_value("KTPU_PROFILE_PORT")
        except ValueError:
            port = 0
    if not port:
        return False
    from .obs_http import ObservabilityServer

    _server = ObservabilityServer(host="0.0.0.0", port=port)
    _server.start()
    _server_started = True
    return True


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture one trace window into ``log_dir/trace.json`` (Chrome
    trace format): host operations, and every kernel on the card when
    there is one. The programmatic twin of hitting the pprof endpoint."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def kernel_events(trace_file: str) -> list[dict]:
    """The device kernels of one captured trace: ``{"name", "ts", "dur"}``
    per launch, times in microseconds."""
    with open(trace_file, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    return [{"name": e.get("name", ""), "ts": float(e.get("ts", 0.0)),
             "dur": float(e.get("dur", 0.0))}
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


# --------------------------------------------- on-demand window capture
#
# /debug/profile?seconds=N (runtime/obs_http.py) starts a torch.profiler
# window capture into a tmpdir while live traffic keeps flowing — the
# operator never restarts a serving process to profile it. Single
# flight: one capture at a time; a second request while capturing
# reports "busy" instead of corrupting the active session.

MAX_CAPTURE_S = 60.0


class ProfileCaptureService:
    """Window-capture state machine behind /debug/profile."""

    def __init__(self):
        self._lock = threading.Lock()
        self._capturing = False
        self._window_open = False
        self._thread: threading.Thread | None = None
        self.last: dict = {}             # outcome of the last capture

    def status(self) -> dict:
        with self._lock:
            return {"capturing": self._capturing,
                    "window_open": self._window_open,
                    "last": dict(self.last)}

    def start(self, seconds: float, log_dir: str | None = None) -> dict:
        """Kick off one capture window on its own thread; returns
        immediately with the capture's log dir (or busy/error)."""
        seconds = min(max(0.05, float(seconds)), MAX_CAPTURE_S)
        with self._lock:
            if self._capturing:
                return {"status": "busy", "last": dict(self.last)}
            self._capturing = True
        if log_dir is None:
            log_dir = tempfile.mkdtemp(prefix="ktpu-profile-")
        # non-daemon on purpose: interpreter shutdown joins it BEFORE
        # finalization, so the profiler's stop and trace export always
        # run in a healthy runtime. A daemon thread left in a capture at
        # exit dies inside finalization, with the profiler's native
        # session still open. Worst case this delays exit by the capture
        # window plus the export.
        th = threading.Thread(target=self._run, args=(seconds, log_dir),
                              daemon=False, name="ktpu-profile-capture")
        with self._lock:
            self._thread = th
        th.start()
        return {"status": "capturing", "seconds": seconds,
                "log_dir": log_dir}

    def drain(self, timeout: float = MAX_CAPTURE_S + 30.0) -> None:
        """Block until any in-flight capture finishes (bounded)."""
        with self._lock:
            th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout)

    def _run(self, seconds: float, log_dir: str) -> None:
        t0 = time.time()
        err = None
        # the profiler's start, the window, then its stop and the export:
        # each on the capture's clock
        open_s = window = close_s = 0.0
        try:
            p0 = time.perf_counter()
            with trace(log_dir):
                w0 = time.perf_counter()
                with self._lock:
                    self._window_open = True
                time.sleep(seconds)
                w1 = time.perf_counter()
                with self._lock:
                    self._window_open = False
            open_s, window = w0 - p0, w1 - w0
            close_s = time.perf_counter() - w1
        except Exception as e:            # profiler unavailable/failed
            err = f"{type(e).__name__}: {e}"
        outcome = {
            "log_dir": log_dir,
            "trace_file": (os.path.join(log_dir, TRACE_FILE)
                           if err is None else None),
            "seconds": round(time.time() - t0, 3),
            "open_s": open_s,
            "window_s": window,
            "close_s": close_s,
            "requested_s": seconds,
            "finished_at": time.time(),
            "error": err,
        }
        with self._lock:
            self.last = outcome
            self._capturing = self._window_open = False
        if err is None:
            try:
                from . import metrics as metrics_mod

                metrics_mod.record_profile_capture(
                    metrics_mod.registry(), outcome["seconds"])
            except Exception:
                pass


_capture: ProfileCaptureService | None = None
_capture_lock = threading.Lock()


def capture_service() -> ProfileCaptureService:
    global _capture
    if _capture is None:
        with _capture_lock:
            if _capture is None:
                _capture = ProfileCaptureService()
    return _capture


def device_memory_snapshot(update_metrics: bool = True) -> dict:
    """Per-device memory accounting (bytes_in_use / peak / limit) from
    :func:`metrics.cuda_memory_stats`, gauge-fed into the registry. On
    the CPU there is no such report, and each device yields its platform
    alone (as the JAX package's CPU backend does) rather than failing
    the endpoint."""
    out: dict = {}
    try:
        import torch

        from . import metrics as metrics_mod

        if not torch.cuda.is_available():
            return {"0": {"platform": "cpu"}}
        for i in range(torch.cuda.device_count()):
            try:
                keep = metrics_mod.cuda_memory_stats(i)
            except Exception:
                keep = {}
            out[str(i)] = {"platform": "cuda", **keep}
            if update_metrics and keep:
                try:
                    metrics_mod.record_device_memory(
                        metrics_mod.registry(), keep, device=str(i))
                except Exception:
                    pass
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
    return out
