"""Shared worker-pool primitive for the async controllers.

The reference uses client-go workqueues with rate limiting and retries
(cmd/kyverno/main.go:480-518 worker counts); this is the in-process
equivalent used by the audit handler, event generator, and generate
controller.
"""

from __future__ import annotations

import queue
import threading
import time


class WorkerQueue:
    def __init__(self, handler, workers: int, name: str = "worker",
                 max_queued: int = 0, max_retries: int = 1,
                 shed_cb=None):
        self.handler = handler
        self.workers = workers
        self.name = name
        self.max_retries = max_retries
        # optional degradation hook: truthy return sheds the enqueue
        # before it touches the bounded queue (reason "slo")
        self.shed_cb = shed_cb
        self.queue: queue.Queue = queue.Queue(maxsize=max_queued)
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()
        self.processed = 0
        self.dropped = 0
        self.dropped_by_reason = {"slo": 0, "full": 0}

    def _record_shed(self, reason: str) -> None:
        self.dropped += 1
        self.dropped_by_reason[reason] = (
            self.dropped_by_reason.get(reason, 0) + 1)
        try:
            from . import metrics as metrics_mod

            metrics_mod.record_queue_shed(metrics_mod.registry(),
                                          self.name, reason)
        except Exception:
            pass

    def add(self, item) -> bool:
        if self.shed_cb is not None:
            try:
                shed = bool(self.shed_cb())
            except Exception:
                shed = False
            if shed:
                self._record_shed("slo")
                return False
        try:
            self.queue.put_nowait((item, 0))
            return True
        except queue.Full:
            self._record_shed("full")
            return False

    def run(self) -> None:
        if self._threads:
            return
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, name=f"{self.name}-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1)
        self._threads = []

    def drain(self, timeout: float = 5.0) -> None:
        """Wait until queued AND in-flight work completes."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._in_flight_lock:
                busy = self._in_flight
            if self.queue.empty() and busy == 0:
                return
            time.sleep(0.01)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                item, attempt = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            with self._in_flight_lock:
                self._in_flight += 1
            try:
                self.handler(item)
                self.processed += 1
            except Exception:
                if attempt + 1 < self.max_retries:
                    self.queue.put((item, attempt + 1))
            finally:
                with self._in_flight_lock:
                    self._in_flight -= 1
                self.queue.task_done()
