"""Event generator: buffered, rate-limited emitter of Kubernetes Events.

Mirrors kyverno/pkg/event/controller.go: a bounded queue (1000)
drained by worker threads that write Event objects through the client;
separate sources for policy-controller / admission / generate emitters.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .workqueue import WorkerQueue

# event reasons (pkg/event/reason.go)
POLICY_VIOLATION = "PolicyViolation"
POLICY_APPLIED = "PolicyApplied"
POLICY_FAILED = "PolicyFailed"
POLICY_SKIPPED = "PolicySkipped"


@dataclass
class EventInfo:
    kind: str = ""
    name: str = ""
    namespace: str = ""
    reason: str = ""
    message: str = ""
    source: str = "kyverno-admission"


class EventGenerator:
    """controller.go:54 NewEventGenerator: Add() enqueues, workers drain."""

    def __init__(self, client, max_queued: int = 1000, workers: int = 3):
        self.client = client
        self._wq = WorkerQueue(self._emit, workers, name="event",
                               max_queued=max_queued)
        self.emitted = 0

    @property
    def dropped(self) -> int:
        return self._wq.dropped

    def add(self, *infos: EventInfo) -> None:
        d0 = self._wq.dropped
        for info in infos:
            if info.name:
                self._wq.add(info)
        dropped = self._wq.dropped - d0
        if dropped:
            try:
                from . import metrics as metrics_mod

                metrics_mod.record_events(metrics_mod.registry(),
                                          dropped=dropped)
            except Exception:
                pass

    def run(self) -> None:
        self._wq.run()

    def stop(self) -> None:
        self._wq.stop()

    def drain(self, timeout: float = 5.0) -> None:
        self._wq.drain(timeout)

    def _emit(self, info: EventInfo) -> None:
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                "name": f"{info.name}.{int(time.time() * 1e6):x}",
                "namespace": info.namespace or "default",
            },
            "involvedObject": {
                "kind": info.kind,
                "name": info.name,
                "namespace": info.namespace,
            },
            "reason": info.reason,
            "message": info.message,
            "source": {"component": info.source},
            "type": "Warning" if info.reason == POLICY_VIOLATION else "Normal",
        }
        self.client.create_resource(event)
        self.emitted += 1
        try:
            from . import metrics as metrics_mod

            metrics_mod.record_events(metrics_mod.registry(), emitted=1)
        except Exception:
            pass


def events_for_engine_response(resp, generate_success_events: bool = False) -> list[EventInfo]:
    """pkg/event helpers: violations on the resource, applied on success."""
    from ..engine.response import RuleStatus

    out = []
    pr = resp.policy_response
    for rule in pr.rules:
        if rule.status is RuleStatus.FAIL:
            out.append(EventInfo(
                kind=pr.resource.kind, name=pr.resource.name,
                namespace=pr.resource.namespace, reason=POLICY_VIOLATION,
                message=f"policy {pr.policy.name}/{rule.name} fail: {rule.message}",
            ))
        elif rule.status is RuleStatus.PASS and generate_success_events:
            out.append(EventInfo(
                kind=pr.resource.kind, name=pr.resource.name,
                namespace=pr.resource.namespace, reason=POLICY_APPLIED,
                message=f"policy {pr.policy.name}/{rule.name} applied",
            ))
    return out
