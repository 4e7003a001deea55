"""Generate controller: consume GenerateRequest documents, materialize
dependent resources, keep them in sync.

Mirrors kyverno/pkg/generate (generate_controller.go workqueue,
processGR generate.go:32, applyGenerate :114, status updates status.go) and
the cleanup controller's stale-GR GC (pkg/generate/cleanup).
"""

from __future__ import annotations

import time

from .client import ConflictError
from .workqueue import WorkerQueue

from ..engine.context import Context
from ..engine.generation import (
    MODE_CREATE,
    MODE_SKIP,
    MODE_UPDATE,
    GenerateError,
    apply_generate_rule,
)
from ..engine.match import matches_resource_description
from ..engine.policy_context import PolicyContext

GR_PENDING = "Pending"
GR_COMPLETED = "Completed"
GR_FAILED = "Failed"


class GenerateController:
    """generate_controller.go:76 NewController (workqueue, default 10
    workers at cmd/kyverno/main.go:80)."""

    def __init__(self, client, policies_by_name: dict, workers: int = 10):
        self.client = client
        self.policies = policies_by_name
        self._wq = WorkerQueue(self._handle, workers, name="generate")

    @property
    def queue(self):
        return self._wq.queue

    @property
    def processed(self) -> int:
        return self._wq.processed

    def _handle(self, gr: dict) -> None:
        try:
            self.process_gr(gr)
        except Exception as e:
            self._update_status(gr, GR_FAILED, str(e))

    # ------------------------------------------------------------ intake

    def enqueue(self, gr: dict) -> None:
        self._wq.add(gr)

    def sync_from_cluster(self) -> int:
        """Pick up pending GenerateRequests from the store."""
        n = 0
        for gr in self.client.list_resource("kyverno.io/v1", "GenerateRequest"):
            if ((gr.get("status") or {}).get("state")) == GR_PENDING:
                self.enqueue(gr)
                n += 1
        return n

    def watch_cluster(self) -> bool:
        """Event-driven intake: pending GenerateRequests enqueue straight
        off the watch stream (generaterequest informer in the reference's
        main.go wiring) — after the initial sync the controller never
        polls. Returns False when the client offers no watch transport."""
        def on_event(ev_type: str, gr: dict) -> None:
            if gr.get("kind") != "GenerateRequest":
                return
            if ev_type in ("ADDED", "MODIFIED") and (
                    (gr.get("status") or {}).get("state")) == GR_PENDING:
                self.enqueue(gr)

        def on_sync(items: list[dict]) -> None:
            # initial list and 410-triggered re-lists: GRs created before
            # the watch anchored arrive here, not as events
            for gr in items:
                if ((gr.get("status") or {}).get("state")) == GR_PENDING:
                    self.enqueue(gr)

        if hasattr(self.client, "ensure_informer"):
            self.client.ensure_informer("kyverno.io/v1", "GenerateRequest",
                                        on_event=on_event, on_sync=on_sync)
            return True
        if hasattr(self.client, "watch"):
            self.client.watch(on_event)
            return True
        return False

    # ------------------------------------------------------------ workers

    def run(self) -> None:
        self._wq.run()

    def stop(self) -> None:
        self._wq.stop()

    def drain(self, timeout: float = 5.0) -> None:
        self._wq.drain(timeout)

    # ------------------------------------------------------------ sync

    def process_gr(self, gr: dict) -> None:
        """generate.go:32 processGR -> applyGenerate."""
        spec = gr.get("spec") or {}
        policy = self.policies.get(spec.get("policy", ""))
        if policy is None:
            self._update_status(gr, GR_FAILED, "policy not found")
            return

        trigger_ref = spec.get("resource") or {}
        trigger = self.client.get_resource(
            trigger_ref.get("apiVersion", ""), trigger_ref.get("kind", ""),
            trigger_ref.get("namespace", ""), trigger_ref.get("name", ""),
        )
        if trigger is None:
            self._update_status(gr, GR_FAILED, "trigger resource not found")
            return

        jctx = Context()
        jctx.add_resource(trigger)
        user_info = ((spec.get("context") or {}).get("userInfo")) or {}
        if user_info:
            jctx.add_json({"request": {"userInfo": user_info}})
        pctx = PolicyContext(
            policy=policy, new_resource=trigger, client=self.client,
            json_context=jctx,
        )

        generated = []
        for rule in policy.spec.rules:
            if not rule.has_generate():
                continue
            ok, _ = matches_resource_description(
                trigger, rule, policy_namespace=policy.namespace)
            if not ok:
                continue
            try:
                resource, mode = apply_generate_rule(rule, pctx, trigger, self.client)
            except GenerateError as e:
                self._update_status(gr, GR_FAILED, str(e))
                return
            if mode == MODE_SKIP or resource is None:
                continue
            if mode == MODE_CREATE:
                try:
                    self.client.create_resource(resource)
                except ConflictError:
                    # AlreadyExists: another worker created it first — the
                    # reference falls through to update (generate.go applyRule)
                    self.client.update_resource(resource)
            elif mode == MODE_UPDATE:
                self.client.update_resource(resource)
            meta = resource.get("metadata") or {}
            generated.append({
                "kind": resource.get("kind", ""),
                "namespace": meta.get("namespace", ""),
                "name": meta.get("name", ""),
            })

        self._update_status(gr, GR_COMPLETED, "", generated)

    def synchronize(self) -> int:
        """generate_controller.go:221: re-run completed GRs whose rules have
        synchronize=true so downstream resources track their sources."""
        n = 0
        for gr in self.client.list_resource("kyverno.io/v1", "GenerateRequest"):
            if ((gr.get("status") or {}).get("state")) != GR_COMPLETED:
                continue
            policy = self.policies.get(((gr.get("spec") or {}).get("policy")) or "")
            if policy is None:
                continue
            if any(
                r.has_generate() and r.generation.synchronize
                for r in policy.spec.rules
            ):
                self.enqueue(gr)
                n += 1
        return n

    def cleanup_stale(self, max_age_s: float = 3600.0) -> int:
        """pkg/generate/cleanup: GC GenerateRequests stuck Failed longer
        than max_age_s (fresh failures keep their retry window)."""
        now = time.time()
        n = 0
        for gr in self.client.list_resource("kyverno.io/v1", "GenerateRequest"):
            status = gr.get("status") or {}
            if status.get("state") != GR_FAILED:
                continue
            failed_at = status.get("failedAt", 0)
            if now - failed_at < max_age_s:
                continue
            meta = gr.get("metadata") or {}
            self.client.delete_resource(
                "kyverno.io/v1", "GenerateRequest",
                meta.get("namespace", ""), meta.get("name", ""))
            n += 1
        return n

    def _update_status(self, gr: dict, state: str, message: str = "",
                       generated: list | None = None) -> None:
        """status.go: state transitions recorded on the GR document."""
        gr = dict(gr)
        gr["status"] = {"state": state}
        if state == GR_FAILED:
            gr["status"]["failedAt"] = time.time()
        if message:
            gr["status"]["message"] = message
        if generated:
            gr["status"]["generatedResources"] = generated
        self.client.update_resource(gr)
