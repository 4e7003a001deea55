"""Admission webhook server.

Mirrors kyverno/pkg/webhooks/server.go: an HTTPS server with POST
routes /mutate, /validate, /policymutate, /policyvalidate plus liveness/
readiness, a generic handler that parses the AdmissionReview, filters via
dynamic config, dispatches, and marshals the response (server.go:244-276).
Enforce validation failures block admission; audit runs async through the
AuditHandler queue (validate_audit.go); matching generate policies produce
GenerateRequest documents for the async controller.

With an ``AdmissionBatcher``, ``/validate`` and the audit queue screen each
resource on the card first (K6: K1 -> ``eval_rules`` over the policy
cache's compiled set, then the host lane for HOST cells) and run the CPU
oracle only for what the screen leaves open. ``/mutate`` and the policy
paths are host work. The server's policy cache is on ``cuda`` unless the
caller passes ``device="cpu"`` (or a cache of its own).
"""

from __future__ import annotations

import base64
import copy
import json
import ssl
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..engine.context import Context, mutate_resource_with_image_info
from ..engine.generation import generate as engine_generate
from ..engine.image_verify import verify_and_patch_images
from ..engine.mutation import mutate as engine_mutate
from ..engine.policy_context import PolicyContext
from ..engine.response import RuleStatus
from ..engine.validation import validate as engine_validate
from ..policy.autogen import apply_defaults, generate_pod_controller_rules
from ..policy.openapi import validate_policy_mutation
from ..policy.validation import validate_policy
from ..api.load import load_policy
from . import batch as batch_mod
from . import metrics as metrics_mod
from . import obs_http
from . import tracing
from .config import ConfigData
from .resourcecache import ResourceCache
from .events import EventGenerator, events_for_engine_response
from .policycache import PolicyCache, PolicyType
from .reports import ReportGenerator
from .userinfo import build_request_info
from .workqueue import WorkerQueue

# config.go:81-94 service paths
MUTATING_WEBHOOK_PATH = "/mutate"
VALIDATING_WEBHOOK_PATH = "/validate"
POLICY_MUTATING_WEBHOOK_PATH = "/policymutate"
POLICY_VALIDATING_WEBHOOK_PATH = "/policyvalidate"
VERIFY_MUTATING_WEBHOOK_PATH = "/verifymutate"
LIVENESS_PATH = "/health/liveness"
READINESS_PATH = "/health/readiness"


def _admission_response(uid: str, allowed: bool, message: str = "",
                        patches: list | None = None) -> dict:
    resp: dict = {"uid": uid, "allowed": allowed}
    if message:
        resp["status"] = {"message": message}
    if patches:
        resp["patchType"] = "JSONPatch"
        resp["patch"] = base64.b64encode(json.dumps(patches).encode()).decode()
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": resp,
    }


class AuditHandler(WorkerQueue):
    """validate_audit.go:44 AuditHandler: a rate-limited queue re-running
    audit validation off the hot path (10 workers, max 3 retries)."""

    def __init__(self, handler, workers: int = 10, shed_cb=None):
        super().__init__(handler, workers, name="audit", max_retries=3,
                         shed_cb=shed_cb)


class WebhookServer:
    """server.go:135 NewWebhookServer (minus the cluster wiring).
    ``device`` places the policy cache the server builds when it is given
    none (``cuda`` by default: with no card it raises unless the caller
    asks for ``"cpu"``)."""

    def __init__(self, policy_cache: PolicyCache | None = None,
                 config: ConfigData | None = None, client=None,
                 event_gen: EventGenerator | None = None,
                 report_gen: ReportGenerator | None = None,
                 registry=None, image_verifier=None,
                 admission_batcher=None, device=None):
        from ..engine.image_verify import Verifier
        from ..models.engine import resolve_device

        if policy_cache is None:
            policy_cache = PolicyCache(device=resolve_device(device))
        self.policy_cache = policy_cache
        self.admission_batcher = admission_batcher
        self.config = config or ConfigData()
        self.client = client
        self.event_gen = event_gen
        self.report_gen = report_gen
        self.image_verifier = image_verifier or Verifier()
        from .oracle_pool import OraclePool

        # multicore oracle lane; dormant below OraclePool.MIN_CORES
        self.oracle_pool = OraclePool()
        # host-lane fan-out (runtime/hostlane): eligible flush/resolve
        # batches may route through the pool workers, generation-guarded
        # by this policy cache
        from .hostlane import resolver as _hostlane_resolver

        _hostlane_resolver().attach_pool(self.oracle_pool,
                                         self.policy_cache)
        self.resource_cache = (ResourceCache(client)
                               if client is not None else None)
        self.registry = registry or metrics_mod.registry()
        # SLO degradation controller (runtime/sloactions.py): policy
        # source for the shed action; the audit queue sheds (reason
        # "slo") while the shed action is engaged — deliberate audit
        # backlog drop is exactly what degraded mode buys
        from . import sloactions

        sloactions.controller().attach(self.policy_cache)
        self.audit_handler = AuditHandler(
            self._process_audit,
            shed_cb=lambda: sloactions.controller().action_active("shed"))
        self.last_request_time = time.time()
        # decision cache: keyed/TTL'd by the admission batcher's rules
        # (policy generation + resource + requester digest)
        self._decision_cache: dict = {}
        self._decision_lock = threading.Lock()
        # TTL dedup of identical audit work (ResourceManager analogue,
        # pkg/policy/existing.go:125): key -> (expiry, metric rows)
        self._audit_memo: dict = {}
        self._httpd: ThreadingHTTPServer | None = None

    # ------------------------------------------------------------ dispatch

    def handle(self, path: str, review: dict) -> dict:
        """server.go:244 handlerFunc: the generic wrapper. Owns the
        admission trace unless the transport (do_POST) already started
        one on this thread — direct in-process callers get a full trace
        either way."""
        rec = tracing.recorder()
        own = None
        if tracing.current() is None:
            own = rec.start("admission", path=path)
        tok = tracing.bind(own) if own is not None else None
        try:
            if self.admission_batcher is not None:
                # the in-flight count is the batcher's concurrency signal
                # for oracle-vs-device routing (runtime/batch.py)
                with self.admission_batcher.admission_in_flight():
                    out = self._handle(path, review)
            else:
                out = self._handle(path, review)
            if own is not None:
                own.labels["allowed"] = str(out["response"]["allowed"])
            return out
        finally:
            if tok is not None:
                tracing.unbind(tok)
            rec.finish(own)

    def _handle(self, path: str, review: dict) -> dict:
        start = time.monotonic()
        self.last_request_time = time.time()
        request = review.get("request") or {}
        uid = request.get("uid", "")
        kind = ((request.get("kind") or {}).get("kind")) or ""
        namespace = request.get("namespace", "")
        name = ((request.get("object") or {}).get("metadata") or {}).get("name", "")
        operation = request.get("operation", "CREATE")
        trace = tracing.current()
        if trace is not None:
            trace.labels.update(kind=kind, namespace=namespace,
                                operation=operation, uid=uid)

        # dynamic config resource filters (server.go:252)
        if path in (MUTATING_WEBHOOK_PATH, VALIDATING_WEBHOOK_PATH):
            if self.config.to_filter(kind, namespace, name):
                return _admission_response(uid, True)
            username = ((request.get("userInfo") or {}).get("username")) or ""
            if username and username in self.config.get_exclude_username():
                return _admission_response(uid, True)

        if path == MUTATING_WEBHOOK_PATH:
            out = self._resource_mutation(request)
        elif path == VALIDATING_WEBHOOK_PATH:
            out = self._resource_validation(request)
        elif path == POLICY_MUTATING_WEBHOOK_PATH:
            out = self._policy_mutation(request)
        elif path == POLICY_VALIDATING_WEBHOOK_PATH:
            out = self._policy_validation(request)
        elif path == VERIFY_MUTATING_WEBHOOK_PATH:
            out = _admission_response(uid, True)  # monitor no-op probe
        else:
            return _admission_response(uid, False, f"unknown path {path}")

        elapsed = time.monotonic() - start
        metrics_mod.record_admission_review_duration(
            self.registry, operation, kind, elapsed)
        metrics_mod.record_admission_request(
            self.registry, operation, kind, out["response"]["allowed"])
        # SLO watchdog feed: one sample per finished review (lock-free
        # append; pure observation — KTPU_SLO=0 makes it a no-op). The
        # degradation controller tick rides the same hook, rate-limited.
        try:
            from . import sloactions
            from .slo import watchdog

            watchdog().observe(elapsed)
            sloactions.controller().maybe_tick()
        except Exception:
            pass
        return out

    # ------------------------------------------------------------ contexts

    def _policy_context(self, request: dict, resource: dict) -> PolicyContext:
        """server.go:343 buildPolicyContext + :638 newVariablesContext —
        built ONCE per admission request and shared across the per-policy
        loop (the engine checkpoints/restores the JSON context itself)."""
        ctx = Context()
        ctx.add_request(request)
        if resource:
            ctx.add_resource(resource)
        if request.get("oldObject"):
            ctx.add_old_resource(request["oldObject"])
        user_info = request.get("userInfo") or {}
        admission_info = build_request_info(self.client, user_info)
        ctx.add_user_info({
            "roles": admission_info.roles,
            "clusterRoles": admission_info.cluster_roles,
            "userInfo": user_info,
        })
        username = user_info.get("username", "")
        if username:
            ctx.add_service_account(username)
        try:
            ctx.add_image_info(resource)
        except Exception:
            pass
        namespace_labels = {}
        namespace = request.get("namespace", "")
        if namespace:
            # cached lister, not a synchronous GET per admission
            # (server.go:521 GetNamespaceSelectorsFromNamespaceLister)
            if self.resource_cache is not None:
                namespace_labels = self.resource_cache.get_namespace_labels(
                    namespace)
            elif self.client is not None:
                ns_obj = self.client.get_resource(
                    "v1", "Namespace", "", namespace)
                if ns_obj:
                    namespace_labels = (
                        ns_obj.get("metadata") or {}).get("labels") or {}
        return PolicyContext(
            new_resource=resource,
            old_resource=request.get("oldObject") or {},
            admission_info=admission_info,
            exclude_group_role=self.config.get_exclude_group_role(),
            client=self.client,
            resource_cache=self.resource_cache,
            json_context=ctx,
            namespace_labels=namespace_labels,
        )

    # ------------------------------------------------------------ handlers

    def _resource_mutation(self, request: dict) -> dict:
        """server.go:292 resourceMutation."""
        uid = request.get("uid", "")
        kind = ((request.get("kind") or {}).get("kind")) or ""
        namespace = request.get("namespace", "")
        resource = copy.deepcopy(request.get("object") or {})
        policies = self.policy_cache.get_policies(PolicyType.MUTATE, kind, namespace)

        patches: list = []
        # canonicalize image references (server.go:318)
        ctx_probe = Context()
        try:
            patched0, image_patches = mutate_resource_with_image_info(resource, ctx_probe)
            if image_patches:
                resource = patched0
                patches.extend(image_patches)
        except Exception:
            pass

        engine_responses = []
        pctx = self._policy_context(request, resource)
        for policy in policies:
            pctx.policy = policy
            pctx.new_resource = resource
            resp = engine_mutate(pctx)
            engine_responses.append(resp)
            if resp.patched_resource is not None:
                resource = resp.patched_resource
            patches.extend(resp.patches)
            for rule in resp.policy_response.rules:
                metrics_mod.record_policy_results(
                    self.registry, policy.name, rule.name, rule.status.value,
                    resource_kind=kind,
                    request_operation=request.get("operation", "CREATE"))

        # image verification after mutate policies (server.go:325
        # applyImageVerifyPolicies): every policy is applied and recorded,
        # THEN an enforce-mode failure blocks (verify_images.go:36-48
        # handleVerifyImages + common.go:30 toBlockResource)
        verify_policies = self.policy_cache.get_policies(
            PolicyType.VERIFY_IMAGES, kind, namespace)
        blocked_msgs: list[str] = []
        if verify_policies:
            # reuse the request's policy context (server.go:343 builds one
            # per request); refresh image info on the mutated resource
            pctx.new_resource = resource
            try:
                pctx.json_context.add_image_info(resource)
            except Exception:
                pass
            for policy in verify_policies:
                pctx.policy = policy
                resp = verify_and_patch_images(pctx, self.image_verifier)
                engine_responses.append(resp)
                patches.extend(resp.patches)
                for rule in resp.policy_response.rules:
                    metrics_mod.record_policy_results(
                        self.registry, policy.name, rule.name,
                        rule.status.value, resource_kind=kind,
                        request_operation=request.get("operation", "CREATE"))
                # verifyImages outcomes reach the report pipeline like
                # validation results (reportcontroller consumes every
                # engine response kind in the reference)
                if self.report_gen is not None and resp.policy_response.rules:
                    self.report_gen.add(resp)
                if (not resp.successful
                        and policy.spec.validation_failure_action == "enforce"):
                    blocked_msgs += [r.message
                                     for r in resp.policy_response.rules
                                     if not r.success]
        if blocked_msgs:
            if self.event_gen is not None:
                for r in engine_responses:
                    self.event_gen.add(*events_for_engine_response(
                        r, self.config.generate_success_events()))
            return _admission_response(
                uid, False,
                message=f"image verification failed: {'; '.join(blocked_msgs)}")

        if self.event_gen is not None:
            for resp in engine_responses:
                self.event_gen.add(*events_for_engine_response(
                    resp, self.config.generate_success_events()))
        return _admission_response(uid, True, patches=patches)

    def _record_screen_results(self, row, resource: dict, kind: str,
                               request: dict, mode: str = "enforce") -> list:
        """Metrics + report rows for a device-screened admission, matching
        what the oracle loop records for passing resources."""
        from ..engine.response import (
            EngineResponse,
            PolicyResponse,
            PolicySpecSummary,
            ResourceSpec,
            RuleResponse,
            RuleType,
        )

        meta = resource.get("metadata") or {}
        recorded: list[tuple] = []
        per_policy: dict[str, EngineResponse] = {}
        for policy_name, rule_name, verdict, row_msg in row:
            status = batch_mod.verdict_to_status(verdict)
            if status is None:
                continue
            # flush-resolved host cells carry the oracle's own text; a
            # device PASS is the oracle's pattern-pass outcome — carry the
            # same message either way so screened and oracle report rows
            # agree
            message = row_msg or (f"validation rule '{rule_name}' passed."
                                  if status is RuleStatus.PASS else "")
            recorded.append((policy_name, rule_name, status.value, message))
            metrics_mod.record_policy_results(
                self.registry, policy_name, rule_name, status.value,
                validation_mode=mode, resource_kind=kind,
                request_operation=request.get("operation", "CREATE"))
            if self.report_gen is None and self.event_gen is None:
                continue
            resp = per_policy.get(policy_name)
            if resp is None:
                resp = per_policy[policy_name] = EngineResponse(
                    policy_response=PolicyResponse(
                        policy=PolicySpecSummary(name=policy_name),
                        resource=ResourceSpec(
                            kind=resource.get("kind", ""),
                            api_version=resource.get("apiVersion", ""),
                            namespace=meta.get("namespace", ""),
                            name=meta.get("name", ""))))
            resp.policy_response.rules.append(RuleResponse(
                name=rule_name, type=RuleType.VALIDATION, status=status,
                message=message))
        for resp in per_policy.values():
            if self.report_gen is not None:
                self.report_gen.add(resp)
            # device-recorded failures emit the same violation events the
            # oracle loop would (policy_violation events in the reference)
            if self.event_gen is not None and not resp.successful:
                self.event_gen.add(*events_for_engine_response(resp))
        return recorded

    def _reemit_report_rows(self, rows: list, resource: dict,
                            request: dict) -> None:
        """Replay cached decision rows into the report pipeline: a
        decision-cache (or audit-memo) hit skips the engines, but a
        reconcile() full rebuild during the hit window clears the result
        store — without re-emission those rows vanish until the TTL
        lapses. Same-key merge in the store is last-write-wins, so the
        replay is idempotent. ``rows`` are ``(policy, rule, status_value,
        message)`` as cached by _decision_store."""
        if self.report_gen is None or not rows:
            return
        from ..engine.response import (
            EngineResponse,
            PolicyResponse,
            PolicySpecSummary,
            ResourceSpec,
            RuleResponse,
            RuleType,
        )

        ident = resource or request.get("oldObject") or {}
        meta = ident.get("metadata") or {}
        per_policy: dict[str, EngineResponse] = {}
        for pn, rn, sv, msg in rows:
            try:
                status = RuleStatus(sv)
            except ValueError:
                continue
            resp = per_policy.get(pn)
            if resp is None:
                resp = per_policy[pn] = EngineResponse(
                    policy_response=PolicyResponse(
                        policy=PolicySpecSummary(name=pn),
                        resource=ResourceSpec(
                            kind=ident.get("kind", ""),
                            api_version=ident.get("apiVersion", ""),
                            namespace=meta.get("namespace", ""),
                            name=meta.get("name", ""))))
            resp.policy_response.rules.append(RuleResponse(
                name=rn, type=RuleType.VALIDATION, status=status,
                message=msg))
        for resp in per_policy.values():
            self.report_gen.add(resp)

    def _admission_ctx_payload(self, request: dict, namespace: str) -> dict:
        """Context payload a flush needs to resolve this admission's HOST
        cells request-faithfully (models/engine.resolve_host_cells) —
        the same parent-side data gathering the oracle pool does. Built
        lazily: the batcher only invokes the callback when the flush
        actually has eligible HOST cells for this row."""
        namespace_labels = {}
        if namespace and self.resource_cache is not None:
            try:
                namespace_labels = self.resource_cache.get_namespace_labels(
                    namespace)
            except Exception:
                namespace_labels = {}
        roles: list = []
        cluster_roles: list = []
        try:
            info = build_request_info(self.client,
                                      request.get("userInfo") or {})
            roles, cluster_roles = info.roles, info.cluster_roles
        except Exception:
            pass
        payload = {"request": request,
                   "namespace_labels": namespace_labels,
                   "roles": roles, "cluster_roles": cluster_roles,
                   "exclude_group_role":
                       self.config.get_exclude_group_role()}
        # trace context rides the payload into the host lane / oracle
        # pool so pool-resolved spans attribute back to this admission's
        # id (workers ignore the key; evaluate_payload unpacks by name)
        tp = tracing.make_traceparent(tracing.current())
        if tp:
            payload["traceparent"] = tp
        return payload

    def _subst_context(self, request: dict, resource: dict):
        """Admission-scoped substitution context for deny-message
        variables: request.* and the resource resolve; anything needing
        cluster state (roles, ns labels, external context) stays
        unresolved and routes the policy to the oracle."""
        from ..engine.context import Context

        ctx = Context()
        try:
            if request:
                ctx.add_request(request)
            if resource:
                ctx.add_resource(resource)
            username = ((request or {}).get("userInfo") or {}).get(
                "username", "")
            if username:
                ctx.add_service_account(username)
            try:
                ctx.add_image_info(resource)
            except Exception:
                pass
        except Exception:
            pass
        return ctx

    def _device_deny_messages(self, policy, rule_verdicts,
                              request: dict | None = None,
                              resource: dict | None = None):
        """Deny messages for a policy every one of whose flagged screen
        cells is a FAIL the device row can answer — a flush-resolved host
        cell carrying the oracle's own message, a rule with a *static*
        validation message, or a variable message whose every variable
        substitutes from the admission context (request.* / resource) —
        or None when any cell still needs the oracle (HOST/ERROR
        verdicts, ``$(..)`` references, variables needing cluster
        state). The device lattice already admits on all-PASS rows, so
        its FAIL on a device-compiled rule carries the same authority;
        the oracle would add only the failing path to the message
        text."""
        from ..engine.variables import substitute_all
        from ..models import Verdict

        if policy is None:
            return None
        rules = {r.name: r for r in policy.spec.rules}
        msgs = []
        subst_ctx = None
        for rname, v, resolved_msg in rule_verdicts:
            if v in (Verdict.PASS, Verdict.SKIP):
                continue
            if v is not Verdict.FAIL:
                return None
            if resolved_msg:
                # flush-resolved host cell: the oracle already produced
                # the faithful failure text for this admission
                msgs.append(f"policy {policy.name}/{rname}: {resolved_msg}")
                continue
            rule = rules.get(rname)
            if rule is None:
                return None
            msg = rule.validation.message or ""
            if "$(" in msg:
                return None
            if "{{" in msg:
                if subst_ctx is None:
                    subst_ctx = self._subst_context(request or {},
                                                    resource or {})
                try:
                    msg = substitute_all(subst_ctx, msg)
                except Exception:
                    return None
                if not isinstance(msg, str) or "{{" in msg:
                    return None
            if msg:
                text = f"validation error: {msg} Rule {rname} failed"
            else:
                text = f"validation error: rule {rname} failed"
            msgs.append(f"policy {policy.name}/{rname}: {text}")
        return msgs or None

    def _resource_validation(self, request: dict) -> dict:
        """server.go:476 resourceValidation: enforce inline, audit async,
        then trigger generate policies."""
        uid = request.get("uid", "")
        kind = ((request.get("kind") or {}).get("kind")) or ""
        namespace = request.get("namespace", "")
        resource = request.get("object") or {}

        enforce = self.policy_cache.get_policies(
            PolicyType.VALIDATE_ENFORCE, kind, namespace)
        # SLO shed action (runtime/sloactions.py): policies in the
        # explicit, reported shed set drop out of the deny path for the
        # duration of the degraded episode. Decision caching is
        # suspended whenever the set is non-empty so a degraded-era
        # verdict can never leak into the healthy steady state.
        shed_names: frozenset = frozenset()
        try:
            from . import sloactions

            shed_names = sloactions.controller().shed_active_names()
        except Exception:
            shed_names = frozenset()
        if shed_names:
            kept = [p for p in enforce if p.name not in shed_names]
            if len(kept) != len(enforce):
                enforce = kept
                self.registry.inc_counter(
                    "kyverno_slo_shed_decisions_total", {})
        blocked_msgs: list[str] = []
        metric_rows: list[tuple] = []

        # request-identity fields the cache key must cover: outcomes can
        # depend on who asks and how, not just the resource body
        screen_env = {"operation": request.get("operation"),
                      "userInfo": request.get("userInfo"),
                      "oldObject": request.get("oldObject")}

        # decision cache: a repeat of an identical admission (same policy
        # generation, resource bytes, requester identity) within the TTL
        # replays the decision + metrics without touching either engine
        # lane. Report rows are RE-EMITTED (idempotent per (policy, rule,
        # resource) key) so a reconcile() full rebuild during the hit
        # window cannot drop them; events are not — an identical
        # (resource, outcomes) pair adds no new event. The semantically
        # required side effects (audit queue, generate policies) still
        # run below. Cluster-state context staleness is bounded by the
        # TTL, the same window an informer lookup has.
        decision_key = None
        if enforce and not shed_names and self.admission_batcher is not None:
            decision_key = self.admission_batcher.decision_key(
                PolicyType.VALIDATE_ENFORCE, kind, namespace, resource,
                env=screen_env)
            hit = (self._decision_cache.get(decision_key)
                   if decision_key is not None else None)
            if hit is not None and hit[0] > time.monotonic():
                _, allowed, message, rows = hit
                now_pc = time.perf_counter()
                tracing.recorder().add_span(
                    tracing.current(), "screen", now_pc, now_pc,
                    lane="decision_cache")
                for pn, rn, sv, _msg in rows:
                    metrics_mod.record_policy_results(
                        self.registry, pn, rn, sv,
                        validation_mode="enforce", resource_kind=kind,
                        request_operation=request.get("operation", "CREATE"))
                self._reemit_report_rows(rows, resource, request)
                self.admission_batcher.stats["decision_cache"] = (
                    self.admission_batcher.stats.get("decision_cache", 0) + 1)
                if not allowed:
                    return _admission_response(uid, False, message)
                if self.policy_cache.get_policies(
                        PolicyType.VALIDATE_AUDIT, kind, namespace):
                    self.audit_handler.add(request)
                self._apply_generate_policies(request)
                return _admission_response(uid, True)

        # device screen (runtime/batch.py): micro-batched evaluation on
        # the card; an all-green row admits without touching the CPU
        # engine, anything else drops to the oracle loop below for
        # faithful messages. The ctx_cb hands the flush this admission's
        # context so pool-safe HOST cells resolve inside the flush's one
        # batched oracle pass
        screened_clean = False
        screen_row: list = []
        if enforce and self.admission_batcher is not None:
            status, row = self.admission_batcher.screen(
                PolicyType.VALIDATE_ENFORCE, kind, namespace, resource,
                env=screen_env,
                ctx_cb=lambda: self._admission_ctx_payload(request,
                                                           namespace))
            if status == batch_mod.CLEAN:
                screened_clean = True
                metric_rows += self._record_screen_results(
                    row, resource, kind, request)
                self.admission_batcher.note_screen_savings(1.0)
                # per-REQUEST counter (device_deny counts per-policy
                # messages): this admission was decided without the
                # inline oracle
                self.admission_batcher.stats["device_decided"] = (
                    self.admission_batcher.stats.get("device_decided", 0) + 1)
            elif status == batch_mod.ATTENTION and row:
                # the device row still covers shed policies (the
                # compiled tensors don't re-splice per episode) — drop
                # their cells so the hybrid merge below never denies or
                # oracles a shed policy
                screen_row = ([t for t in row if t[0] not in shed_names]
                              if shed_names else row)

        if enforce and not screened_clean:
            # rule-level hybrid merge: policies the device already cleared
            # are recorded from the screen row; a policy whose flagged
            # cells are all device FAILs with *static* messages is denied
            # straight from the verdicts (the lattice is the same
            # authority that admits CLEAN rows — the oracle would add
            # only the failing path to the message); only HOST/ERROR
            # cells and variable messages pay the CPU oracle
            run_policies = enforce
            if screen_row:
                from ..models import Verdict

                bad = {p for p, _, v, _ in screen_row
                       if v not in (Verdict.PASS, Verdict.SKIP)}
                by_name = {p.name: p for p in enforce}
                direct: set = set()
                for pname in bad:
                    msgs = self._device_deny_messages(
                        by_name.get(pname),
                        [(r, v, m) for p, r, v, m in screen_row
                         if p == pname],
                        request=request, resource=resource)
                    if msgs is None:
                        continue            # needs the oracle
                    direct.add(pname)
                    blocked_msgs += msgs
                if direct:
                    self.admission_batcher.stats["device_deny"] = (
                        self.admission_batcher.stats.get("device_deny", 0)
                        + len(direct))
                metric_rows += self._record_screen_results(
                    [t for t in screen_row if t[0] not in bad - direct],
                    resource, kind, request)
                run_policies = [p for p in enforce if p.name in bad - direct]
                if not run_policies:
                    # every flagged policy was answered from the device
                    # row — a fully device-decided deny
                    self.admission_batcher.stats["device_decided"] = (
                        self.admission_batcher.stats.get("device_decided", 0)
                        + 1)
            oracle_t0 = time.monotonic()
            o0 = time.perf_counter()
            # multicore lane: cluster-independent policies can evaluate in
            # a worker process (runtime/oracle_pool.py) — the GIL
            # serializes the inline loop, so on a multicore host a burst
            # of admissions scales with cores the way the reference's
            # goroutines do. Any miss falls through to the inline loop.
            responses = self._pool_oracle(run_policies, resource, request,
                                          namespace)
            oracle_lane = "pool" if responses is not None else "inline"
            if responses is None:
                responses = []
                pctx = self._policy_context(request, resource)
                for policy in run_policies:
                    pctx.policy = policy
                    responses.append(engine_validate(pctx))
            tracing.recorder().add_span(
                tracing.current(), "oracle", o0, time.perf_counter(),
                lane=oracle_lane, policies=len(run_policies),
                hybrid="1" if screen_row else "0")
            for policy, resp in zip(run_policies, responses):
                for rule in resp.policy_response.rules:
                    metric_rows.append(
                        (policy.name, rule.name, rule.status.value,
                         rule.message))
                    metrics_mod.record_policy_results(
                        self.registry, policy.name, rule.name,
                        rule.status.value,
                        validation_mode="enforce", resource_kind=kind,
                        request_operation=request.get("operation", "CREATE"))
                    if rule.status in (RuleStatus.FAIL, RuleStatus.ERROR):
                        blocked_msgs.append(
                            f"policy {policy.name}/{rule.name}: {rule.message}")
                if self.event_gen is not None:
                    self.event_gen.add(*events_for_engine_response(resp))
                if self.report_gen is not None:
                    self.report_gen.add(resp)
            if self.admission_batcher is not None and run_policies:
                # feed the router's cost model with the measured CPU price
                # of this admission: full runs calibrate the per-policy
                # EMA, hybrid runs calibrate the screen's time savings
                dt = time.monotonic() - oracle_t0
                if screen_row:
                    self.admission_batcher.note_hybrid_cost(dt, len(enforce))
                else:
                    self.admission_batcher.note_oracle_cost(
                        dt, len(run_policies))
            if self.admission_batcher is not None:
                # the decision is the same pure function of (policy set,
                # resource) either lane computes — cache the merged verdict
                # row so a repeat admission (deployment scale-up, retries)
                # is served at cache speed regardless of which lane ran
                from ..models import Verdict as _V

                status_to_v = {RuleStatus.PASS: _V.PASS,
                               RuleStatus.SKIP: _V.SKIP,
                               RuleStatus.FAIL: _V.FAIL,
                               RuleStatus.ERROR: _V.ERROR}
                oracle_names = {p.name for p in run_policies}
                full_row = [t for t in screen_row
                            if t[0] not in oracle_names]
                cacheable = True
                for policy, resp in zip(run_policies, responses):
                    for rule in resp.policy_response.rules:
                        v = status_to_v.get(rule.status)
                        if v is None:          # WARN etc.: don't cache
                            cacheable = False
                            break
                        full_row.append((policy.name, rule.name, v,
                                         rule.message))
                if cacheable and not shed_names:
                    self.admission_batcher.store_result(
                        PolicyType.VALIDATE_ENFORCE, kind, namespace,
                        resource, full_row, env=screen_env)

        # a blocked request is returned BEFORE audit/generate side effects
        # (server.go:553-563)
        if blocked_msgs:
            message = ("resource blocked due to policy violations:\n"
                       + "\n".join(blocked_msgs))
            self._decision_store(decision_key, False, message, metric_rows)
            return _admission_response(uid, False, message)

        self._decision_store(decision_key, True, "", metric_rows)

        # async audit (server.go:559)
        if self.policy_cache.get_policies(PolicyType.VALIDATE_AUDIT, kind, namespace):
            self.audit_handler.add(request)

        # generate policies -> GenerateRequest documents (server.go:562)
        self._apply_generate_policies(request)
        return _admission_response(uid, True)

    def _decision_store(self, decision_key, allowed: bool, message: str,
                        metric_rows: list) -> None:
        if decision_key is None or self.admission_batcher is None:
            return
        # WARN (audit-mode downgrades) and other exotic statuses carry
        # per-request semantics — don't cache those decisions
        if any(t[2] not in ("pass", "fail", "skip", "error")
               for t in metric_rows):
            return
        ttl = self.admission_batcher.result_cache_ttl_s
        if ttl <= 0:
            return
        with self._decision_lock:
            batch_mod.ttl_store(self._decision_cache, decision_key, ttl,
                                (allowed, message, metric_rows))

    def _pool_oracle(self, policies, resource: dict, request: dict,
                     namespace: str):
        """Try the multiprocess oracle lane for this admission's enforce
        loop. Returns EngineResponses aligned with ``policies`` or None
        (caller runs inline). Only engages when the pool is warm for the
        current policy generation and every policy is cluster-independent
        (runtime/oracle_pool.py pool_safe)."""
        pool = self.oracle_pool
        if pool is None or not pool.enabled or len(policies) < 2:
            return None
        from .oracle_pool import pool_safe

        if not all(pool_safe(p) for p in policies):
            return None
        # warm-pool fast path: don't snapshot the whole policy list per
        # admission just for ensure() to discard it after an int compare
        generation = self.policy_cache.generation
        if not pool.ready(generation):
            # kicks a background build from an ATOMIC (generation,
            # policies) pair — the pool must never hold one generation's
            # number with another generation's content
            pool.ensure(*self.policy_cache.snapshot())
            return None
        user_info = request.get("userInfo") or {}
        info = build_request_info(self.client, user_info)
        namespace_labels = {}
        if namespace and self.resource_cache is not None:
            namespace_labels = self.resource_cache.get_namespace_labels(
                namespace)
        # guarded submission (runtime/sloactions.py): shrunk timeout +
        # bounded retry + circuit breaking while the SLO actions plane
        # is live; with KTPU_SLO_ACTIONS=0 this is exactly one call at
        # the pool's historical default timeout
        from . import sloactions

        names = [p.name for p in policies]
        results = sloactions.pool_evaluate(
            pool, generation,
            lambda timeout_s: pool.evaluate(
                names, resource, request, namespace_labels,
                info.roles, info.cluster_roles,
                self.config.get_exclude_group_role(),
                timeout_s=timeout_s))
        if results is None:
            return None
        by_name = dict(results)
        from ..engine.response import (
            EngineResponse,
            PolicyResponse,
            PolicySpecSummary,
            ResourceSpec,
            RuleResponse,
            RuleType,
        )

        # DELETE admissions carry the identity on oldObject (object is
        # null) — mirror the inline engine's fallback so events/reports
        # name the resource either way
        ident = resource or request.get("oldObject") or {}
        meta = ident.get("metadata") or {}
        out = []
        for policy in policies:
            rows = by_name.get(policy.name)
            if rows is None:
                return None      # worker set out of date: run inline
            resp = EngineResponse(policy_response=PolicyResponse(
                policy=PolicySpecSummary(
                    name=policy.name,
                    validation_failure_action=(
                        policy.spec.validation_failure_action)),
                resource=ResourceSpec(
                    kind=ident.get("kind", ""),
                    api_version=ident.get("apiVersion", ""),
                    namespace=meta.get("namespace", ""),
                    name=meta.get("name", ""),
                    uid=meta.get("uid", ""))))
            for rule_name, status_value, message in rows:
                resp.policy_response.rules.append(RuleResponse(
                    name=rule_name, type=RuleType.VALIDATION,
                    message=message, status=RuleStatus(status_value)))
            out.append(resp)
        return out

    def _process_audit(self, request: dict) -> None:
        """validate_audit.go:151 process — with the device screen in
        front: queued audit work has NO latency budget, making it the
        ideal device workload. Concurrent audit workers' screens coalesce
        into shared flushes; policies the device clears record straight
        from the verdict row, and only policies with a FAIL/ERROR/HOST
        cell re-run the CPU oracle (for faithful messages and
        context-dependent semantics) — the enforce path's hybrid merge,
        minus any deadline pressure."""
        kind = ((request.get("kind") or {}).get("kind")) or ""
        namespace = request.get("namespace", "")
        resource = request.get("object") or {}
        audit_policies = self.policy_cache.get_policies(
            PolicyType.VALIDATE_AUDIT, kind, namespace)
        if not audit_policies:
            return
        run_policies = audit_policies
        memo_key = None
        if self.admission_batcher is not None:
            env = {"operation": request.get("operation"),
                   "userInfo": request.get("userInfo"),
                   "oldObject": request.get("oldObject")}
            # TTL dedup of identical audit work — the reference's
            # ResourceManager does exactly this for background processing
            # (pkg/policy/existing.go:125): a repeat of an identical
            # request re-records metrics but skips the engine; the report
            # rows it would produce are already in the store (idempotent)
            memo_key = self.admission_batcher.decision_key(
                PolicyType.VALIDATE_AUDIT, kind, namespace, resource,
                env=env)
            hit = (self._audit_memo.get(memo_key)
                   if memo_key is not None else None)
            if hit is not None and hit[0] > time.monotonic():
                for pn, rn, sv, _msg in hit[1]:
                    metrics_mod.record_policy_results(
                        self.registry, pn, rn, sv,
                        validation_mode="audit", resource_kind=kind,
                        request_operation=request.get("operation", "CREATE"))
                # same reconcile()-during-hit-window gap as the decision
                # cache: replay the rows so a full rebuild keeps them
                self._reemit_report_rows(hit[1], resource, request)
                self.admission_batcher.stats["audit_memo"] = (
                    self.admission_batcher.stats.get("audit_memo", 0) + 1)
                return
            # a deadline-free screen must also WAIT deadline-free: with a
            # backed-up link, abandoning at the admission deadline would
            # discard the in-flight device work and run the full oracle
            # anyway — strictly worse than not screening
            status, row = self.admission_batcher.screen(
                PolicyType.VALIDATE_AUDIT, kind, namespace, resource,
                env=env, deadline_free=True,
                timeout_s=batch_mod.WEBHOOK_TIMEOUT_S * 6,
                ctx_cb=lambda: self._admission_ctx_payload(request,
                                                           namespace))
            if status != batch_mod.ORACLE and row:
                from ..models import Verdict

                bad = {p for p, _, v, _ in row
                       if v not in (Verdict.PASS, Verdict.SKIP)}
                audit_rows = self._record_screen_results(
                    [t for t in row if t[0] not in bad],
                    resource, kind, request, mode="audit")
                run_policies = [p for p in audit_policies if p.name in bad]
            else:
                audit_rows = []
        else:
            audit_rows = []
        # context build (roles, image info, ns labels) only when the
        # oracle actually runs — the screened-clean common case skips it
        pctx = (self._policy_context(request, resource)
                if run_policies else None)
        for policy in run_policies:
            pctx.policy = policy
            resp = engine_validate(pctx)
            for rule in resp.policy_response.rules:
                audit_rows.append(
                    (policy.name, rule.name, rule.status.value,
                     rule.message))
                metrics_mod.record_policy_results(
                    self.registry, policy.name, rule.name, rule.status.value,
                    validation_mode="audit", resource_kind=kind,
                    request_operation=request.get("operation", "CREATE"))
            if self.event_gen is not None:
                self.event_gen.add(*events_for_engine_response(resp))
            if self.report_gen is not None:
                self.report_gen.add(resp)
        if (memo_key is not None and self.admission_batcher is not None
                and self.admission_batcher.result_cache_ttl_s > 0
                and all(t[2] in ("pass", "fail", "skip", "error")
                        for t in audit_rows)):
            with self._decision_lock:   # audit workers store concurrently
                batch_mod.ttl_store(
                    self._audit_memo, memo_key,
                    self.admission_batcher.result_cache_ttl_s, (audit_rows,))

    def _apply_generate_policies(self, request: dict) -> None:
        """webhooks/generation.go: matching generate rules become
        GenerateRequest documents consumed by the generate controller."""
        if self.client is None:
            return
        kind = ((request.get("kind") or {}).get("kind")) or ""
        namespace = request.get("namespace", "")
        resource = request.get("object") or {}
        pctx = self._policy_context(request, resource)
        for policy in self.policy_cache.get_policies(
            PolicyType.GENERATE, kind, namespace
        ):
            pctx.policy = policy
            resp = engine_generate(pctx)
            applicable = [
                r.name for r in resp.policy_response.rules
                if r.status is RuleStatus.PASS
            ]
            if not applicable:
                continue
            meta = resource.get("metadata") or {}
            self.client.create_resource({
                "apiVersion": "kyverno.io/v1",
                "kind": "GenerateRequest",
                "metadata": {
                    "name": f"gr-{uuid.uuid4().hex[:10]}",
                    "namespace": "kyverno",
                    "labels": {"generate.kyverno.io/policy-name": policy.name},
                },
                "spec": {
                    "policy": policy.name,
                    "resource": {
                        "kind": resource.get("kind", ""),
                        "apiVersion": resource.get("apiVersion", ""),
                        "namespace": meta.get("namespace", ""),
                        "name": meta.get("name", ""),
                    },
                    "context": {
                        "userInfo": request.get("userInfo") or {},
                        "admissionRequestInfo": {
                            "operation": request.get("operation", "CREATE"),
                        },
                    },
                },
                "status": {"state": "Pending"},
            })

    def _policy_mutation(self, request: dict) -> dict:
        """policymutation.go:17: defaults + autogen patches on the policy."""
        uid = request.get("uid", "")
        policy_doc = request.get("object") or {}
        patches: list[dict] = []
        spec = policy_doc.get("spec") or {}
        if "validationFailureAction" not in spec:
            patches.append({"op": "add", "path": "/spec/validationFailureAction",
                            "value": "audit"})
        if "background" not in spec:
            patches.append({"op": "add", "path": "/spec/background", "value": True})
        if "failurePolicy" not in spec:
            patches.append({"op": "add", "path": "/spec/failurePolicy", "value": "Fail"})
        defaulted = apply_defaults(policy_doc)
        new_rules = generate_pod_controller_rules(defaulted)
        base = len(spec.get("rules") or [])
        for i, rule in enumerate(new_rules):
            patches.append({"op": "add", "path": f"/spec/rules/{base + i}", "value": rule})
        metrics_mod.record_policy_change(
            self.registry, (policy_doc.get("metadata") or {}).get("name", ""),
            request.get("operation", "CREATE").lower())
        return _admission_response(uid, True, patches=patches)

    def _policy_validation(self, request: dict) -> dict:
        """policyvalidation.go: structural validation gates admission,
        then mutate patterns are schema-checked against the kind schemas
        (pkg/policy/validate.go -> openapi ValidatePolicyMutation)."""
        uid = request.get("uid", "")
        try:
            policy = load_policy(request.get("object") or {})
        except Exception as e:
            return _admission_response(uid, False, f"invalid policy: {e}")
        errors = validate_policy(policy)
        if not errors:
            errors = validate_policy_mutation(policy)
        if not errors:
            # generate policies the controller cannot execute are rejected
            # (policy/generate/validate.go:102 canIGenerate)
            from .auth import can_i_generate

            errors = can_i_generate(policy, self.client)
        if errors:
            return _admission_response(uid, False, "; ".join(errors))
        return _admission_response(uid, True)

    # ------------------------------------------------------------ serving

    def run(self, host: str = "0.0.0.0", port: int = 9443,
            certfile: str = "", keyfile: str = "") -> ThreadingHTTPServer:
        """server.go:568 RunAsync: serve in a daemon thread."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: the API server reuses webhook
            # connections; Content-Length is mandatory for reuse, and
            # Nagle must be off or header/body writes stall 40ms against
            # the peer's delayed ACK
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes, ctype: str = ""):
                self.send_response(code)
                if ctype:
                    self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in (LIVENESS_PATH, READINESS_PATH):
                    self._reply(200, b"ok")
                    return
                # /metrics, /healthz, /debug/traces (runtime/obs_http)
                obs = obs_http.handle_obs_get(self.path, server.registry)
                if obs is not None:
                    status, body, ctype = obs
                    self._reply(status, body, ctype)
                else:
                    self._reply(404, b"")

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                if self.path.split("?", 1)[0].startswith("/debug/"):
                    # observability POSTs (/debug/dryrun) are not
                    # admissions: route them before the AdmissionReview
                    # parse and keep them out of the admission trace
                    body = self.rfile.read(length) if length else b""
                    obs = obs_http.handle_obs_post(self.path, body,
                                                   server.registry)
                    if obs is not None:
                        status, rbody, ctype = obs
                        self._reply(status, rbody, ctype)
                    else:
                        self._reply(404, b"")
                    return
                rec = tracing.recorder()
                trace = rec.start("admission", path=self.path,
                                  transport="http")
                # cross-process propagation: a caller that sent a W3C
                # traceparent header owns the trace id — this hop's
                # spans export under the caller's id at /debug/traces
                remote = tracing.parse_traceparent(
                    self.headers.get(tracing.TRACEPARENT_HEADER))
                if remote:
                    tracing.adopt_remote_id(trace, remote)
                tok = tracing.bind(trace) if trace is not None else None
                try:
                    review = json.loads(self.rfile.read(length) or b"{}")
                    out = server.handle(self.path, review)
                    m0 = time.perf_counter()
                    body = json.dumps(out).encode()
                    rec.add_span(trace, "response_marshal", m0,
                                 time.perf_counter(), bytes=len(body))
                    if trace is not None:
                        trace.labels["allowed"] = str(
                            out["response"]["allowed"])
                    self._reply(200, body, "application/json")
                except Exception as e:
                    self._reply(500, str(e).encode())
                finally:
                    if tok is not None:
                        tracing.unbind(tok)
                    rec.finish(trace)

        class Httpd(ThreadingHTTPServer):
            daemon_threads = True
            # a burst of admissions must not overflow the accept backlog
            # (the default of 5 turns SYN drops into 1s retransmit spikes)
            request_queue_size = 128

        httpd = Httpd((host, port), Handler)
        httpd.timeout = 15  # server.go:237 read/write timeouts
        if certfile and keyfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        self.audit_handler.run()
        if self.event_gen is not None:
            self.event_gen.run()
        self._httpd = httpd
        return httpd

    def stop(self) -> None:
        """server.go:586 Stop."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        if self.oracle_pool is not None:
            self.oracle_pool.stop()
        self.audit_handler.stop()
        if self.event_gen is not None:
            self.event_gen.stop()
