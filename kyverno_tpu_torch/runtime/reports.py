"""Policy report pipeline: engine results -> change requests -> reports.

Mirrors the reference's pkg/policyreport two-stage CQRS: (1) engine
responses become ReportChangeRequest / ClusterReportChangeRequest documents;
(2) the ReportGenerator aggregates them per namespace into
PolicyReport / ClusterPolicyReport (wgpolicyk8s.io/v1alpha2,
reportcontroller.go:501 aggregateReports) and deletes consumed requests.

A cluster client is any object with ``get_resource``, ``create_resource``,
``update_resource``, ``list_resource`` and ``delete_resource``; without
one the requests stay in an in-process list.
"""

from __future__ import annotations

import threading
import time
from collections import Counter

from ..engine.response import EngineResponse, RuleStatus

_STATUS_TO_RESULT = {
    RuleStatus.PASS: "pass",
    RuleStatus.FAIL: "fail",
    RuleStatus.WARN: "warn",
    RuleStatus.ERROR: "error",
    RuleStatus.SKIP: "skip",
}


def build_change_request(resp: EngineResponse) -> dict | None:
    """One change request per engine response; namespace-less
    resources produce ClusterReportChangeRequests."""
    pr = resp.policy_response
    results = []
    for rule in pr.rules:
        results.append({
            "policy": pr.policy.name,
            "rule": rule.name,
            "result": _STATUS_TO_RESULT[rule.status],
            "message": rule.message,
            "resources": [{
                "kind": pr.resource.kind,
                "apiVersion": pr.resource.api_version,
                "namespace": pr.resource.namespace,
                "name": pr.resource.name,
                "uid": pr.resource.uid,
            }],
            "scored": True,
            "timestamp": int(time.time()),
            # freshness key for same-(policy,rule,resource) merges: the
            # second-resolution reference timestamp cannot order an
            # admission result against a scan result produced moments
            # later; stripped from emitted report rows
            "timestampNs": time.time_ns(),
        })
    if not results:
        return None
    namespaced = bool(pr.resource.namespace)
    return {
        "apiVersion": "kyverno.io/v1alpha2",
        "kind": "ReportChangeRequest" if namespaced else "ClusterReportChangeRequest",
        "metadata": {
            "name": f"rcr-{pr.policy.name}-{pr.resource.kind}-{pr.resource.name}".lower(),
            "namespace": pr.resource.namespace,
            "labels": {"kyverno.io/policy": pr.policy.name},
        },
        "results": results,
    }


def _summary(results: list[dict]) -> dict:
    summary = {"pass": 0, "fail": 0, "warn": 0, "error": 0, "skip": 0}
    for r in results:
        summary[r.get("result", "skip")] = summary.get(r.get("result", "skip"), 0) + 1
    return summary


class ReportGenerator:
    """reportcontroller.go ReportGenerator: collects change requests and
    aggregates them into per-namespace PolicyReports + one
    ClusterPolicyReport. ``reconcile`` rebuilds from scratch (the full
    reconcile channel of cmd/kyverno/main.go:260)."""

    def __init__(self, client=None, persist_requests: bool | None = None):
        self.client = client
        # CR-backed request transport (reportrequest.go +
        # changerequestcreator.go): every replica persists its change
        # requests as ReportChangeRequest/ClusterReportChangeRequest CRs,
        # and the leader's aggregate() consumes-and-deletes them
        # (reportcontroller.go:501,682). Default ON whenever a cluster
        # client exists — an in-process pending list cannot carry a
        # non-leader replica's audit/scan results to the leader. Without
        # a client the in-process list remains (CLI, tests).
        self.persist_requests = (client is not None
                                 if persist_requests is None
                                 else persist_requests)
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        # async CR writer (changerequestcreator.go's queued creator): the
        # admission path must never block on report persistence — an
        # enqueue costs a deque append; the writer thread owns the API
        # round trips and retries transient failures
        from collections import deque

        self._queue: deque = deque()
        self._writer_wake = threading.Event()
        self._writer_stop = threading.Event()
        self._writer: threading.Thread | None = None
        # True while the writer holds an item it popped but hasn't
        # persisted: flush() and aggregate() must wait it out or that
        # result is invisible to both the queue drain and the CR list
        self._writing = False
        # current-state result store: (ns, policy, rule, kind, name) -> result.
        # Reports are REBUILT from this map each aggregate() — stored report
        # objects are replaced, never merged, so deleted policies/resources
        # don't accumulate stale rows (reportcontroller.go:682 cleanup).
        self._results: dict[tuple, dict] = {}
        # stored results by subject kind: a prune for a kind with none
        # (the report plane's own change requests, deleted as aggregate()
        # consumes them, each a watch event) skips the pass over the store
        self._subject_kinds: Counter = Counter()
        # namespaces that ever emitted a report: an empty rebuild must still
        # write (now-empty) reports for them, or stale rows would survive
        self._known_ns: set[str] = set()

    def add(self, *responses: EngineResponse) -> None:
        for resp in responses:
            rcr = build_change_request(resp)
            if rcr is not None:
                self.add_change_request(rcr)

    def add_change_request(self, rcr: dict) -> None:
        if self.client is not None and self.persist_requests:
            self._queue.append(rcr)
            self._ensure_writer()
            self._writer_wake.set()
            self._note_depth()
            return
        with self._lock:
            self._pending.append(rcr)
        self._note_depth()

    def _note_depth(self) -> None:
        """Gauge the CR-writer queue and the in-process pending list —
        the report-pipeline backlog an operator watches during scans."""
        try:
            from . import metrics as metrics_mod

            metrics_mod.record_report_queue_depth(
                metrics_mod.registry(), queued=len(self._queue),
                pending=len(self._pending))
        except Exception:
            pass

    # --------------------------------------------------- async CR writer

    def _ensure_writer(self) -> None:
        if self._writer is not None and self._writer.is_alive():
            return
        with self._lock:
            if self._writer is not None and self._writer.is_alive():
                return
            self._writer = threading.Thread(
                target=self._writer_loop, name="rcr-writer", daemon=True)
            self._writer.start()

    def _writer_loop(self) -> None:
        while not self._writer_stop.is_set():
            self._writer_wake.wait(1.0)
            self._writer_wake.clear()
            self._drain_queue()

    def _drain_queue(self) -> None:
        while self._queue:
            # the flag goes up BEFORE the pop: between popleft and the
            # write the item exists nowhere observable, and flush()/
            # aggregate() must never see queue-empty + not-writing in
            # that window
            self._writing = True
            try:
                try:
                    rcr = self._queue.popleft()
                except IndexError:
                    return
                for attempt in (0, 1):
                    try:
                        self._write_rcr(rcr)
                        break
                    except Exception:
                        # first failure may be a racing delete/conflict —
                        # the retry re-gets; a second failure re-queues
                        # with a breather so the result is never dropped
                        if attempt == 1:
                            self._queue.append(rcr)
                            self._writing = False
                            self._writer_stop.wait(0.5)
                            return
            finally:
                self._writing = False

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until every queued change request is persisted (tests,
        shutdown, and the leader before aggregation). True when both the
        queue AND any in-flight write drained."""
        deadline = time.monotonic() + timeout_s
        while (self._queue or self._writing) and \
                time.monotonic() < deadline:
            self._writer_wake.set()
            time.sleep(0.005)
        return not self._queue and not self._writing

    def stop(self) -> None:
        self._writer_stop.set()
        self._writer_wake.set()
        if self._writer is not None:
            self._writer.join(timeout=2.0)

    def _write_rcr(self, rcr: dict) -> None:
        """Create-or-replace the change request CR by its deterministic
        name — the latest result for a (policy, resource) pair wins, the
        changerequestcreator.go dedup."""
        meta = rcr.get("metadata") or {}
        existing = self.client.get_resource(
            rcr["apiVersion"], rcr["kind"],
            meta.get("namespace", ""), meta.get("name", ""))
        if existing is None:
            self.client.create_resource(rcr)
        else:
            existing["results"] = rcr["results"]
            self.client.update_resource(existing)

    @staticmethod
    def _filter_pending(pending: list[dict], keep) -> list[dict]:
        """Apply a per-result predicate to not-yet-consumed change
        requests: results produced before a prune are just as stale as
        already-consumed ones, and must not resurrect at the next
        aggregate()."""
        out = []
        for rcr in pending:
            results = [r for r in rcr.get("results") or [] if keep(rcr, r)]
            if results:
                out.append({**rcr, "results": results})
        return out

    def prune_policy(self, policy_name: str) -> None:
        """Drop all results of a deleted policy (policy delete handler in
        reportcontroller.go's full reconcile)."""
        with self._lock:
            self._results = {
                k: v for k, v in self._results.items() if k[1] != policy_name
            }
            self._subject_kinds = Counter(k[3] for k in self._results)
            self._pending = self._filter_pending(
                self._pending,
                lambda rcr, r: r.get("policy") != policy_name)

    def prune_resource(self, kind: str, namespace: str, name: str) -> None:
        """Drop all results for a deleted resource."""
        with self._lock:
            if self._subject_kinds[kind]:
                self._results = {
                    k: v for k, v in self._results.items()
                    if not (k[0] == namespace and k[3] == kind
                            and k[4] == name)
                }
                self._subject_kinds = Counter(k[3] for k in self._results)

            def keep(rcr, r):
                ns = (rcr.get("metadata") or {}).get("namespace", "")
                res = (r.get("resources") or [{}])[0]
                return not (ns == namespace and res.get("kind") == kind
                            and res.get("name") == name)

            self._pending = self._filter_pending(self._pending, keep)

    def reconcile(self) -> None:
        """Full rebuild: forget the current state so the next scan/audit
        repopulates from scratch (prgen.ReconcileCh, main.go:260)."""
        with self._lock:
            self._results.clear()
            self._subject_kinds.clear()

    def aggregate(self) -> list[dict]:
        """reportcontroller.go:501 aggregateReports + :541 mergeRequests:
        consume pending requests into the result store, emit report objects
        rebuilt from the store. With a cluster client, change-request CRs
        written by EVERY replica are consumed and deleted here — the
        leader-side half of the CR transport (reportcontroller.go:682
        cleanup of consumed requests)."""
        consumed: list[tuple] = []
        if self.client is not None and self.persist_requests:
            # the leader's OWN queued requests consume directly — writing
            # them out only to immediately read them back buys nothing.
            # Hold them aside: they must apply AFTER the cluster-listed
            # CRs (same-key merge is last-write-wins, and a local queued
            # result is strictly fresher than this replica's own
            # already-persisted CR — e.g. a scan FAIL queued after an
            # admission PASS for the same resource must win)
            local: list[dict] = []
            while self._queue:
                try:
                    local.append(self._queue.popleft())
                except IndexError:
                    break
            # an item the writer popped but hasn't persisted yet is in
            # NEITHER the queue nor the cluster: wait it out, or this
            # cycle's report silently misses a result that was produced
            # before aggregation started
            deadline = time.monotonic() + 2.0
            while self._writing and time.monotonic() < deadline:
                time.sleep(0.005)
            for kind in ("ReportChangeRequest", "ClusterReportChangeRequest"):
                try:
                    items = list(self.client.list_resource(
                        "kyverno.io/v1alpha2", kind))
                except Exception:
                    items = []
                for rcr in items:
                    meta = rcr.get("metadata") or {}
                    with self._lock:
                        self._pending.append(rcr)
                    consumed.append((kind, meta.get("namespace", ""),
                                     meta.get("name", "")))
            with self._lock:
                self._pending.extend(local)
        with self._lock:
            pending = self._pending
            self._pending = []
            for rcr in pending:
                ns = (rcr.get("metadata") or {}).get("namespace", "")
                for r in rcr.get("results") or []:
                    res = (r.get("resources") or [{}])[0]
                    key = (ns, r.get("policy"), r.get("rule"),
                           res.get("kind"), res.get("name"))
                    # freshest-wins by production time, NOT application
                    # order: consumption interleavings (local queue vs
                    # cluster CRs vs another replica) cannot be ordered
                    # reliably, but the producing timestamp can — an
                    # admission PASS must never bury a later scan FAIL,
                    # and vice versa. Legacy rows without the ns stamp
                    # rank as 0 (always replaceable).
                    old = self._results.get(key)
                    if old is not None and (old.get("timestampNs") or 0) > \
                            (r.get("timestampNs") or 0):
                        continue
                    if old is None:
                        self._subject_kinds[key[3]] += 1
                    self._results[key] = r
            by_namespace: dict[str, list[dict]] = {
                ns: [] for ns in self._known_ns
            }
            for (ns, *_), r in sorted(self._results.items(),
                                      key=lambda kv: kv[0]):
                # the freshness key is internal — report rows carry the
                # reference's second-resolution timestamp only
                by_namespace.setdefault(ns, []).append(
                    {k: v for k, v in r.items() if k != "timestampNs"})
            self._known_ns.update(by_namespace)

        reports = []
        for ns, results in sorted(by_namespace.items()):
            if ns:
                reports.append({
                    "apiVersion": "wgpolicyk8s.io/v1alpha2",
                    "kind": "PolicyReport",
                    "metadata": {"name": f"polr-ns-{ns}", "namespace": ns},
                    "results": results,
                    "summary": _summary(results),
                })
            else:
                reports.append({
                    "apiVersion": "wgpolicyk8s.io/v1alpha2",
                    "kind": "ClusterPolicyReport",
                    "metadata": {"name": "clusterpolicyreport"},
                    "results": results,
                    "summary": _summary(results),
                })
        if self.client is not None:
            for report in reports:
                meta = report.get("metadata") or {}
                existing = self.client.get_resource(
                    report["apiVersion"], report["kind"],
                    meta.get("namespace", ""), meta.get("name", ""),
                )
                if existing is None:
                    self.client.create_resource(report)
                else:
                    # replace: the store IS the current state
                    existing["results"] = report["results"]
                    existing["summary"] = report["summary"]
                    self.client.update_resource(existing)
            # delete consumed change requests ONLY after the merged
            # reports are durably written: a crash between consumption
            # and the write must leave the CRs for the next leader
            # (reportcontroller.go:682 cleanup ordering)
            for kind, ns, name in consumed:
                try:
                    self.client.delete_resource(
                        "kyverno.io/v1alpha2", kind, ns, name)
                except Exception:
                    pass
        self._note_depth()
        return reports
