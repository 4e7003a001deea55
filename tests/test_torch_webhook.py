"""The admission webhook on the port: ``WebhookServer`` against the JAX
package's on the same AdmissionReviews, on the CPU.

- Parity: the same reviews, made from a numpy seed, go through the JAX
  ``WebhookServer`` (its batcher on JAX's CPU backend) and through the
  port's (``device="cpu"``: every kernel's plain version), with a batcher
  and without one, on ``/validate``, ``/mutate``, ``/policyvalidate`` and
  ``/policymutate``, in process and over HTTP/1.1 keep-alive. The
  responses are equal exactly (patches decoded), and so are the report
  rows, the events and the counters of the two servers' registries
  (duration histograms left out). Both batchers run the JAX tests'
  deterministic routing (every screen to the device, no result cache, no
  cold release) with waits that cannot time out, so the lane a request
  takes does not depend on the host's load.
- The JAX package's webhook batteries, case by case, on the port
  (``torch_parity.mirror_battery``; the JAX side of each case is the
  battery's own file). The edits are the port's: a policy cache or
  scanner on ``device="cpu"``. Cases that need the upstream fixture
  corpus are left out by name, and ``TestMigrations`` runs in
  ``test_torch_server.py``.

Each package keeps its own singletons (the metrics registry, the trace
recorder, the SLO watchdog and controller, the host-lane resolver); each
case starts them afresh.
"""

import base64
import copy
import http.client
import json

import numpy as np
import pytest

import chip_smoke
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.runtime import batch as jax_batch
from kyverno_tpu.runtime import client as jax_client
from kyverno_tpu.runtime import events as jax_events
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu.runtime import metrics as jax_metrics
from kyverno_tpu.runtime import policycache as jax_policycache
from kyverno_tpu.runtime import reports as jax_reports
from kyverno_tpu.runtime import slo as jax_slo
from kyverno_tpu.runtime import sloactions as jax_sloactions
from kyverno_tpu.runtime import tracing as jax_tracing
from kyverno_tpu.runtime import webhook as jax_webhook
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.runtime import batch as torch_batch
from kyverno_tpu_torch.runtime import client as torch_client
from kyverno_tpu_torch.runtime import events as torch_events
from kyverno_tpu_torch.runtime import hostlane as torch_hostlane
from kyverno_tpu_torch.runtime import metrics as torch_metrics
from kyverno_tpu_torch.runtime import policycache as torch_policycache
from kyverno_tpu_torch.runtime import reports as torch_reports
from kyverno_tpu_torch.runtime import slo as torch_slo
from kyverno_tpu_torch.runtime import sloactions as torch_sloactions
from kyverno_tpu_torch.runtime import tracing as torch_tracing
from kyverno_tpu_torch.runtime import webhook as torch_webhook
from tests.torch_parity import mirror_battery
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

_CPU_CACHE = ("PolicyCache()", 'PolicyCache(device="cpu")')

# the JAX package's webhook batteries, on the port
for _relpath, _subs, _drop in (
        ("tests/runtime/test_runtime.py", (
            _CPU_CACHE,
            ("BackgroundScanner([load_policy(doc)])",
             'BackgroundScanner([load_policy(doc)], device="cpu")')),
         # the upstream fixture corpus (absent here, as for the JAX case)
         ("TestBackgroundScan.test_scan_snapshot",)),
        ("tests/runtime/test_webhook_keepalive.py", (_CPU_CACHE,), ()),
        ("tests/runtime/test_admission_smoke.py", (_CPU_CACHE,), ()),
        ("tests/runtime/test_auth_migrations.py", (_CPU_CACHE,),
         # mirrored in test_torch_server.py, with the controller
         ("TestMigrations",))):
    _exports = mirror_battery(_relpath, _subs, _drop)
    _clash = set(_exports) & set(globals())
    assert not _clash, (_relpath, _clash)
    globals().update(_exports)


# ------------------------------------------------------------ the inputs

SEED = 20261018
N_REVIEWS = 24


def _library() -> list[dict]:
    """About 20 policies of the synthetic 250-policy library, three of each
    family (its host-lane slice included), every other one in enforce
    mode; the rest audit."""
    by_family: dict[str, list] = {}
    for d in chip_smoke._synth_policy_docs(250):
        by_family.setdefault(d["metadata"]["name"].rsplit("-v", 1)[0],
                             []).append(d)
    docs = [copy.deepcopy(d) for fam in sorted(by_family)
            for d in by_family[fam][:3]]
    for j, d in enumerate(docs):
        if j % 2 == 0:
            d["spec"]["validationFailureAction"] = "enforce"
    return docs


LIBRARY = _library()
MUTATORS = [chip_smoke.ADD_DEFAULT_LABELS, chip_smoke.ANNOTATE_BENCH_APPS]
NAMESPACES = [{"apiVersion": "v1", "kind": "Namespace",
               "metadata": {"name": ns, "labels": {"team": ns}}}
              for ns in ("default", "payments")]


def _reviews(seed: int = SEED, n: int = N_REVIEWS) -> list[dict]:
    """Distinct Pod admissions: ``make_pod`` bodies at seeded indices,
    seeded images, namespaces, operations and users."""
    rng = np.random.default_rng(seed)
    images = ["nginx:latest", "nginx:1.25", "redis:7", "busybox",
              "registry.io/team/app:v3"]
    out = []
    for j in range(n):
        pod = chip_smoke.make_pod(int(rng.integers(0, 1000)))
        ns = ["default", "payments"][int(rng.integers(0, 2))]
        pod["metadata"]["name"] = f"pod-{seed % 997}-{j}"
        pod["metadata"]["namespace"] = ns
        pod["spec"]["containers"][0]["image"] = images[
            int(rng.integers(0, len(images)))]
        op = ["CREATE", "UPDATE"][int(rng.integers(0, 2))]
        request = {"uid": f"uid-{j}", "kind": {"kind": "Pod"},
                   "namespace": ns, "operation": op, "object": pod,
                   "userInfo": {"username": ["alice", "bob"][j % 2],
                                "groups": ["dev"]}}
        if op == "UPDATE":
            request["oldObject"] = copy.deepcopy(pod)
        out.append({"apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview", "request": request})
    return out


def _policy_reviews() -> list[dict]:
    """Policy admissions: library policies, the mutate policies, two that
    fail validation (a duplicate rule name, an empty match) and a generate
    policy."""
    dup = copy.deepcopy(LIBRARY[0])
    dup["metadata"]["name"] = "duplicate-rule"
    dup["spec"]["rules"].append(copy.deepcopy(dup["spec"]["rules"][0]))
    empty = copy.deepcopy(LIBRARY[1])
    empty["metadata"]["name"] = "empty-match"
    empty["spec"]["rules"][0]["match"] = {"resources": {}}
    docs = LIBRARY[:4] + MUTATORS + [dup, empty, {
        "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
        "metadata": {"name": "gen-np"},
        "spec": {"rules": [{
            "name": "gen-np-r",
            "match": {"resources": {"kinds": ["Namespace"]}},
            "generate": {"apiVersion": "networking.k8s.io/v1",
                         "kind": "NetworkPolicy", "name": "default-deny",
                         "namespace": "{{request.object.metadata.name}}",
                         "data": {"spec": {"podSelector": {}}}}}]}}]
    return [{"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
             "request": {"uid": f"pol-{j}", "kind": {"kind": "ClusterPolicy"},
                         "operation": "CREATE", "object": copy.deepcopy(d)}}
            for j, d in enumerate(docs)]


# --------------------------------------------------------- the two sides

class Side:
    """One package's modules."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            (self.load, self.batch, self.client, self.events, self.hostlane,
             self.metrics, self.policycache, self.reports, self.slo,
             self.sloactions, self.tracing, self.webhook) = (
                jax_load_policy, jax_batch, jax_client, jax_events,
                jax_hostlane, jax_metrics, jax_policycache, jax_reports,
                jax_slo, jax_sloactions, jax_tracing, jax_webhook)
        else:
            (self.load, self.batch, self.client, self.events, self.hostlane,
             self.metrics, self.policycache, self.reports, self.slo,
             self.sloactions, self.tracing, self.webhook) = (
                torch_load_policy, torch_batch, torch_client, torch_events,
                torch_hostlane, torch_metrics, torch_policycache,
                torch_reports, torch_slo, torch_sloactions, torch_tracing,
                torch_webhook)

    def reset(self) -> None:
        """The package's singletons, as a fresh process has them."""
        self.metrics.registry().reset()
        self.metrics.attrib_state().reset()
        self.tracing.recorder().clear()
        self.slo.watchdog().clear()
        self.sloactions.controller().reset()
        self.hostlane.resolver().attach_pool(None, None)
        self.hostlane.host_cache().clear()

    def cache(self):
        if self.name == "jax":
            return self.policycache.PolicyCache()
        return self.policycache.PolicyCache(device="cpu")


SIDES = (Side("jax"), Side("torch"))


class Stack:
    """A ``WebhookServer`` with its cluster, reports, events and registry
    (and a batcher on request), the oracle pool left out: its workers
    are processes, and a pool answers as the inline oracle does."""

    def __init__(self, side: Side, docs: list, with_batcher: bool):
        side.reset()
        self.side = side
        cache = side.cache()
        for d in docs:
            cache.add(side.load(copy.deepcopy(d)))
        self.cluster = side.client.FakeCluster(copy.deepcopy(NAMESPACES))
        self.reports = side.reports.ReportGenerator()
        self.events = side.events.EventGenerator(self.cluster, workers=1)
        self.registry = side.metrics.MetricsRegistry()
        self.batcher = None
        if with_batcher:
            b = side.batch.AdmissionBatcher(
                cache, window_s=0.002, burst_threshold=1,
                dispatch_cost_init_s=0.0, oracle_cost_init_s=1.0,
                cold_flush_fallback=False, result_cache_ttl_s=0.0)
            b._device_favored = lambda *a, **k: True
            screen = b.screen

            def patient(*a, **k):
                k.update(deadline_free=True, timeout_s=300.0)
                return screen(*a, **k)

            b.screen = patient
            self.batcher = b
        self.server = side.webhook.WebhookServer(
            policy_cache=cache, client=self.cluster, report_gen=self.reports,
            event_gen=self.events, registry=self.registry,
            admission_batcher=self.batcher)
        self.server.oracle_pool.stop()
        self.server.oracle_pool = None
        side.hostlane.resolver().attach_pool(None, None)
        self.events.run()
        self.server.audit_handler.run()

    def settle(self) -> None:
        self.server.audit_handler.drain()
        self.events.drain()

    def close(self) -> None:
        self.server.stop()
        if self.batcher is not None:
            self.batcher.stop()
        self.side.reset()


def _response(out: dict) -> dict:
    """The AdmissionReview's response, its JSON patch decoded."""
    resp = dict(out["response"])
    if "patch" in resp:
        resp["patch"] = json.loads(base64.b64decode(resp["patch"]))
    return resp


_STAMPS = ("timestamp", "timestampNs", "creationTimestamp",
           "resourceVersion", "uid")


def _unstamped(obj):
    if isinstance(obj, dict):
        return {k: _unstamped(v) for k, v in obj.items() if k not in _STAMPS}
    if isinstance(obj, list):
        return [_unstamped(v) for v in obj]
    return obj


def _outcome(stack: Stack) -> dict:
    """What a run leaves behind besides the responses: the aggregated
    reports, the events written to the cluster (by involved object,
    reason and message), the GenerateRequests, and the counters of the
    server's registry."""
    stack.settle()
    reports = sorted((_unstamped(r) for r in stack.reports.aggregate()),
                     key=lambda r: json.dumps(r, sort_keys=True))
    events = sorted(
        (e["involvedObject"]["name"], e["reason"], e["message"], e["type"])
        for e in stack.cluster.list_resource("v1", "Event"))
    grs = sorted(json.dumps(_unstamped(
        {k: v for k, v in g.items() if k != "metadata"}), sort_keys=True)
        for g in stack.cluster.list_resource("kyverno.io/v1",
                                             "GenerateRequest"))
    counters = {name: {tuple(sorted(k)): v for k, v in series.items()}
                for name, series in stack.registry._counters.items()}
    return {"reports": reports, "events": events, "grs": grs,
            "counters": counters}


def _run(side: Side, docs: list, path: str, reviews: list,
         with_batcher: bool) -> tuple[list, dict]:
    stack = Stack(side, docs, with_batcher)
    try:
        responses = [_response(stack.server.handle(path, r)) for r in reviews]
        return responses, _outcome(stack)
    finally:
        stack.close()


def _assert_equal_runs(docs, path, reviews, with_batcher):
    (jr, jo), (tr, to) = (_run(s, docs, path, reviews, with_batcher)
                          for s in SIDES)
    for a, b, review in zip(jr, tr, reviews):
        assert b == a, review["request"]["uid"]
    assert to["reports"] == jo["reports"]
    assert to["events"] == jo["events"]
    assert to["grs"] == jo["grs"]
    assert to["counters"] == jo["counters"]
    return jr, jo


@pytest.mark.parametrize("with_batcher", [False, True],
                         ids=["oracle_only", "batcher"])
def test_validate_responses_reports_events_and_counters_equal(with_batcher):
    responses, outcome = _assert_equal_runs(
        LIBRARY, jax_webhook.VALIDATING_WEBHOOK_PATH, _reviews(),
        with_batcher)
    # the inputs do what they are for: some admissions are denied, some
    # allowed, the audit queue and the violation events have work
    allowed = [r["allowed"] for r in responses]
    assert any(allowed) and not all(allowed)
    assert outcome["reports"] and outcome["events"]
    assert "kyverno_policy_results_total" in outcome["counters"]


def test_validate_batcher_lane_answers_from_the_device():
    """With the batcher, the port's server screens every enforce
    admission on its policy cache's set (the plain kernels, on the CPU),
    as the JAX server does, and both decide some requests without the
    inline oracle."""
    got = []
    for side in SIDES:
        stack = Stack(side, LIBRARY, with_batcher=True)
        try:
            for r in _reviews(seed=SEED + 1, n=8):
                stack.server.handle(jax_webhook.VALIDATING_WEBHOOK_PATH, r)
            stats = stack.batcher.stats
            got.append((stats["device"], stats.get("device_decided", 0),
                        stats.get("device_deny", 0)))
        finally:
            stack.close()
    assert got[1] == got[0]
    assert got[1][0] > 0 and got[1][1] > 0


@pytest.mark.parametrize("with_batcher", [False, True],
                         ids=["oracle_only", "batcher"])
def test_mutate_patches_equal(with_batcher):
    responses, _ = _assert_equal_runs(
        LIBRARY + MUTATORS, jax_webhook.MUTATING_WEBHOOK_PATH, _reviews(),
        with_batcher)
    assert any(r.get("patch") for r in responses)


@pytest.mark.parametrize("path", [jax_webhook.POLICY_VALIDATING_WEBHOOK_PATH,
                                  jax_webhook.POLICY_MUTATING_WEBHOOK_PATH])
@pytest.mark.parametrize("with_batcher", [False, True],
                         ids=["oracle_only", "batcher"])
def test_policy_paths_equal(path, with_batcher):
    responses, _ = _assert_equal_runs([], path, _policy_reviews(),
                                      with_batcher)
    if path == jax_webhook.POLICY_VALIDATING_WEBHOOK_PATH:
        assert not all(r["allowed"] for r in responses)
    else:
        assert any(r.get("patch") for r in responses)


def test_generate_requests_written_equal():
    """A Namespace admission under a generate policy writes the same
    GenerateRequest through either server."""
    gen = _policy_reviews()[-1]["request"]["object"]
    ns = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
          "request": {"uid": "ns-1", "kind": {"kind": "Namespace"},
                      "namespace": "", "operation": "CREATE",
                      "object": {"apiVersion": "v1", "kind": "Namespace",
                                 "metadata": {"name": "team-a"}}}}
    _, outcome = _assert_equal_runs([gen], jax_webhook.VALIDATING_WEBHOOK_PATH,
                                    [ns], with_batcher=False)
    assert len(outcome["grs"]) == 1


def _post_all(port: int, path: str, reviews: list,
              traceparent: str | None = None) -> list:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out = []
    try:
        for r in reviews:
            headers = {"Content-Type": "application/json"}
            if traceparent:
                headers["traceparent"] = traceparent
            conn.request("POST", path, json.dumps(r), headers)
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.getheader("Connection", "").lower() != "close"
            out.append(_response(json.loads(resp.read())))
    finally:
        conn.close()
    return out


def test_http_keepalive_responses_and_metrics_equal():
    """A few reviews over ``run()`` on 127.0.0.1, one keep-alive
    connection a server: equal responses, and on each server ``/metrics``
    counts every request, ``/healthz`` answers and ``/debug/traces``
    holds the admissions under the caller's trace id."""
    reviews = _reviews(seed=SEED + 2, n=6)
    tp = "00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-00f067aa0ba902b7-01"
    got = []
    for side in SIDES:
        stack = Stack(side, LIBRARY, with_batcher=True)
        try:
            httpd = stack.server.run(host="127.0.0.1", port=0)
            port = httpd.server_address[1]
            responses = _post_all(port, jax_webhook.VALIDATING_WEBHOOK_PATH,
                                  reviews, traceparent=tp)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/metrics")
            metrics = conn.getresponse().read().decode()
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            conn.request("GET", "/debug/traces?n=64")
            traces = json.loads(conn.getresponse().read())["traces"]
            conn.close()
            requests = sum(
                float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                if ln.startswith("kyverno_admission_requests_total{"))
            adopted = [t for t in traces if t["kind"] == "admission"
                       and t["trace_id"] == tp.split("-")[1]]
            got.append((responses, requests, health["status"], len(adopted),
                        {s["name"] for t in adopted for s in t["spans"]}))
        finally:
            stack.close()
    (jr, jn, jh, ja, js), (tr, tn, th, ta, ts) = got
    assert tr == jr
    assert tn == jn == len(reviews)
    assert th == jh == "ok"
    assert ta == ja == len(reviews)
    assert {"coalesce_wait", "response_marshal"} <= ts
    assert ts & {"device_dispatch", "cold_dispatch"}


def test_server_without_a_card_needs_the_cpu_asked_for(monkeypatch):
    """The port's server builds its policy cache on ``cuda`` unless told
    otherwise: with no card it raises, and ``device="cpu"`` runs."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_webhook.WebhookServer()
    server = torch_webhook.WebhookServer(device="cpu")
    try:
        assert str(server.policy_cache.device) == "cpu"
    finally:
        server.stop()
        torch_hostlane.resolver().attach_pool(None, None)


def test_port_modules_hand_the_port_client_around():
    """The port's ``FakeCluster`` is the one its tests give to its
    modules, and it is not the JAX package's."""
    assert torch_client.FakeCluster is not jax_client.FakeCluster
    cluster = torch_client.FakeCluster(copy.deepcopy(NAMESPACES))
    from kyverno_tpu_torch.runtime.resourcecache import ResourceCache

    rc = ResourceCache(cluster)
    assert rc.get_namespace_labels("payments") == {"team": "payments"}
    assert rc.get_namespace_labels("missing") == {}
