"""The controller process on the port: ``server.Controller``, leader
election, webhook registration and narrowing, the migrations and the
generate controller, against the JAX package's on the CPU.

- The JAX package's batteries, case by case, on the port
  (``torch_parity.mirror_battery``; the JAX side of each case is the
  battery's own file): ``test_controller``, ``test_leaderelection``,
  ``test_webhook_narrowing``, ``test_auth_migrations::TestMigrations``
  (its ``TestCanI`` runs in ``test_torch_webhook.py``) and
  ``test_e2e::TestControllerE2E``. The one edit is the port's: a
  controller or policy cache on ``device="cpu"``. ``TestDeployManifests``
  reads ``deploy/``, which holds the JAX package's manifests, and is left
  out by name.
- Both packages on the same cluster contents: the webhook configurations
  a leader registers and narrows, the GenerateRequest state after
  ``process_gr``, the labels the migrations stamp, and the answers a
  controller serves on ``/validate`` over HTTP.
- The port's own: ``Controller()`` with no device runs on ``cuda`` and
  raises with no card, and the scan loop keeps a scan's exception
  (``last_scan_error``) and stays alive, where the JAX loop drops it.
"""

import copy
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from kyverno_tpu import server as jax_server
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.runtime import client as jax_client
from kyverno_tpu.runtime import generate_controller as jax_gc
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu.runtime import migrations as jax_migrations
from kyverno_tpu_torch import server as torch_server
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.runtime import client as torch_client
from kyverno_tpu_torch.runtime import generate_controller as torch_gc
from kyverno_tpu_torch.runtime import hostlane as torch_hostlane
from kyverno_tpu_torch.runtime import migrations as torch_migrations
from tests.torch_parity import mirror_battery
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

_CPU_CACHE = ("PolicyCache()", 'PolicyCache(device="cpu")')

# the JAX package's controller batteries, on the port
for _relpath, _subs, _drop in (
        ("tests/runtime/test_controller.py", (
            ("Controller(client=cluster, serve_port=0)",
             'Controller(client=cluster, serve_port=0, device="cpu")'),),
         ()),
        ("tests/runtime/test_leaderelection.py", (), ()),
        ("tests/runtime/test_webhook_narrowing.py", (
            ("Controller(client=cluster)",
             'Controller(client=cluster, device="cpu")'),), ()),
        ("tests/runtime/test_auth_migrations.py", (_CPU_CACHE,),
         # mirrored in test_torch_webhook.py
         ("TestCanI",)),
        ("tests/runtime/test_e2e.py", (
            ("Controller(client=cluster, serve_port=0)",
             'Controller(client=cluster, serve_port=0, device="cpu")'),),
         # the JAX package's deploy/ manifests
         ("TestDeployManifests",))):
    _exports = mirror_battery(_relpath, _subs, _drop)
    _clash = set(_exports) & set(globals())
    assert not _clash, (_relpath, _clash)
    globals().update(_exports)


@pytest.fixture(autouse=True)
def _detach_host_lane_pools():
    """A controller's webhook attaches its oracle pool to its package's
    process-wide host lane: detach both after each case."""
    yield
    for mod in (jax_hostlane, torch_hostlane):
        mod.resolver().attach_pool(None, None)


# ------------------------------------------------------------ the inputs

SEED = 20261018

POLICIES = [
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "disallow-latest-tag"},
     "spec": {"validationFailureAction": "enforce", "background": True,
              "rules": [{
                  "name": "validate-image-tag",
                  "match": {"resources": {"kinds": ["Pod"]}},
                  "validate": {"message": "latest tag not allowed",
                               "pattern": {"spec": {"containers": [
                                   {"image": "!*:latest"}]}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "require-team-label"},
     "spec": {"validationFailureAction": "enforce", "failurePolicy": "Ignore",
              "webhookTimeoutSeconds": 15,
              "rules": [{
                  "name": "team-label",
                  "match": {"resources": {"kinds": ["Service",
                                                    "apps/v1/Deployment"]}},
                  "validate": {"message": "a team label is required",
                               "pattern": {"metadata": {"labels": {
                                   "team": "?*"}}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "add-default-label"},
     "spec": {"rules": [{
         "name": "add-label",
         "match": {"resources": {"kinds": ["ConfigMap"]}},
         "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
             "managed": "kyverno"}}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "gen-np"},
     "spec": {"rules": [{
         "name": "gen-np-r",
         "match": {"resources": {"kinds": ["Namespace"]}},
         "generate": {"apiVersion": "networking.k8s.io/v1",
                      "kind": "NetworkPolicy", "name": "default-deny",
                      "namespace": "{{request.object.metadata.name}}",
                      "synchronize": True,
                      "data": {"spec": {"podSelector": {},
                                        "policyTypes": ["Ingress"]}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "clone-regcred"},
     "spec": {"rules": [{
         "name": "clone-r",
         "match": {"resources": {"kinds": ["Namespace"]}},
         "generate": {"apiVersion": "v1", "kind": "Secret",
                      "name": "regcred",
                      "namespace": "{{request.object.metadata.name}}",
                      "clone": {"namespace": "default",
                                "name": "regcred"}}}]}},
]


def _cluster_docs() -> list[dict]:
    """Stored objects for the migrations and the generate controller:
    two namespaces, a clone source, and GenerateRequests some of which
    already carry part of their labels."""
    docs = [copy.deepcopy(p) for p in POLICIES]
    docs += [{"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": ns, "labels": {"team": ns}}}
             for ns in ("team-a", "team-b")]
    docs.append({"apiVersion": "v1", "kind": "Secret",
                 "metadata": {"name": "regcred", "namespace": "default"},
                 "data": {"k": "dg=="}})
    for i, (pol, ns) in enumerate((("gen-np", "team-a"),
                                   ("clone-regcred", "team-b"),
                                   ("gen-np", "missing"),
                                   ("no-such-policy", "team-a"))):
        labels = ({"generate.kyverno.io/policy-name": pol} if i % 2
                  else None)
        meta = {"name": f"gr-{i}", "namespace": "kyverno"}
        if labels:
            meta["labels"] = labels
        docs.append({"apiVersion": "kyverno.io/v1", "kind": "GenerateRequest",
                     "metadata": meta,
                     "spec": {"policy": pol,
                              "resource": {"apiVersion": "v1",
                                           "kind": "Namespace", "name": ns,
                                           "namespace": ""}},
                     "status": {"state": "Pending"}})
    return docs


def _stripped(obj: dict) -> dict:
    """An object as both packages store it, without the fields each
    cluster stamps for itself (resource version, failure time)."""
    out = copy.deepcopy(obj)
    (out.get("metadata") or {}).pop("resourceVersion", None)
    (out.get("status") or {}).pop("failedAt", None)
    return out


def _listing(cluster, api: str, kind: str) -> list[dict]:
    return sorted((_stripped(o) for o in cluster.list_resource(api, kind)),
                  key=lambda o: json.dumps(o, sort_keys=True))


WEBHOOK_KINDS = ("MutatingWebhookConfiguration",
                 "ValidatingWebhookConfiguration")


def _controllers(docs):
    jc = jax_server.Controller(client=jax_client.FakeCluster(
        copy.deepcopy(docs)), serve_port=0)
    tc = torch_server.Controller(client=torch_client.FakeCluster(
        copy.deepcopy(docs)), serve_port=0, device="cpu")
    return jc, tc


def _stop(*controllers):
    """Stop each controller after its screen warm-up has finished (a
    warm-up still running when the batcher stops would raise on its
    own thread)."""
    for c in controllers:
        if c._warm_thread is not None:
            c._warm_thread.join(60.0)
        c.stop()


# ------------------------------------------------ both packages at once

@pytest.mark.parametrize("n_policies", [0, 1, 3, len(POLICIES)])
def test_registered_webhook_configurations_equal(n_policies):
    """A leader registers the five configurations, then narrows the two
    resource webhooks to the loaded policies: the stored objects are the
    JAX package's, field for field."""
    jc, tc = _controllers(POLICIES[:n_policies])
    try:
        got = []
        for c in (jc, tc):
            c.register.register()
            c.load_policies()
            assert c.register.check()
            got.append({k: _listing(c.client,
                                    "admissionregistration.k8s.io/v1", k)
                        for k in WEBHOOK_KINDS})
        assert got[0] == got[1]
        assert sum(len(v) for v in got[1].values()) == 5
    finally:
        _stop(jc, tc)


def test_policy_change_renarrows_webhooks_equally():
    """Policies created and deleted through each cluster's watch re-narrow
    the stored webhooks the same way in both packages."""
    jc, tc = _controllers([])
    try:
        states = [[], []]
        for step in range(len(POLICIES) + 1):
            for k, c in enumerate((jc, tc)):
                if step < len(POLICIES):
                    c.client.create_resource(copy.deepcopy(POLICIES[step]))
                else:
                    c.client.delete_resource("kyverno.io/v1", "ClusterPolicy",
                                             "", POLICIES[0]["metadata"]
                                             ["name"])
                states[k].append(
                    ([p.name for p in c.policy_cache.all_policies()],
                     {kind: _listing(c.client,
                                     "admissionregistration.k8s.io/v1", kind)
                      for kind in WEBHOOK_KINDS}))
        assert states[0] == states[1]
    finally:
        _stop(jc, tc)


def test_migrations_stamp_equal_labels():
    got = []
    for client_mod, mig in ((jax_client, jax_migrations),
                            (torch_client, torch_migrations)):
        cluster = client_mod.FakeCluster(_cluster_docs())
        counts = (mig.add_gr_labels(cluster), mig.add_clone_labels(cluster))
        mig.run_all(cluster)             # a second run changes nothing
        got.append((counts,
                    _listing(cluster, "kyverno.io/v1", "GenerateRequest"),
                    _listing(cluster, "v1", "Secret")))
    assert got[0] == got[1]
    assert got[1][0] == (4, 1)


@pytest.mark.parametrize("gr_index", [0, 1, 2, 3])
def test_generate_request_state_equal_after_process_gr(gr_index):
    """``process_gr`` on one stored GenerateRequest leaves the same GR
    status and the same generated objects in both packages: completed,
    cloned, trigger missing, policy missing."""
    got = []
    for client_mod, load, gc in ((jax_client, jax_load_policy, jax_gc),
                                 (torch_client, torch_load_policy, torch_gc)):
        cluster = client_mod.FakeCluster(_cluster_docs())
        policies = {p["metadata"]["name"]: load(copy.deepcopy(p))
                    for p in POLICIES}
        ctl = gc.GenerateController(cluster, policies, workers=1)
        gr = cluster.get_resource("kyverno.io/v1", "GenerateRequest",
                                  "kyverno", f"gr-{gr_index}")
        ctl.process_gr(gr)
        got.append((_stripped(cluster.get_resource(
                        "kyverno.io/v1", "GenerateRequest", "kyverno",
                        f"gr-{gr_index}")),
                    _listing(cluster, "networking.k8s.io/v1",
                             "NetworkPolicy"),
                    _listing(cluster, "v1", "Secret"),
                    ctl.synchronize()))
    assert got[0] == got[1]
    want = ("Completed", "Completed", "Failed", "Failed")[gr_index]
    assert got[1][0]["status"]["state"] == want


def _reviews(n: int = 12) -> list[dict]:
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(n):
        tag = ("latest", "1.21", "6.2")[int(rng.integers(3))]
        kind = ("Pod", "Service", "ConfigMap")[int(rng.integers(3))]
        labels = {"team": "a"} if rng.integers(2) else {}
        obj = {"apiVersion": "v1", "kind": kind,
               "metadata": {"name": f"r{i}", "namespace": "default",
                            "labels": labels}}
        if kind == "Pod":
            obj["spec"] = {"containers": [{"name": "c",
                                           "image": f"nginx:{tag}"}]}
        out.append({"apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview",
                    "request": {"uid": f"u{i}", "kind": {"kind": kind},
                                "namespace": "default",
                                "operation": "CREATE", "object": obj,
                                "userInfo": {"username": "alice"}}})
    return out


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_controller_serves_validate_equal_to_jax():
    """Both controllers, started on the same cluster contents, answer the
    same AdmissionReviews over HTTP with the same responses."""
    jc, tc = _controllers(POLICIES)
    try:
        for c in (jc, tc):
            c.start(host="127.0.0.1")
        reviews = _reviews()
        for c in (jc, tc):
            assert c._httpd is not None
        answers = [[_post(c._httpd.server_address[1], "/validate", r)
                    for r in reviews] for c in (jc, tc)]
        assert answers[0] == answers[1]
        allowed = [a["response"]["allowed"] for a in answers[1]]
        assert True in allowed and False in allowed
    finally:
        _stop(jc, tc)


def _scan_pods(n: int = 6) -> list[dict]:
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"scan-{i}", "namespace": ("default",
                                                            "team-a")[i % 2]},
             "spec": {"containers": [{"name": "c", "image": (
                 "nginx:latest", "nginx:1.21")[i % 3 == 0]}]}}
            for i in range(n)]


def test_controller_scan_reports_equal_to_jax():
    """Each package's leader scans the same stored Pods and aggregates
    its change requests through the cluster (each consumed CR deleted, a
    watch event its controller prunes on); then a Pod and a policy are
    deleted and the next scan aggregates again. The stored reports, and
    the change requests left, are the JAX package's after each step."""
    docs = [copy.deepcopy(POLICIES[0]), copy.deepcopy(POLICIES[1])] \
        + _scan_pods()
    jc, tc = _controllers(docs)
    try:
        states = [[], []]
        for k, c in enumerate((jc, tc)):
            c.load_policies()
            for step in range(3):
                if step == 1:
                    c.client.delete_resource("v1", "Pod", "team-a", "scan-1")
                elif step == 2:
                    c.client.delete_resource("kyverno.io/v1", "ClusterPolicy",
                                             "", "require-team-label")
                result = c.run_background_scan()
                c.report_gen.flush(timeout_s=10.0)
                states[k].append((
                    result.resources_scanned, result.violations,
                    [_listing(c.client, "wgpolicyk8s.io/v1alpha2", kind)
                     for kind in ("PolicyReport", "ClusterPolicyReport",
                                  "ReportChangeRequest")]))
        for a, b in zip(*states):
            assert a[:2] == b[:2]
            strip = [[{k: v for k, v in r.items() if k != "results"}
                      for r in kind] for kind in a[2]]
            assert strip == [[{k: v for k, v in r.items() if k != "results"}
                              for r in kind] for kind in b[2]]
            for ka, kb in zip(a[2], b[2]):
                for ra, rb in zip(ka, kb):
                    assert ([{k: v for k, v in x.items()
                              if k != "timestamp"} for x in ra["results"]]
                            == [{k: v for k, v in x.items()
                                 if k != "timestamp"}
                                for x in rb["results"]])
        assert states[1][0][1] > 0 and states[1][2][2][0]
    finally:
        _stop(jc, tc)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fake_cluster_lists_equal_to_jax(seed):
    """Both packages' FakeCluster after the same seeded creates, updates
    (conflicts included) and deletes list every kind, in every namespace
    and across them, the same objects in the same order."""
    rng = np.random.default_rng(seed)
    kinds = ("Pod", "ConfigMap", "ReportChangeRequest", "Event")
    clusters = [jax_client.FakeCluster(), torch_client.FakeCluster()]
    for _ in range(300):
        op = int(rng.integers(3))
        kind = kinds[int(rng.integers(len(kinds)))]
        ns = ("", "a", "b")[int(rng.integers(3))]
        obj = {"apiVersion": "v1", "kind": kind,
               "metadata": {"name": f"o{int(rng.integers(12))}",
                            "namespace": ns},
               "data": {"v": int(rng.integers(1000))}}
        outs = []
        for c, mod in zip(clusters, (jax_client, torch_client)):
            try:
                if op == 0:
                    c.create_resource(copy.deepcopy(obj))
                elif op == 1:
                    c.update_resource(copy.deepcopy(obj))
                else:
                    c.delete_resource("v1", kind, ns,
                                      obj["metadata"]["name"])
                outs.append("ok")
            except mod.ConflictError:
                outs.append("conflict")
        assert outs[0] == outs[1]
    for kind in kinds:
        for ns in ("", "a", "b"):
            assert (clusters[0].list_resource("v1", kind, ns)
                    == clusters[1].list_resource("v1", kind, ns))
        assert clusters[1].list_resource("v1", kind)


# --------------------------------------------------------- the port's own

@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_controller_without_a_device_raises_with_no_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_server.Controller(client=torch_client.FakeCluster())


def test_controller_places_its_planes_on_the_device():
    tc = torch_server.Controller(client=torch_client.FakeCluster(
        copy.deepcopy(POLICIES[:1])), device="cpu")
    try:
        assert tc.device == torch.device("cpu")
        assert tc.policy_cache.device == torch.device("cpu")
        assert tc.webhook.policy_cache is tc.policy_cache
        tc.load_policies()
        result = tc.run_background_scan()
        assert (tc.last_scan, tc.last_scan_error) == (result, None)
    finally:
        _stop(tc)


def _wait_for(cond, timeout_s: float = 30.0) -> bool:
    """Poll ``cond`` until it holds: the wait is for the scan thread's
    work, not for a lease or a monitor tick."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def test_scan_loop_keeps_a_scans_exception_and_stays_alive():
    tc = torch_server.Controller(client=torch_client.FakeCluster(
        copy.deepcopy(POLICIES[:1])), device="cpu")
    calls = []
    done = threading.Event()

    def flaky_scan():
        calls.append(len(calls))
        if len(calls) == 1:
            raise ValueError("scan failed on the device")
        done.set()
        return None

    tc.run_background_scan = flaky_scan
    try:
        assert tc.elector.try_acquire_or_renew()   # leads: starts the loop
        assert tc.register.check()
        tc._scan_kick.set()
        assert _wait_for(lambda: tc.last_scan_error is not None)
        assert isinstance(tc.last_scan_error, ValueError)
        assert tc._scan_thread.is_alive()
        tc._scan_kick.set()
        assert done.wait(30.0)
        assert calls == [0, 1]
        assert tc._scan_thread.is_alive()
    finally:
        _stop(tc)
    tc._scan_thread.join(10.0)
    assert not tc._scan_thread.is_alive()


def test_jax_scan_loop_drops_the_exception():
    """The difference, held on the JAX side too: its loop keeps no error."""
    jc = jax_server.Controller(client=jax_client.FakeCluster(
        copy.deepcopy(POLICIES[:1])))
    calls = []

    def failing_scan():
        calls.append(1)
        raise ValueError("scan failed")

    jc.run_background_scan = failing_scan
    try:
        assert jc.elector.try_acquire_or_renew()
        jc._scan_kick.set()
        assert _wait_for(lambda: len(calls) == 1)
        jc._scan_kick.set()
        assert _wait_for(lambda: len(calls) == 2)
        assert not hasattr(jc, "last_scan_error")
    finally:
        _stop(jc)
