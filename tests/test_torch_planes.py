"""The planes the webhook imports, on the port: ``workqueue``, ``metrics``,
``tracing`` (its metrics feed, exports and traceparent), ``slo``,
``sloactions``, ``obs_http``, ``watch``, ``client``, ``ResourceCache``,
``config``, ``userinfo``, ``events``, ``auth`` and ``profiling``.

Two kinds of test:

- The JAX package's batteries, case by case, on the port: each battery's
  source with its imports pointed at ``kyverno_tpu_torch``
  (``torch_parity.mirror_battery``). The JAX side of each case is the
  battery itself, which runs from its own file. The only edits are the
  port's deliberate differences: a policy cache on ``device="cpu"``, the
  cold flush's span (``cold_dispatch``, not ``xla_compile``) and the
  build-info gauge's engine label.
- Both packages on the same inputs: the metrics exposition text after
  the same calls (byte for byte but for the build-info and reset-time
  lines), traceparents minted by one package and read by the other,
  ``ConfigData`` filters, ``build_request_info``,
  ``events_for_engine_response`` and ``can_i_generate``.
"""

import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.engine.response import (
    EngineResponse as JaxEngineResponse,
    PolicyResponse as JaxPolicyResponse,
    PolicySpecSummary as JaxPolicySpecSummary,
    ResourceSpec as JaxResourceSpec,
    RuleResponse as JaxRuleResponse,
    RuleStatus as JaxRuleStatus,
    RuleType as JaxRuleType,
)
from kyverno_tpu.runtime import auth as jax_auth
from kyverno_tpu.runtime import client as jax_client
from kyverno_tpu.runtime import config as jax_config
from kyverno_tpu.runtime import events as jax_events
from kyverno_tpu.runtime import metrics as jax_metrics
from kyverno_tpu.runtime import tracing as jax_tracing
from kyverno_tpu.runtime import userinfo as jax_userinfo
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.engine.response import (
    EngineResponse as TorchEngineResponse,
    PolicyResponse as TorchPolicyResponse,
    PolicySpecSummary as TorchPolicySpecSummary,
    ResourceSpec as TorchResourceSpec,
    RuleResponse as TorchRuleResponse,
    RuleStatus as TorchRuleStatus,
    RuleType as TorchRuleType,
)
from kyverno_tpu_torch.runtime import auth as torch_auth
from kyverno_tpu_torch.runtime import client as torch_client
from kyverno_tpu_torch.runtime import config as torch_config
from kyverno_tpu_torch.runtime import events as torch_events
from kyverno_tpu_torch.runtime import metrics as torch_metrics
from kyverno_tpu_torch.runtime import tracing as torch_tracing
from kyverno_tpu_torch.runtime import userinfo as torch_userinfo
from tests.torch_parity import mirror_battery
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

_CPU_CACHE = ("PolicyCache()", 'PolicyCache(device="cpu")')

# the JAX batteries, on the port
for _relpath, _subs, _drop in (
        ("tests/runtime/test_workqueue.py", (), ()),
        ("tests/runtime/test_sloactions.py", (), ()),
        ("tests/runtime/test_obs_plane.py", (), ()),
        ("tests/runtime/test_tracing.py", (
            _CPU_CACHE,
            ('("xla_compile" in names)', '("cold_dispatch" in names)'),
            ("'engine=\"jax\"'", "'engine=\"torch\"'")), ()),
        ("tests/runtime/test_resourcecache.py", (_CPU_CACHE,), ()),
        ("tests/runtime/test_watch_unit.py", (), ())):
    _exports = mirror_battery(_relpath, _subs, _drop)
    _clash = set(_exports) & set(globals())
    assert not _clash, (_relpath, _clash)
    globals().update(_exports)


# ------------------------------------------------ both packages at once

def _exposition(metrics_mod) -> str:
    """The same calls into each package's metrics registry, then
    the exposition text without the lines that differ by construction
    (the build-info gauge names the engine, the reset stamp the time)."""
    reg = metrics_mod.MetricsRegistry()
    metrics_mod.record_policy_results(reg, "p", "r", "fail",
                                      resource_kind="Pod",
                                      request_operation="CREATE")
    metrics_mod.record_admission_request(reg, "CREATE", "Pod", False)
    metrics_mod.record_admission_review_duration(reg, "CREATE", "Pod", 0.003)
    metrics_mod.record_flush_batch(reg, 16, host_resolved=3)
    metrics_mod.record_screen_escalation(reg, "device_fail", 2)
    metrics_mod.record_flatten_rows(reg, hits=5, misses=11)
    metrics_mod.record_host_lane(reg, prefetch_cells=4, memo_hits=2,
                                 memo_misses=7, overlap_s=0.01)
    metrics_mod.record_queue_shed(reg, "audit", "slo")
    metrics_mod.record_events(reg, emitted=3, dropped=1)
    metrics_mod.record_report_queue_depth(reg, queued=2, pending=9)
    metrics_mod.record_device_memory(reg, {"bytes_in_use": 1024,
                                           "bytes_limit": 4096})
    metrics_mod.record_xla_compile(reg, 0.25, what="eval_rules")
    metrics_mod.record_stage_duration(reg, "flatten", 0.0004, kind="flush")
    metrics_mod.record_slo_gauges(reg, 0.01, 0.02, 0.5, 0.25, 0.1, 0.5,
                                  False, 10.0)
    metrics_mod.record_mesh_shard_rules(reg, {0: 3, 1: 4})
    metrics_mod.record_policy_compile(reg, 0.5, "incremental")
    reg.inc_counter("kyverno_custom_total", {"a": 'x"y\\z'})
    lines = reg.expose().splitlines()
    return "\n".join(ln for ln in lines if not ln.startswith((
        "kyverno_tpu_build_info", "kyverno_metrics_last_reset")))


def test_metrics_exposition_equal_byte_for_byte():
    jax_text = _exposition(jax_metrics)
    torch_text = _exposition(torch_metrics)
    assert "kyverno_device_memory_bytes" in torch_text
    assert torch_text == jax_text


def test_build_info_names_the_engine():
    assert 'engine="torch"' in torch_metrics.MetricsRegistry().expose()
    assert 'engine="jax"' in jax_metrics.MetricsRegistry().expose()


def test_fleet_snapshot_is_off_in_the_port():
    assert torch_metrics.fleet_snapshot() == {"enabled": False}


@pytest.mark.parametrize("mint,read", [(jax_tracing, torch_tracing),
                                       (torch_tracing, jax_tracing)])
def test_traceparent_crosses_packages(mint, read):
    """A traceparent minted by either package reads back, in the other,
    as the minting trace's id; a foreign W3C id passes through."""
    tr = mint.TraceRecorder().start("admission")
    tp = mint.make_traceparent(tr)
    assert read.parse_traceparent(tp) == tr.trace_id
    foreign = "00-" + "0af7651916cd43dd8448eb211c80319c" + "-b7ad6b7169203331-01"
    assert (read.parse_traceparent(foreign)
            == mint.parse_traceparent(foreign))
    for bad in ("", "00-xyz-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01"):
        assert read.parse_traceparent(bad) is None


def test_chrome_trace_shapes_match():
    out = []
    for tracing_mod in (jax_tracing, torch_tracing):
        rec = tracing_mod.TraceRecorder()
        tr = rec.start("flush", batch=4)
        rec.add_span(tr, "flatten", 1.0, 1.5, lane="memo")
        rec.add_span(tr, "device_dispatch", 1.5, 1.75)
        rec.finish(tr)
        ev = rec.chrome_trace(4)["traceEvents"]
        out.append([(e["name"].split(":")[0], e["ph"], e["cat"], e["args"])
                    for e in ev])
    assert out[0] == out[1]


_FILTER_CASES = [
    ("[Event,*,*][*,kube-system,*][Pod,default,bad-*]", ("Pod", "default",
                                                          "bad-1")),
    ("[Event,*,*][*,kube-system,*][Pod,default,bad-*]", ("Pod", "default",
                                                          "good")),
    ("[Event,*,*]", ("Event", "x", "y")),
    ("[Node]", ("Node", "", "n1")),
    ("", ("Pod", "kyverno", "x")),
    ("[*,kube-system,*]", ("Secret", "kube-system", "s")),
]


@pytest.mark.parametrize("raw,target", _FILTER_CASES)
def test_config_filters_equal(raw, target):
    data = {"resourceFilters": raw,
            "excludeGroupRole": "system:masters, ops",
            "excludeUsername": "admin,bot",
            "generateSuccessEvents": "true",
            "webhooks": '[{"namespaceSelector": {"matchLabels": {"a": "b"}}}]'}
    got = []
    for mod in (jax_config, torch_config):
        cfg = mod.ConfigData(data)
        got.append((cfg.to_filter(*target), cfg.get_exclude_group_role(),
                    cfg.get_exclude_username(),
                    cfg.generate_success_events(),
                    [w.namespace_selector for w in cfg.get_webhooks()],
                    [tuple(vars(f).values()) if hasattr(f, "__dict__")
                     else (f.kind, f.namespace, f.name)
                     for f in mod.parse_kinds(raw)]))
    assert got[0] == got[1]


def _rbac_cluster(client_mod):
    return client_mod.FakeCluster([
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
         "metadata": {"name": "rb1", "namespace": "dev"},
         "subjects": [{"kind": "User", "name": "alice"}],
         "roleRef": {"kind": "Role", "name": "editor"}},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
         "metadata": {"name": "rb2", "namespace": "ops"},
         "subjects": [{"kind": "Group", "name": "oncall"}],
         "roleRef": {"kind": "ClusterRole", "name": "view"}},
        {"apiVersion": "rbac.authorization.k8s.io/v1",
         "kind": "ClusterRoleBinding", "metadata": {"name": "crb"},
         "subjects": [{"kind": "ServiceAccount", "name": "ci",
                       "namespace": "build"}],
         "roleRef": {"kind": "ClusterRole", "name": "admin"}},
    ])


@pytest.mark.parametrize("user", [
    {"username": "alice", "groups": []},
    {"username": "bob", "groups": ["oncall"]},
    {"username": "system:serviceaccount:build:ci", "uid": "u1"},
    {"username": "nobody"},
    {},
])
def test_build_request_info_equal(user):
    got = []
    for client_mod, ui in ((jax_client, jax_userinfo),
                           (torch_client, torch_userinfo)):
        info = ui.build_request_info(_rbac_cluster(client_mod), user)
        got.append((info.roles, info.cluster_roles,
                    info.admission_user_info.username,
                    info.admission_user_info.uid,
                    list(info.admission_user_info.groups)))
    assert got[0] == got[1]


@pytest.mark.parametrize("success_events", [False, True])
def test_events_for_engine_response_equal(success_events):
    got = []
    for (er, pr, ps, rs, rr, st, rt, mod) in (
            (JaxEngineResponse, JaxPolicyResponse, JaxPolicySpecSummary,
             JaxResourceSpec, JaxRuleResponse, JaxRuleStatus, JaxRuleType,
             jax_events),
            (TorchEngineResponse, TorchPolicyResponse, TorchPolicySpecSummary,
             TorchResourceSpec, TorchRuleResponse, TorchRuleStatus,
             TorchRuleType, torch_events)):
        resp = er(policy_response=pr(
            policy=ps(name="pol"),
            resource=rs(kind="Pod", api_version="v1", namespace="ns",
                        name="web")))
        for name, status in (("a", st.FAIL), ("b", st.PASS),
                             ("c", st.SKIP), ("d", st.ERROR)):
            resp.policy_response.rules.append(rr(
                name=name, type=rt.VALIDATION, status=status,
                message=f"{name} said so"))
        got.append([vars(e) for e in mod.events_for_engine_response(
            resp, success_events)])
    assert got[0] == got[1] and got[0]


def test_event_generator_writes_equal_events():
    got = []
    for client_mod, mod in ((jax_client, jax_events),
                            (torch_client, torch_events)):
        cluster = client_mod.FakeCluster()
        gen = mod.EventGenerator(cluster, workers=1)
        gen.run()
        gen.add(mod.EventInfo(kind="Pod", name="web", namespace="ns",
                              reason=mod.POLICY_VIOLATION, message="m"),
                mod.EventInfo(kind="Pod", name="", namespace="ns"))
        gen.drain()
        gen.stop()
        events = cluster.list_resource("v1", "Event")
        got.append([{k: v for k, v in e.items() if k != "metadata"}
                    for e in events])
    assert got[0] == got[1] and len(got[0]) == 1


_GEN_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "gen-np"},
    "spec": {"rules": [{
        "name": "gen-np-r",
        "match": {"resources": {"kinds": ["Namespace"]}},
        "generate": {"apiVersion": "networking.k8s.io/v1",
                     "kind": "NetworkPolicy", "name": "default-deny",
                     "namespace": "{{request.object.metadata.name}}",
                     "data": {"spec": {"podSelector": {}}}},
    }, {
        "name": "gen-policy-r",
        "match": {"resources": {"kinds": ["Namespace"]}},
        "generate": {"apiVersion": "v1", "kind": "NetworkPolicy",
                     "name": "x", "namespace": "fixed",
                     "data": {}},
    }]},
}


@pytest.mark.parametrize("denied", [(), (("create", "networkpolicies"),),
                                    (("get", "networkpolicies"),
                                     ("delete", "networkpolicies"))])
def test_can_i_generate_equal(denied):
    got = []
    for client_mod, auth_mod, load in (
            (jax_client, jax_auth, jax_load_policy),
            (torch_client, torch_auth, torch_load_policy)):
        cluster = client_mod.FakeCluster()
        cluster.deny_access.update(denied)
        got.append(auth_mod.can_i_generate(load(_GEN_POLICY), cluster))
    assert got[0] == got[1]
    assert bool(got[0]) == bool(denied)


@pytest.mark.parametrize("kind", ["Pod", "Policy", "Ingress", "Box",
                                  "NetworkPolicy", "Gateway", "Mesh"])
def test_pluralize_is_the_webhookconfig_one(kind):
    from kyverno_tpu.runtime.webhookconfig import _pluralize

    assert torch_auth._pluralize(kind) == _pluralize(kind)
