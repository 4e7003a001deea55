"""The background scan path on both packages: ``BackgroundScanner`` and
``ReportGenerator``.

The same policies and seeded resources go through the JAX package's
scanner and the port's (on the CPU) in every lane of ``scan`` — the
incremental lane (chunked too), ``single``, ``pipelined`` and
``serial_chunks`` with ``KTPU_INCREMENTAL=0``, and the 1D and 2D mesh
lanes — and the ``(policy, resource, rule, status)`` responses, the
``ScanResult`` fields and the aggregated reports (timestamps left out)
must be equal. ``delta_scan`` after a policy update and watch events
keeps a ``verdict_matrix()`` equal to the JAX scanner's and to a fresh
full scan's, and the same ``state_fingerprint()``. Mirrors
tests/runtime/test_incremental_compile.py:179-235,
tests/runtime/test_runtime.py:290-320 and
tests/runtime/test_flatten_pipeline.py:333.
"""

import copy

import numpy as np
import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.parallel import make_mesh as jax_make_mesh
from kyverno_tpu.parallel import mesh as jax_mesh_mod
from kyverno_tpu.runtime.background import BackgroundScanner as JaxScanner
from kyverno_tpu.runtime.client import FakeCluster as JaxFakeCluster
from kyverno_tpu.runtime.hostlane import host_cache as jax_host_cache
from kyverno_tpu.runtime.reports import ReportGenerator as JaxReports
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.parallel import make_mesh
from kyverno_tpu_torch.parallel import mesh as mesh_mod
from kyverno_tpu_torch.runtime import hostlane
from kyverno_tpu_torch.runtime.background import BackgroundScanner
from kyverno_tpu_torch.runtime.client import FakeCluster
from kyverno_tpu_torch.runtime.reports import ReportGenerator
from tests.torch_parity import corpus_docs, corpus_resources
from tests.torch_parity import one_torch_thread  # noqa: F401

CPU8 = ["cpu"] * 8

PATTERN_POOL = [
    {"spec": {"containers": [{"image": "!*:latest"}]}},
    {"spec": {"containers": [{"image": "!*:dev"}]}},
    {"spec": {"weight": "<=100"}},
    {"spec": {"weight": ">10"}},
    {"spec": {"grace": "<1h"}},
    {"metadata": {"name": "pod-?*"}},
    {"metadata": {"labels": {"idx": "?*"}}},
    {"spec": {"containers": [{"name": "c?*"}]}},
]


def _doc(name, pattern, background=True):
    spec = {"validationFailureAction": "enforce", "rules": [{
        "name": "r",
        "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {"message": "m", "pattern": pattern},
    }]}
    if background is not None:
        spec["background"] = background
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name}, "spec": spec}


HOST_DOC = _doc("self-name",
                {"metadata": {"name": "{{request.object.metadata.name}}"}})


def _pod(i):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"pod-{i}", "namespace": "default",
                         "labels": {"idx": str(i)}},
            "spec": {"containers": [{"name": f"c{i}",
                                     "image": ("nginx:latest" if i % 3 == 0
                                               else f"nginx:1.{i}")}],
                     "weight": (i * 7) % 160,
                     "grace": f"{(i * 13) % 400}s"}}


def _load(docs):
    return ([jax_load_policy(d) for d in docs],
            [torch_load_policy(d) for d in docs])


def _rows(result) -> list:
    return sorted(
        (r.policy_response.policy.name, r.policy_response.resource.kind,
         r.policy_response.resource.namespace,
         r.policy_response.resource.name,
         tuple((x.name, x.status.value, x.message)
               for x in r.policy_response.rules))
        for r in result.responses)


def _fields(result) -> tuple:
    return (result.resources_scanned, result.rules_evaluated,
            result.violations, result.delta, result.cols_evaluated,
            result.rows_evaluated, len(result.responses))


def _reports(gen) -> list:
    """aggregate() with the reference's second-resolution timestamps left
    out."""
    return [{**rep, "results": [{k: v for k, v in r.items()
                                 if k != "timestamp"}
                                for r in rep["results"]]}
            for rep in gen.aggregate()]


def _assert_same_scan(got, want):
    assert _fields(got) == _fields(want)
    assert _rows(got) == _rows(want)


def _assert_same_matrix(sc, jsc):
    (k, c, m), (jk, jc, jm) = sc.verdict_matrix(), jsc.verdict_matrix()
    assert k == jk and c == jc
    assert m.dtype == jm.dtype == np.int8
    np.testing.assert_array_equal(m, jm)


@pytest.fixture(autouse=True)
def _fresh_host_memo():
    hostlane.host_cache().clear()
    jax_host_cache().clear()
    yield
    hostlane.host_cache().clear()


@pytest.fixture(scope="module")
def library():
    """60 policies of the 250-policy library (one host-only rule among
    them) and 48 mixed resources."""
    docs = corpus_docs("library250")[:60]
    return docs, corpus_resources("library250", 48)


# ------------------------------------------------------------ scan lanes

LANES = {
    # lane: (environment, port mesh, JAX mesh, chunk size)
    "incremental": ({}, None, None, None),
    "incremental_chunked": ({}, None, None, 16),
    "single": ({"KTPU_INCREMENTAL": "0"}, None, None, None),
    "pipelined": ({"KTPU_INCREMENTAL": "0"}, None, None, 16),
    "serial_chunks": ({"KTPU_INCREMENTAL": "0",
                       "KTPU_FLATTEN_PIPELINE": "0"}, None, None, 16),
    "mesh1d": ({}, lambda: make_mesh(CPU8), lambda: jax_make_mesh(), None),
    "mesh2d": ({}, lambda: make_mesh(CPU8, shape=(2, 4)),
               lambda: jax_make_mesh(shape=(2, 4)), None),
}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_scan_lane_matches_jax(monkeypatch, library, lane):
    env, mesh, jmesh, chunk = LANES[lane]
    monkeypatch.delenv("KTPU_MESH_SHAPE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if chunk is not None:
        monkeypatch.setattr(mesh_mod, "DEFAULT_CHUNK", chunk)
        monkeypatch.setattr(jax_mesh_mod, "DEFAULT_CHUNK", chunk)
    docs, resources = library
    jpol, tpol = _load(docs)
    jrep, trep = JaxReports(), ReportGenerator()
    jsc = JaxScanner(jpol, report_gen=jrep,
                     mesh=jmesh() if jmesh else None)
    sc = BackgroundScanner(tpol, report_gen=trep,
                           mesh=mesh() if mesh else None, device="cpu")
    want = jsc.scan(resources)
    got = sc.scan(resources)
    _assert_same_scan(got, want)
    assert got.violations > 0 and got.rules_evaluated > got.violations
    assert _reports(trep) == _reports(jrep)
    stateful = env.get("KTPU_INCREMENTAL") != "0" and mesh is None
    assert (sc.verdict_matrix() is not None) == stateful
    if stateful:
        _assert_same_matrix(sc, jsc)
        assert sc.state_fingerprint() == jsc.state_fingerprint()
    assert sc.kinds() == jsc.kinds()


def test_scan_snapshot_through_a_client(library):
    docs, resources = library
    jpol, tpol = _load(docs)
    sc = BackgroundScanner(tpol, client=FakeCluster(copy.deepcopy(resources)),
                           device="cpu")
    jsc = JaxScanner(jpol, client=JaxFakeCluster(copy.deepcopy(resources)))
    assert "Pod" in sc.kinds()
    got, want = sc.scan(), jsc.scan()
    assert got.resources_scanned > 0
    _assert_same_scan(got, want)
    assert BackgroundScanner(tpol, device="cpu").snapshot() == []


def test_background_false_policies_excluded():
    _, tpol = _load([_doc("off", PATTERN_POOL[0], background=False),
                     _doc("on", PATTERN_POOL[2])])
    sc = BackgroundScanner(tpol, device="cpu")
    assert [p.name for p in sc.policies] == ["on"]


def test_scan_of_no_resources():
    _, tpol = _load([_doc("a", PATTERN_POOL[0])])
    sc = BackgroundScanner(tpol, device="cpu")
    r = sc.scan([])
    assert (r.resources_scanned, r.rules_evaluated, r.responses) == (0, 0, [])
    assert sc.verdict_matrix()[0] == []


# ------------------------------------------------------------ delta scan

def test_delta_scan_matches_jax_and_a_full_rescan():
    """Policy churn then resource churn, on both packages: delta_scan's
    persisted verdict matrix stays equal to the JAX scanner's and to a
    from-scratch scanner's, while evaluating only the changed columns and
    the dirty rows; the reports prune the deleted resource and the
    dropped policy."""
    p1 = [_doc("a", PATTERN_POOL[0]), _doc("b", PATTERN_POOL[2]),
          _doc("c", PATTERN_POOL[4]), HOST_DOC]
    docs = [_pod(i) for i in range(10)]
    jpol, tpol = _load(p1)
    jrep, trep = JaxReports(), ReportGenerator()
    jsc = JaxScanner(jpol, report_gen=jrep)
    sc = BackgroundScanner(tpol, report_gen=trep, device="cpu")
    _assert_same_scan(sc.scan(docs), jsc.scan(docs))
    assert sc.state_fingerprint() == jsc.state_fingerprint()

    p2_docs = [_doc("b", {"spec": {"weight": "<=50",
                                   "newdeep": {"x": "?*"}}}),
               _doc("d", PATTERN_POOL[5])]
    jnew, tnew = _load(p2_docs)
    r1 = sc.delta_scan([tpol[0], tnew[0], tnew[1], tpol[3]])
    j1 = jsc.delta_scan([jpol[0], jnew[0], jnew[1], jpol[3]])
    assert r1.delta and r1.cols_evaluated == 2 and r1.rows_evaluated == 0
    _assert_same_scan(r1, j1)
    _assert_same_matrix(sc, jsc)
    assert sc.state_fingerprint() == jsc.state_fingerprint()
    assert _reports(trep) == _reports(jrep)

    _, tref_pol = _load(p1[:1] + p2_docs + [HOST_DOC])
    ref = BackgroundScanner(tref_pol, device="cpu")
    ref.scan(docs)
    k_a, c_a, m_a = sc.verdict_matrix()
    k_b, c_b, m_b = ref.verdict_matrix()
    assert k_a == k_b and c_a == c_b
    np.testing.assert_array_equal(m_a, m_b)

    mod = _pod(1)
    mod["spec"]["weight"] = 155
    for scanner in (sc, jsc):
        scanner.note_resource("MODIFIED", copy.deepcopy(mod))
        scanner.note_resource("DELETED", _pod(2))
        scanner.note_resource("ADDED", _pod(99))
    r2, j2 = sc.delta_scan(), jsc.delta_scan()
    assert r2.cols_evaluated == 0 and r2.rows_evaluated == 2
    _assert_same_scan(r2, j2)
    _assert_same_matrix(sc, jsc)
    assert sc.state_fingerprint() == jsc.state_fingerprint()
    assert _reports(trep) == _reports(jrep)
    assert not any(r["resources"][0]["name"] == "pod-2"
                   for rep in _reports(trep) for r in rep["results"])
    assert not any(r["policy"] == "c"
                   for rep in _reports(trep) for r in rep["results"])

    docs2 = [mod if d["metadata"]["name"] == "pod-1" else d
             for d in docs if d["metadata"]["name"] != "pod-2"]
    docs2.append(_pod(99))
    ref2 = BackgroundScanner(tref_pol, device="cpu")
    ref2.scan(docs2)
    k_a, c_a, m_a = sc.verdict_matrix()
    k_b, c_b, m_b = ref2.verdict_matrix()
    assert c_a == c_b and set(k_a) == set(k_b)
    perm = [k_a.index(k) for k in k_b]
    np.testing.assert_array_equal(m_a[perm], m_b)
    assert sc.delta_stats == jsc.delta_stats


def test_kill_switch_falls_back_to_a_full_scan(monkeypatch):
    monkeypatch.setenv("KTPU_INCREMENTAL", "0")
    jpol, tpol = _load([_doc("a", PATTERN_POOL[0])])
    sc = BackgroundScanner(tpol, device="cpu")
    jsc = JaxScanner(jpol)
    pods = [_pod(i) for i in range(4)]
    sc.scan(pods)
    jsc.scan(pods)
    assert sc.verdict_matrix() is None
    r, j = sc.delta_scan(), jsc.delta_scan()
    assert not r.delta and not j.delta
    assert _fields(r) == _fields(j)
    assert sc.state_fingerprint() == jsc.state_fingerprint()


def test_delta_scan_under_a_mesh_is_a_full_scan():
    jpol, tpol = _load([_doc("a", PATTERN_POOL[0]), HOST_DOC])
    sc = BackgroundScanner(tpol, mesh=make_mesh(CPU8, shape=(2, 4)))
    jsc = JaxScanner(jpol, mesh=jax_make_mesh(shape=(2, 4)))
    pods = [_pod(i) for i in range(5)]
    sc.scan(pods)
    jsc.scan(pods)
    sc.note_resource("ADDED", _pod(7))
    jsc.note_resource("ADDED", _pod(7))
    r, j = sc.delta_scan(), jsc.delta_scan()
    assert not r.delta and r.resources_scanned == 0
    assert _fields(r) == _fields(j)
    assert sc.device.type == "cpu"


def test_env_mesh_on_the_cpu(monkeypatch):
    monkeypatch.setenv("KTPU_MESH_SHAPE", "1d")
    _, tpol = _load([_doc("a", PATTERN_POOL[0])])
    sc = BackgroundScanner(tpol, device="cpu")
    assert sc.mesh is not None and sc.mesh.devices.shape == (1,)
    got = sc.scan([_pod(i) for i in range(3)])
    assert got.violations == 1


# --------------------------------------------------------------- reports

def _add_both(responses_of, gens):
    for gen, responses in zip(gens, responses_of):
        gen.add(*responses)


def test_prune_policy_and_resource_match_jax(library):
    docs, resources = library
    jpol, tpol = _load(docs[:20])
    jrep, trep = JaxReports(), ReportGenerator()
    jres = JaxScanner(jpol).scan(resources).responses
    tres = BackgroundScanner(tpol, device="cpu").scan(resources).responses
    gens = (trep, jrep)
    _add_both((tres, jres), gens)
    assert _reports(trep) == _reports(jrep)
    policy = tres[0].policy_response.policy.name
    res = tres[-1].policy_response.resource
    for gen in gens:
        gen.prune_policy(policy)
        gen.prune_resource(res.kind, res.namespace, res.name)
    got = _reports(trep)
    assert got == _reports(jrep)
    assert not any(r["policy"] == policy for rep in got for r in rep["results"])
    # results not consumed yet are pruned as well
    _add_both((tres, jres), gens)
    for gen in gens:
        gen.prune_policy(policy)
    assert _reports(trep) == _reports(jrep)
    for gen in gens:
        gen.reconcile()
    assert _reports(trep) == _reports(jrep)
    assert all(rep["results"] == [] for rep in _reports(trep))


def test_reports_through_a_cluster_client(library):
    """The change requests go through the writer thread into the cluster;
    aggregate() consumes and deletes them and writes the reports."""
    docs, resources = library
    jpol, tpol = _load(docs[:20])
    tres = BackgroundScanner(tpol, device="cpu").scan(resources[:12]).responses
    jres = JaxScanner(jpol).scan(resources[:12]).responses
    clusters = (FakeCluster(), JaxFakeCluster())
    trep, jrep = (ReportGenerator(client=clusters[0]),
                  JaxReports(client=clusters[1]))
    try:
        assert trep.persist_requests
        _add_both((tres, jres), (trep, jrep))
        assert trep.flush(timeout_s=10.0) and jrep.flush(timeout_s=10.0)
        for cluster in clusters:
            assert cluster.list_resource("kyverno.io/v1alpha2",
                                         "ClusterReportChangeRequest")
        assert _reports(trep) == _reports(jrep)
        for cluster in clusters:
            for kind in ("ReportChangeRequest", "ClusterReportChangeRequest"):
                assert cluster.list_resource("kyverno.io/v1alpha2", kind) == []
        stored = clusters[0].list_resource("wgpolicyk8s.io/v1alpha2",
                                           "ClusterPolicyReport")
        assert len(stored) == 1 and stored[0]["summary"] == \
            clusters[1].list_resource("wgpolicyk8s.io/v1alpha2",
                                      "ClusterPolicyReport")[0]["summary"]
    finally:
        trep.stop()
        jrep.stop()
    assert trep._writer is None or not trep._writer.is_alive()


def test_resource_manager_dedups_like_jax(monkeypatch):
    from kyverno_tpu.runtime.background import ResourceManager as JaxManager
    from kyverno_tpu_torch.runtime.background import ResourceManager

    clock = [100.0]
    monkeypatch.setattr("time.monotonic", lambda: clock[0])
    got, want = ResourceManager(ttl_s=10.0), JaxManager(ttl_s=10.0)
    steps = [("p", "Pod", "ns", "a", "1", 0.0), ("p", "Pod", "ns", "a", "1", 5.0),
             ("p", "Pod", "ns", "a", "2", 0.0), ("q", "Pod", "ns", "a", "1", 0.0),
             ("p", "Pod", "ns", "a", "1", 6.0), ("p", "Pod", "ns", "a", "1", 1.0)]
    for *key, dt in steps:
        clock[0] += dt
        assert got.process_resource(*key) == want.process_resource(*key)
    got.drop()
    want.drop()
    assert got.process_resource("p", "Pod", "ns", "a", "1") is \
        want.process_resource("p", "Pod", "ns", "a", "1") is True


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    from kyverno_tpu_torch.models.engine import ShardedPolicySet

    _, tpol = _load([_doc("a", PATTERN_POOL[0])])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KTPU_MESH_SHAPE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BackgroundScanner(tpol)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedPolicySet(2)
    assert BackgroundScanner(tpol, device="cpu").device.type == "cpu"
    assert BackgroundScanner(tpol, mesh=make_mesh(["cpu"] * 2)).device.type \
        == "cpu"
