"""The fleet plane on the port (``kyverno_tpu_torch/fleet``: the verdict
fabric, the replica router, the partitioned scan) against the JAX
package's, on the CPU.

- The JAX package's batteries ``tests/fleet/test_fabric.py``,
  ``test_router.py`` and ``test_scanparts.py``, case by case, on the port
  (``torch_parity.mirror_battery``; the JAX side of each case is the
  battery's own file). The edits are the port's: a policy cache or
  scanner on ``device="cpu"``.
- Both packages' fleets (``workload.replay.build_fleet_stacks`` and
  ``run_fleet``) on the same seeded churn trace over 16 of the library's
  policies (enforce): one replica and three, the fabric off and on, the
  hub in process and behind its loopback socket. Each leg's decisions
  (the allowed bit and the policy/rule pairs a denial names) and its
  verdict digest are the JAX leg's, and an oracle stack's (no batcher).
- ``scanparts``: the per-range digests of both packages' scanners over
  the same resources, whole and split among the members of an
  assignment.
- A CPU rehearsal of ``chip_smoke.fleet_phase`` at a small depth.
"""

import os

import pytest

import chip_smoke
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.fleet import scanparts as jax_scanparts
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu.runtime.background import BackgroundScanner as JaxScanner
from kyverno_tpu.workload import replay as jax_replay
from kyverno_tpu.workload import trace as jax_trace
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.fleet import scanparts as torch_scanparts
from kyverno_tpu_torch.runtime import hostlane as torch_hostlane
from kyverno_tpu_torch.runtime.background import (
    BackgroundScanner as TorchScanner)
from kyverno_tpu_torch.workload import replay as torch_replay
from kyverno_tpu_torch.workload import trace as torch_trace
from tests.torch_parity import (count_plain_launches, fleet_docs,
                                fleet_trace, mirror_battery)
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

# the JAX package's fleet batteries, on the port
for _relpath, _subs in (
        ("tests/fleet/test_fabric.py", (
            ("cache = PolicyCache()", 'cache = PolicyCache(device="cpu")'),)),
        ("tests/fleet/test_router.py", ()),
        ("tests/fleet/test_scanparts.py", (
            ("BackgroundScanner([POLICY])",
             'BackgroundScanner([POLICY], device="cpu")'),))):
    _exports = mirror_battery(_relpath, _subs)
    _clash = set(_exports) & set(globals())
    assert not _clash, (_relpath, _clash)
    globals().update(_exports)


@pytest.fixture(autouse=True)
def _detach_host_lane():
    """A stack's webhook attaches its oracle pool, and a fleet its fabric
    client, to its package's process-wide host lane: detach both after
    each case."""
    yield
    for mod in (jax_hostlane, torch_hostlane):
        mod.resolver().attach_pool(None, None)
        mod.host_cache().attach_fabric(None)


# ------------------------------------------------------------ the inputs

DOCS = fleet_docs()


def test_library_cut_has_every_family():
    families = {d["metadata"]["name"].rsplit("-v", 1)[0] for d in DOCS}
    assert len(DOCS) == 16 and len(families) == 8
    assert "host-echo-name" in families


def test_both_packages_synthesize_the_same_trace():
    jt, tt = fleet_trace(jax_trace), fleet_trace(torch_trace)
    assert jt.content_digest() == tt.content_digest()
    assert [e.op for e in tt.events].count("POLICY") == 2
    assert jt.bodies == tt.bodies


def _run(side: str, replicas: int, affinity: bool) -> dict:
    if side == "jax":
        fleet = jax_replay.build_fleet_stacks(
            [jax_load_policy(d) for d in DOCS], replicas=replicas)
        replay, tr = jax_replay, fleet_trace(jax_trace)
    else:
        fleet = torch_replay.build_fleet_stacks(
            [torch_load_policy(d) for d in DOCS], replicas=replicas,
            device="cpu")
        replay, tr = torch_replay, fleet_trace(torch_trace)
    try:
        return replay.run_fleet(tr, fleet, workers=4, affinity=affinity)
    finally:
        replay.stop_fleet_stacks(fleet)


@pytest.fixture(scope="module")
def oracle():
    """The port's oracle stack (no batcher) through ``run_fleet``."""
    fleet = chip_smoke.oracle_fleet(
        [torch_load_policy(d) for d in DOCS], "cpu")
    try:
        out = torch_replay.run_fleet(fleet_trace(torch_trace), fleet, workers=4)
    finally:
        fleet["stacks"][0]["webhook"].stop()
        torch_hostlane.resolver().attach_pool(None, None)
    return out


@pytest.mark.parametrize("replicas,fabric,transport,affinity", [
    (1, "0", "inproc", True),
    (3, "0", "inproc", True),
    (3, "1", "inproc", False),
    (3, "1", "socket", False)])
def test_fleet_decisions_match_jax(replicas, fabric, transport, affinity,
                                   oracle, monkeypatch):
    monkeypatch.setenv("KTPU_FABRIC", fabric)
    monkeypatch.setenv("KTPU_FABRIC_TRANSPORT", transport)
    want = _run("jax", replicas, affinity)
    got = _run("torch", replicas, affinity)
    assert not want["errors"] and not got["errors"]
    assert got["processed"] == want["processed"] == len(
        [e for e in fleet_trace(torch_trace).events if e.op != "POLICY"])
    assert chip_smoke.decision_map(got) == chip_smoke.decision_map(want) \
        == chip_smoke.decision_map(oracle)
    assert got["verdict_digest"] == want["verdict_digest"] \
        == oracle["verdict_digest"]
    assert 0 < got["denied"] < got["processed"]
    for out in (want, got):
        hub = out["hub"]
        if fabric == "0":
            # the sync handshakes, and nothing else
            assert (hub["gets"], hub["puts"], hub["hits"]) == (replicas, 0, 0)
        else:
            assert hub["puts"] > 0 and hub["invalidations"] > 0
            assert hub["epoch"] > 0


# ------------------------------------------------------------- scanparts

N_PARTS = 5


@pytest.mark.parametrize("members", [("a",), ("a", "b", "c")])
def test_range_digests_match_jax(members):
    resources = [chip_smoke.mixed_resource(i) for i in range(60)]
    jax_pols = [jax_load_policy(d) for d in DOCS]
    torch_pols = [torch_load_policy(d) for d in DOCS]
    jbase, tbase = JaxScanner(jax_pols), TorchScanner(torch_pols,
                                                      device="cpu")
    jbase.scan(resources)
    tbase.scan(resources)
    jd = jax_scanparts.matrix_range_digests(jbase, N_PARTS)
    td = torch_scanparts.matrix_range_digests(tbase, N_PARTS)
    assert td == jd and td
    assignment = torch_scanparts.assign_partitions(members, N_PARTS)
    assert assignment == jax_scanparts.assign_partitions(members, N_PARTS)
    jparts, tparts = [], []
    for owned in assignment.values():
        _, d = jax_scanparts.scan_partitions(JaxScanner(jax_pols),
                                             resources, owned, N_PARTS)
        jparts.append(d)
        _, d = torch_scanparts.scan_partitions(
            TorchScanner(torch_pols, device="cpu"), resources, owned,
            N_PARTS)
        tparts.append(d)
    assert tparts == jparts
    assert torch_scanparts.merge_range_digests(*tparts) == \
        jax_scanparts.merge_range_digests(*jparts) == \
        torch_scanparts.merge_range_digests(td)


def test_partition_map_matches_jax():
    for ns in ("", "default", "team-0", "kube-system", "ns-ü"):
        for n in (1, 4, 8):
            assert torch_scanparts.partition_of(ns, n) == \
                jax_scanparts.partition_of(ns, n)


# ------------------------------------------------------- the rehearsal

def test_chip_smoke_fleet_phase_on_the_cpu(monkeypatch):
    count_plain_launches(monkeypatch)
    for k in ("KTPU_FABRIC", "KTPU_FABRIC_TRANSPORT", "KTPU_SCAN_PARTITIONS"):
        monkeypatch.delenv(k, raising=False)
    # 128 events: with fewer, a replica's flushes can all land on cold
    # shape buckets, which dispatch without K6
    out = chip_smoke.fleet_phase(chip_smoke._synth_policy_docs(25),
                                 events=128, scan_rows=80, device="cpu")
    assert set(out["legs"]) == {"kill switch 1", "kill switch 3",
                                "fabric 3", "churn 1", "churn 3",
                                "socket 3"}
    assert out["launches"]["glob_nfa"] > 0 and out["launches"]["eval_rules"] > 0
    assert out["scan"]["takeover_s"] < 10.0
    # the phase leaves the switches as it found them
    assert not {"KTPU_FABRIC", "KTPU_FABRIC_TRANSPORT",
                "KTPU_SCAN_PARTITIONS"} & set(os.environ)
