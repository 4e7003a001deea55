"""The policy-axis partition on both packages: ``PolicyPartitioner``,
``ShardedPolicySet`` and ``refresh_sharded`` under churn.

The same add / replace / remove sequence runs through the JAX package's
sharded set and the port's (on the CPU). After every step the port
touches at most one shard (the others keep their compiled set instance),
each shard's tensors have the same digest as the JAX shard's, the column
maps and refresh summaries are equal, and the shards' merged device
verdicts equal the full set's and the JAX package's. Mirrors
tests/test_policy_shards.py (its KT305 battery waits for the analysis
plane).
"""

import hashlib
from dataclasses import fields

import numpy as np
import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models.compiler import tensor_nbytes as jax_tensor_nbytes
from kyverno_tpu.models.engine import IncrementalCompiler as JaxIncremental
from kyverno_tpu.models.engine import PolicyPartitioner as JaxPartitioner
from kyverno_tpu.models.engine import shard_policies as jax_shard_policies
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import CompiledPolicySet
from kyverno_tpu_torch.models.compiler import tensor_nbytes
from kyverno_tpu_torch.models.engine import (
    IncrementalCompiler,
    PolicyPartitioner,
    ShardedPolicySet,
    shard_policies,
)
from kyverno_tpu_torch.runtime import hostlane
from tests.torch_parity import one_torch_thread  # noqa: F401


def _doc(name, pattern, n_rules=1):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": "enforce", "rules": [{
                "name": f"r{j}", "match": {"resources": {"kinds": ["Pod"]}},
                "validate": {"message": "m", "pattern": pattern},
            } for j in range(n_rules)]}}


def _pod(i):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"pod-{i}", "namespace": "default",
                         "labels": {"idx": str(i)}},
            "spec": {"containers": [{"name": "c",
                                     "image": ("nginx:latest" if i % 3 == 0
                                               else f"nginx:1.{i}")}],
                     "weight": (i * 7) % 160,
                     "grace": f"{(i * 13) % 400}s"}}


def _lib_docs():
    return {
        "no-latest": _doc("no-latest",
                          {"spec": {"containers": [{"image": "!*:latest"}]}}),
        "weight-cap": _doc("weight-cap", {"spec": {"weight": "<=100"}}),
        "grace-cap": _doc("grace-cap", {"spec": {"grace": "<1h"}}),
        "named": _doc("named", {"metadata": {"name": "pod-?*"}}),
    }


class Library:
    """Documents loaded on both packages; an update replaces both objects
    (the compilers key on identity)."""

    def __init__(self, docs: dict):
        self.jax = {k: jax_load_policy(d) for k, d in docs.items()}
        self.port = {k: torch_load_policy(d) for k, d in docs.items()}

    def set(self, name, doc):
        self.jax[name] = jax_load_policy(doc)
        self.port[name] = torch_load_policy(doc)

    def drop(self, name):
        del self.jax[name], self.port[name]


def _tensor_digest(t) -> str:
    """tests/test_policy_shards.py's digest, over the fields by name."""
    h = hashlib.sha256()
    for f in sorted(fields(t), key=lambda f: f.name):
        v = getattr(t, f.name)
        if isinstance(v, np.ndarray):
            h.update(f.name.encode())
            h.update(str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _assert_shards_match_jax(sps, jsps):
    assert [sh.index for sh in sps.shards] == [sh.index for sh in jsps.shards]
    for sh, jsh in zip(sps.shards, jsps.shards):
        assert [p.name for p in sh.policies] == [p.name for p in jsh.policies]
        np.testing.assert_array_equal(sh.col_map, jsh.col_map)
        assert sh.col_map.dtype == jsh.col_map.dtype
        assert _tensor_digest(sh.cps.tensors) == _tensor_digest(jsh.cps.tensors)
        assert sh.reused == jsh.reused
    assert sps.last_refresh == jsps.last_refresh
    assert sps.shard_rule_counts() == jsps.shard_rule_counts()
    assert sps.shard_tensor_bytes() == jsps.shard_tensor_bytes()


def _assert_device_parity(sps, jsps, docs):
    batch = sps.full.flatten(docs)
    got = sps.evaluate_device(batch)
    want = sps.full.evaluate_device(batch)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    jbatch = jsps.full.flatten(docs)
    np.testing.assert_array_equal(got, jsps.evaluate_device(jbatch))


# ----------------------------------------------------------- partitioner

PLANS = [
    (2, [[("a", 8), ("b", 1), ("c", 1), ("d", 1), ("e", 1), ("f", 1),
          ("g", 1), ("h", 1)]]),
    (3, [[(k, 2) for k in "abcdef"],
         [(k, 2) for k in "abcde"] + [("x", 2), ("y", 2)]]),
    (2, [[("a", 10), ("b", 1)], [("b", 1), ("c", 10)]]),
    (4, [[(k, (i * 5) % 7 + 1) for i, k in enumerate("abcdefghij")],
         [(k, (i * 5) % 7 + 1) for i, k in enumerate("acegikmo")],
         [(k, 3) for k in "mnopqrs"]]),
]


@pytest.mark.parametrize("n,steps", PLANS)
def test_partitioner_plans_match_jax(n, steps):
    part, jpart = PolicyPartitioner(n), JaxPartitioner(n)
    for items in steps:
        assert part.plan(items) == jpart.plan(items)
    part.reset()
    jpart.reset()
    assert part.plan(steps[-1]) == jpart.plan(steps[-1])


def test_partitioner_is_sticky_and_balanced():
    part = PolicyPartitioner(3)
    first = part.plan([(k, 2) for k in "abcdef"])
    second = part.plan([(k, 2) for k in "abcde"] + [("x", 2), ("y", 2)])
    for key, s in zip("abcde", second):
        assert s == first["abcdef".index(key)]
    part = PolicyPartitioner(2)
    part.plan([("a", 10), ("b", 1)])
    assign = part.plan([("b", 1), ("c", 10)])
    assert assign[0] != assign[1]


def test_partitioner_rejects_zero_shards():
    with pytest.raises(ValueError):
        PolicyPartitioner(0)


# ----------------------------------------------------------------- churn

def test_add_replace_remove_touch_one_shard_as_in_jax():
    lib = Library(_lib_docs())
    docs = [_pod(i) for i in range(24)]
    inc = IncrementalCompiler(device="cpu")
    jinc = JaxIncremental()
    sps = inc.refresh_sharded(list(lib.port.values()), 2)
    jsps = jinc.refresh_sharded(list(lib.jax.values()), 2)
    _assert_shards_match_jax(sps, jsps)
    _assert_device_parity(sps, jsps, docs)

    def snapshot():
        return {sh.index: (sh.cps, _tensor_digest(sh.cps.tensors))
                for sh in sps.shards}

    def assert_one_shard_changed(before):
        after = snapshot()
        changed = []
        for idx, (cps_b, dig_b) in before.items():
            if idx not in after:
                changed.append(idx)
                continue
            cps_a, dig_a = after[idx]
            if dig_a != dig_b:
                changed.append(idx)
            else:
                assert cps_a is cps_b
        changed += [i for i in after if i not in before]
        assert len(set(changed)) <= 1, sorted(set(changed))
        assert sps.last_refresh["shards_reassembled"] <= 1

    steps = [
        ("set", "weight-cap", _doc("weight-cap", {"spec": {"weight": "<=90"}})),
        ("set", "team-label",
         _doc("team-label", {"metadata": {"labels": {"idx": "?*"}}})),
        ("drop", "grace-cap", None),
        ("set", "multi", _doc("multi", {"spec": {"grace": "<2h"}}, n_rules=3)),
    ]
    for op, name, doc in steps:
        before = snapshot()
        if op == "set":
            lib.set(name, doc)
        else:
            lib.drop(name)
        sps = inc.refresh_sharded(list(lib.port.values()), 2, sharded=sps)
        jsps = jinc.refresh_sharded(list(lib.jax.values()), 2, sharded=jsps)
        assert_one_shard_changed(before)
        _assert_shards_match_jax(sps, jsps)
        _assert_device_parity(sps, jsps, docs)
    # a new shard count starts a fresh decomposition on the same compiler
    sps3 = inc.refresh_sharded(list(lib.port.values()), 3, sharded=sps)
    jsps3 = jinc.refresh_sharded(list(lib.jax.values()), 3, sharded=jsps)
    assert sps3 is not sps and sps3.compiler is inc
    _assert_shards_match_jax(sps3, jsps3)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_col_maps_tile_the_live_rule_axis(n_shards):
    lib = Library(_lib_docs())
    sps = shard_policies(list(lib.port.values()), n_shards, device="cpu")
    cols = np.sort(np.concatenate([sh.col_map for sh in sps.shards]))
    np.testing.assert_array_equal(
        cols, np.arange(sps.full.tensors.n_rules_live))
    jsps = jax_shard_policies(list(lib.jax.values()), n_shards)
    _assert_shards_match_jax(sps, jsps)


def test_single_shard_degenerates_to_full_layout():
    lib = Library(_lib_docs())
    sps = shard_policies(list(lib.port.values()), 1, device="cpu")
    jsps = jax_shard_policies(list(lib.jax.values()), 1)
    assert len(sps.shards) == 1
    np.testing.assert_array_equal(
        sps.shards[0].col_map, np.arange(sps.full.tensors.n_rules_live))
    _assert_shards_match_jax(sps, jsps)
    _assert_device_parity(sps, jsps, [_pod(i) for i in range(7)])


def test_evaluate_resolves_host_lane_as_jax():
    hostlane.host_cache().clear()
    docs = _lib_docs()
    docs["self-name"] = _doc(
        "self-name", {"metadata": {"name": "{{request.object.metadata.name}}"}})
    lib = Library(docs)
    pods = [_pod(i) for i in range(11)]
    sps = shard_policies(list(lib.port.values()), 2, device="cpu")
    jsps = jax_shard_policies(list(lib.jax.values()), 2)
    got = sps.evaluate(pods)
    np.testing.assert_array_equal(got, jsps.evaluate(pods))
    want = CompiledPolicySet(list(lib.port.values()), device="cpu").evaluate(pods)
    np.testing.assert_array_equal(got, want)
    assert sps.rule_refs is sps.full.rule_refs
    assert sps.tensors is sps.full.tensors
    assert sps.policies == list(lib.port.values())
    hostlane.host_cache().clear()


def test_shard_tensor_bytes_report():
    lib = Library(_lib_docs())
    sps = shard_policies(list(lib.port.values()), 2, device="cpu")
    full_bytes = tensor_nbytes(sps.full.tensors)
    assert full_bytes == jax_tensor_nbytes(
        jax_shard_policies(list(lib.jax.values()), 2).full.tensors)
    per_shard = sps.shard_tensor_bytes()
    assert set(per_shard) == {sh.index for sh in sps.shards}
    assert all(0 < b < full_bytes for b in per_shard.values())


def test_sharded_set_keeps_the_compilers_device():
    sps = ShardedPolicySet(2, device="cpu").refresh(
        list(Library(_lib_docs()).port.values()))
    assert sps.full.device.type == "cpu"
    assert all(sh.cps.device.type == "cpu" for sh in sps.shards)
