"""Incremental compile on both packages: ``IncrementalCompiler`` and the
policy cache's compiled sets.

The same add / update / remove sequence runs through the JAX package's
``IncrementalCompiler`` and the port's (on the CPU); after every step the
spliced ``PolicyTensors`` are equal field by field and ``last_refresh``
is equal, with rule buckets on and off. The port's spliced set scores
like a from-scratch compile of the same policies, flatten-row memos cut
at epoch 0 refresh forward to the JAX package's rows byte for byte, and
``KTPU_INCREMENTAL=0`` puts the policy cache back on the one-shot
compile. Mirrors tests/runtime/test_incremental_compile.py where it needs
no module outside the slice (its delta scan and analyzer cases wait for
the background scanner and the analysis plane).
"""

import random

import numpy as np
import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models.engine import IncrementalCompiler as JaxIncremental
from kyverno_tpu.models.flatten import MemoRow as JaxMemoRow
from kyverno_tpu.models.flatten import refresh_packed_row as jax_refresh
from kyverno_tpu.models.flatten import split_packed_rows as jax_split
from kyverno_tpu.runtime.policycache import PolicyCache as JaxPolicyCache
from kyverno_tpu.runtime.policycache import PolicyType as JaxPolicyType
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import CompiledPolicySet as TorchPolicySet
from kyverno_tpu_torch.models.engine import IncrementalCompiler
from kyverno_tpu_torch.models.flatten import (
    MemoRow,
    refresh_packed_row,
    splice_packed_rows,
    split_packed_rows,
)
from kyverno_tpu_torch.runtime.policycache import PolicyCache, PolicyType
from tests.torch_parity import corpus_docs, one_torch_thread  # noqa: F401
from tests.torch_parity import tensor_fields

PATTERN_POOL = [
    {"spec": {"containers": [{"image": "!*:latest"}]}},
    {"spec": {"containers": [{"image": "!*:dev"}]}},
    {"spec": {"weight": "<=100"}},
    {"spec": {"weight": ">10"}},
    {"spec": {"grace": "<1h"}},
    {"metadata": {"name": "pod-?*"}},
    {"metadata": {"labels": {"idx": "?*"}}},
    {"spec": {"containers": [{"name": "c?*"}]}},
    {"spec": {"deep": {"tier": "gold", "zone": "?*"}}},
]


def _doc(name, pattern):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": "enforce", "rules": [{
                "name": "r",
                "match": {"resources": {"kinds": ["Pod"]}},
                "validate": {"message": "m", "pattern": pattern}}]}}


def _pod(i):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"pod-{i}", "namespace": "default",
                         "labels": {"idx": str(i)}},
            "spec": {"containers": [{"name": f"c{i}",
                                     "image": ("nginx:latest" if i % 3 == 0
                                               else f"nginx:1.{i}")}],
                     "weight": (i * 7) % 160,
                     "grace": f"{(i * 13) % 400}s",
                     "deep": {"tier": "gold" if i % 2 else "silver",
                              "zone": f"z{i}"}}}


def assert_tensors_equal(ja, tb):
    """Every field of two PolicyTensors equal; the rule IRs compared by
    routing decision, the segment spans by value, and the dictionary
    lineage (a uuid of each compiler) only by its presence."""
    jf, tf = tensor_fields(ja), tensor_fields(tb)
    assert jf.keys() == tf.keys()
    for name, a in jf.items():
        b = tf[name]
        if name == "rules":
            assert [(r.rule_name, r.host_only) for r in a] == \
                [(r.rule_name, r.host_only) for r in b]
        elif name == "segments":
            assert [vars(s) for s in a] == [vars(s) for s in b]
        elif name == "dict_base":
            assert (a is None) == (b is None)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
        else:
            assert a == b, (name, a, b)


class Library:
    """One policy library held as documents, loaded on both packages;
    an update replaces both objects (the compilers key on identity)."""

    def __init__(self):
        self.docs: dict[str, dict] = {}
        self.objs: dict[str, tuple] = {}

    def set(self, name, pattern):
        doc = _doc(name, pattern)
        self.docs[name] = doc
        self.objs[name] = (jax_load_policy(doc), torch_load_policy(doc))

    def drop(self, name):
        del self.docs[name]
        del self.objs[name]

    def policies(self):
        objs = list(self.objs.values())
        return [j for j, _ in objs], [t for _, t in objs]


def _churn(rule_bucket: bool, steps: int, seed: int):
    rng = random.Random(seed)
    lib = Library()
    for i in range(12):
        lib.set(f"pol-{i:02d}", rng.choice(PATTERN_POOL))
    docs = [_pod(i) for i in range(6)]
    jinc = JaxIncremental(rule_bucket=rule_bucket)
    tinc = IncrementalCompiler(rule_bucket=rule_bucket, device="cpu")
    jp, tp = lib.policies()
    jcps, tcps = jinc.refresh(jp), tinc.refresh(tp)
    assert_tensors_equal(jcps.tensors, tcps.tensors)
    assert jinc.last_refresh == tinc.last_refresh
    jmemo = [JaxMemoRow(row=r, n_paths=jcps.tensors.n_paths,
                        epoch=jcps.tensors.dict_epoch)
             for r in jax_split(jcps.flatten_packed(docs))]
    tmemo = [MemoRow(row=r, n_paths=tcps.tensors.n_paths,
                     epoch=tcps.tensors.dict_epoch)
             for r in split_packed_rows(tcps.flatten_packed(docs))]
    next_id = 12
    ops = ["add", "update", "remove", "same"]
    for step in range(steps):
        op = ops[step % len(ops)] if step < len(ops) else rng.choice(ops)
        if op == "add":
            lib.set(f"pol-{next_id:02d}", rng.choice(PATTERN_POOL))
            next_id += 1
        elif op == "update":
            lib.set(rng.choice(sorted(lib.docs)), rng.choice(PATTERN_POOL))
        elif op == "remove" and len(lib.docs) > 3:
            lib.drop(rng.choice(sorted(lib.docs)))
        jp, tp = lib.policies()
        jcps, tcps = jinc.refresh(jp), tinc.refresh(tp)
        assert_tensors_equal(jcps.tensors, tcps.tensors)
        assert jinc.last_refresh == tinc.last_refresh, (step, op)
        assert jinc.stats == tinc.stats, (step, op)
        if op == "same":
            assert tinc.last_refresh["unchanged"]
            continue
        # the spliced set scores like a from-scratch compile
        full = TorchPolicySet(tp, device="cpu")
        want = full.evaluate_device(full.flatten_packed(docs))
        got = tcps.evaluate_device(tcps.flatten_packed(docs))
        assert np.array_equal(got, want), (step, op)
        # memo rows from the last epoch refresh forward, byte-equal to
        # the JAX package's, and splice to the same verdicts
        nj, nt = [], []
        for mj, mt, d in zip(jmemo, tmemo, docs):
            rj, ej = jax_refresh(mj, d, jcps.tensors)
            rt, et = refresh_packed_row(mt, d, tcps.tensors)
            assert rt is not None and ej == et, (step, op)
            assert (rt.n_paths, rt.epoch) == (rj.n_paths, rj.epoch)
            for field in ("cells", "str_bytes", "dictv"):
                assert np.array_equal(getattr(rt.row, field),
                                      getattr(rj.row, field)), field
            assert rt.row.bmeta == rj.row.bmeta
            nj.append(rj)
            nt.append(rt)
        jmemo, tmemo = nj, nt
        spliced = tcps.evaluate_device(splice_packed_rows(
            [m.row for m in tmemo]))
        assert np.array_equal(spliced, want), (step, op)


@pytest.mark.parametrize("rule_bucket", [True, False])
def test_refresh_under_churn_matches_jax(rule_bucket):
    _churn(rule_bucket, steps=7, seed=41)


def test_compile_candidate_and_subset_match_jax():
    rng = random.Random(5)
    lib = Library()
    for i in range(6):
        lib.set(f"p{i}", rng.choice(PATTERN_POOL))
    jp, tp = lib.policies()
    jinc, tinc = JaxIncremental(), IncrementalCompiler(device="cpu")
    jinc.refresh(jp)
    tinc.refresh(tp)
    cand = _doc("p2", PATTERN_POOL[-1])        # shares a live policy's key
    jc = jinc.compile_candidate(jax_load_policy(cand))
    tc = tinc.compile_candidate(torch_load_policy(cand))
    assert_tensors_equal(jc.tensors, tc.tensors)
    assert tc.tensors.dict_base == tinc.dictionary.base
    # the candidate evicted nothing: the next refresh recompiles nothing
    tinc.refresh(tp)
    assert tinc.last_refresh["unchanged"]
    js, ts = jinc.subset(jp[1:4]), tinc.subset(tp[1:4])
    assert_tensors_equal(js.tensors, ts.tensors)
    # the subset snapshots the full path dictionary
    assert ts.tensors.n_paths == len(tinc.dictionary.paths)
    docs = [_pod(i) for i in range(5)]
    full = TorchPolicySet(tp[1:4], device="cpu")
    want = full.evaluate_device(full.flatten_packed(docs))
    assert np.array_equal(ts.evaluate_device(ts.flatten_packed(docs)), want)


def test_policy_cache_tensors_match_jax():
    """A port PolicyCache fed the library gives the JAX package's
    PolicyTensors: the incremental state needs nothing carried across
    (convert.py stays as it is)."""
    docs = corpus_docs("library250")[:40]
    jcache, tcache = JaxPolicyCache(), PolicyCache(device="cpu")
    for d in docs:
        d = dict(d, spec=dict(d["spec"], validationFailureAction="enforce"))
        jcache.add(jax_load_policy(d))
        tcache.add(torch_load_policy(d))
    for kind in ("Pod", "Deployment"):
        jc = jcache.compiled(JaxPolicyType.VALIDATE_ENFORCE, kind, "default")
        tc = tcache.compiled(PolicyType.VALIDATE_ENFORCE, kind, "default")
        assert [p.name for p in jc.policies] == [p.name for p in tc.policies]
        assert_tensors_equal(jc.tensors, tc.tensors)
        assert tc.device.type == "cpu"
    assert jcache.compile_totals["incremental_n"] == \
        tcache.compile_totals["incremental_n"] == 2


def test_kill_switch_restores_monolithic_path(monkeypatch):
    """KTPU_INCREMENTAL=0: monolithic tensors (no lineage, no rule
    bucket) equal to a one-shot compile's, with the same verdicts; on,
    the segmented path with the same verdicts."""
    rng = random.Random(7)
    pol_docs = [_doc(f"p{i}", rng.choice(PATTERN_POOL)) for i in range(6)]
    docs = [_pod(i) for i in range(6)]

    monkeypatch.setenv("KTPU_INCREMENTAL", "0")
    cache = PolicyCache(device="cpu")
    for d in pol_docs:
        cache.add(torch_load_policy(d))
    cps = cache.compiled(PolicyType.VALIDATE_ENFORCE, "Pod", "default")
    t = cps.tensors
    assert t.dict_base is None
    assert t.n_rules_live == t.n_rules == 6
    assert cache.compile_stats["mode"] == "full"
    want_cps = TorchPolicySet(cps.policies, device="cpu")
    assert t.fingerprint == want_cps.tensors.fingerprint
    want = want_cps.evaluate_device(want_cps.flatten_packed(docs))
    assert np.array_equal(cps.evaluate_device(cps.flatten_packed(docs)), want)

    monkeypatch.setenv("KTPU_INCREMENTAL", "1")
    cache2 = PolicyCache(device="cpu")
    for d in pol_docs:
        cache2.add(torch_load_policy(d))
    cps2 = cache2.compiled(PolicyType.VALIDATE_ENFORCE, "Pod", "default")
    assert cps2.tensors.dict_base is not None
    assert len(cps2.tensors.segments) == 6
    assert cps2.tensors.n_rules == 8          # pow2 bucket
    assert cps2.tensors.n_rules_live == 6
    assert np.array_equal(cps2.evaluate_device(cps2.flatten_packed(docs)),
                          want)
    # a one-policy update recompiles one segment
    cache2.update(torch_load_policy(_doc("p3", PATTERN_POOL[0])))
    cps3 = cache2.compiled(PolicyType.VALIDATE_ENFORCE, "Pod", "default")
    assert cache2.compile_stats["segments_recompiled"] == 1
    assert cache2.compile_stats["segments_reused"] == 5
    assert cps3.tensors.dict_base == cps2.tensors.dict_base


def test_policy_cache_generations_and_listeners():
    """The cache's bookkeeping on both packages: generation per write,
    listeners on SET and DELETE, snapshot, kind lookups by type."""
    sides = ((JaxPolicyCache(), jax_load_policy, JaxPolicyType),
             (PolicyCache(device="cpu"), torch_load_policy, PolicyType))
    seen = []
    for cache, load, ptype in sides:
        events = []
        cache.add_listener(lambda ev, p, events=events: events.append(
            (ev, p.name)))
        audit = _doc("audit", PATTERN_POOL[2])
        audit["spec"]["validationFailureAction"] = "audit"
        wild = _doc("wild", PATTERN_POOL[5])
        wild["spec"]["rules"][0]["match"] = {"resources": {"kinds": ["*"]}}
        ns_doc = _doc("ns-only", PATTERN_POOL[0])
        ns_doc["metadata"]["namespace"] = "team-a"
        ns_doc["kind"] = "Policy"
        for d in (_doc("a", PATTERN_POOL[0]), audit, wild, ns_doc):
            cache.add(load(d))
        a2 = load(_doc("a", PATTERN_POOL[1]))
        cache.update(a2)
        cache.remove(load(audit))
        gen, pols = cache.snapshot()
        seen.append((
            gen, cache.generation, events, sorted(p.name for p in pols),
            [p.name for p in cache.get_policies(
                ptype.VALIDATE_ENFORCE, "pod", "team-a")],
            [p.name for p in cache.get_policies(
                ptype.VALIDATE_ENFORCE, "Pod", "default")],
            [p.name for p in cache.get_policies(
                ptype.VALIDATE_AUDIT, "Pod", "")],
            sorted(p.name for p in cache.all_policies())))
    assert seen[0] == seen[1]
    assert seen[1][0] == 6
