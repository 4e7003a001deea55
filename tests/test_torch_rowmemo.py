"""The flatten-row memo on both packages: split / splice, the epoch
refresh of a memo row, the continuous lane's headroom and graft, and
``FlattenRowCache``.

Every row, batch and cache answer of the port (on the CPU) equals the JAX
package's on the same inputs, byte for byte; the port's spliced and
grafted batches score like a fresh flatten of the same resources. The
``FlattenRowCache`` cases are those of the JAX package's memo tests
(tests/runtime/test_flatten_pipeline.py::TestFlattenRowCache), run on
both classes; tests/runtime/test_resourcecache.py holds the watch cache
(``ResourceCache``), which waits for the client and the webhook.
"""

import numpy as np
import pytest

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import CompiledPolicySet as JaxPolicySet
from kyverno_tpu.models import flatten as jax_flatten
from kyverno_tpu.models.engine import IncrementalCompiler as JaxIncremental
from kyverno_tpu.runtime.batch import AdmissionBatcher as JaxBatcher
from kyverno_tpu.runtime.resourcecache import FlattenRowCache as JaxRowCache
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import CompiledPolicySet as TorchPolicySet
from kyverno_tpu_torch.models import flatten as torch_flatten
from kyverno_tpu_torch.models.engine import IncrementalCompiler
from kyverno_tpu_torch.runtime.batch import AdmissionBatcher
from kyverno_tpu_torch.runtime.resourcecache import FlattenRowCache
from tests.torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    corpus_docs,
    corpus_resources,
    one_torch_thread,
)

ROW_FIELDS = ("cells", "str_bytes", "dictv")
BATCH_FIELDS = ("cells", "bmeta", "str_bytes", "dictv")


def _doc(name, pattern):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": "enforce", "rules": [{
                "name": "r", "match": {"resources": {"kinds": ["Pod"]}},
                "validate": {"message": "m", "pattern": pattern}}]}}


# string globs, numeric bounds, durations: every dictionary value lane
# the splice's OR-merge touches
POLICY_DOCS = [
    _doc("no-latest", {"spec": {"containers": [{"image": "!*:latest"}]}}),
    _doc("weight-cap", {"spec": {"weight": "<=100"}}),
    _doc("grace", {"spec": {"grace": "<1h"}}),
]
# a policy whose path no other policy has: adding it bumps the epoch
TIER_DOC = _doc("tier", {"spec": {"tier": "gold"}})


def _pod(i, image=None, name=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name or f"pod-{i}", "namespace": "default",
                         "labels": {"idx": str(i)}},
            "spec": {"containers": [{"name": "c", "image": image or (
                "nginx:latest" if i % 3 == 0 else f"nginx:1.{i}")}],
                     "weight": (i * 7) % 160, "frac": i + 0.5,
                     "grace": f"{(i * 13) % 400}s"}}


def assert_rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for f in ROW_FIELDS:
            x, y = getattr(ra, f), getattr(rb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert int(ra.bmeta) == int(rb.bmeta)


def assert_batches_equal(a, b):
    assert (a.n, a.e) == (b.n, b.e)
    for f in BATCH_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.fixture(scope="module")
def sets():
    return (JaxPolicySet([jax_load_policy(d) for d in POLICY_DOCS]),
            TorchPolicySet([torch_load_policy(d) for d in POLICY_DOCS],
                           device="cpu"))


@pytest.mark.parametrize("corpus", ["pods", "crosscheck", "library250"])
def test_split_splice_round_trip_matches_jax(corpus):
    """split -> splice on both packages: rows and spliced batches equal
    byte for byte, and the port's splice scores like its fresh flatten,
    also with rows of two batches interleaved."""
    if corpus == "pods":
        docs, resources = POLICY_DOCS, [_pod(i) for i in range(16)]
    else:
        docs = corpus_docs(corpus)
        resources = corpus_resources(corpus, 24)
    jset = JaxPolicySet([jax_load_policy(d) for d in docs])
    tset = TorchPolicySet([torch_load_policy(d) for d in docs], device="cpu")
    jrows = jax_flatten.split_packed_rows(jset.flatten_packed(resources))
    batch = tset.flatten_packed(resources)
    trows = torch_flatten.split_packed_rows(batch)
    assert_rows_equal(jrows, trows)
    half = len(resources) // 2
    order = [i for pair in zip(range(half), range(half, 2 * half))
             for i in pair]
    for idx in (list(range(len(resources))), order):
        jb = jax_flatten.splice_packed_rows([jrows[i] for i in idx])
        tb = torch_flatten.splice_packed_rows([trows[i] for i in idx])
        assert_batches_equal(jb, tb)
        want = tset.evaluate_device(
            tset.flatten_packed([resources[i] for i in idx]))
        assert np.array_equal(tset.evaluate_device(tb), want)


def test_flatten_one_row_matches_jax(sets):
    jset, tset = sets
    for i in range(4):
        j = jax_flatten.flatten_one_row(_pod(i), jset.tensors)
        t = torch_flatten.flatten_one_row(_pod(i), tset.tensors)
        assert_rows_equal([j], [t])


def test_refresh_after_epoch_bump_matches_jax():
    """A memo row cut before a policy update that appends paths and a
    kind refreshes (only the appended paths flatten) to the JAX
    package's row; a row of a longer dictionary is refused; an exact
    epoch comes back unchanged."""
    jinc, tinc = JaxIncremental(), IncrementalCompiler(device="cpu")
    base = POLICY_DOCS[:2]
    jc = jinc.refresh([jax_load_policy(d) for d in base])
    tc = tinc.refresh([torch_load_policy(d) for d in base])
    docs = [_pod(i) for i in range(5)]
    jm = [jax_flatten.MemoRow(r, jc.tensors.n_paths, jc.tensors.dict_epoch)
          for r in jax_flatten.split_packed_rows(jc.flatten_packed(docs))]
    tm = [torch_flatten.MemoRow(r, tc.tensors.n_paths, tc.tensors.dict_epoch)
          for r in torch_flatten.split_packed_rows(tc.flatten_packed(docs))]
    same, ext = torch_flatten.refresh_packed_row(tm[0], docs[0], tc.tensors)
    assert same is tm[0] and ext is False
    grown = base + [TIER_DOC, _doc("deploy", {"spec": {"replicas": "<5"}})]
    grown[3]["spec"]["rules"][0]["match"]["resources"]["kinds"] = [
        "Deployment"]
    jc2 = jinc.refresh([jax_load_policy(d) for d in grown])
    tc2 = tinc.refresh([torch_load_policy(d) for d in grown])
    assert tc2.tensors.dict_epoch > tc.tensors.dict_epoch
    jr, tr = [], []
    for a, b, d in zip(jm, tm, docs):
        ra, ea = jax_flatten.refresh_packed_row(a, d, jc2.tensors)
        rb, eb = torch_flatten.refresh_packed_row(b, d, tc2.tensors)
        assert ea is eb is True
        assert (ra.n_paths, ra.epoch) == (rb.n_paths, rb.epoch)
        jr.append(ra.row)
        tr.append(rb.row)
    assert_rows_equal(jr, tr)
    want = tc2.evaluate_device(tc2.flatten_packed(docs))
    got = tc2.evaluate_device(torch_flatten.splice_packed_rows(tr))
    assert np.array_equal(got, want)
    # a row from a longer dictionary than the set's: refused on both
    for fl, inc, load, row in (
            (jax_flatten, JaxIncremental(), jax_load_policy, jr[0]),
            (torch_flatten, IncrementalCompiler(device="cpu"),
             torch_load_policy, tr[0])):
        fresh = inc.refresh([load(POLICY_DOCS[0])])
        long_row = fl.MemoRow(row, tc2.tensors.n_paths,
                              tc2.tensors.dict_epoch)
        assert fresh.tensors.n_paths < long_row.n_paths
        assert fl.refresh_packed_row(long_row, docs[0],
                                     fresh.tensors) == (None, False)


def test_headroom_and_graft_match_jax(sets):
    """The continuous lane: a padded batch grows string-table headroom,
    late rows graft into its free row slots, byte-equal to the JAX
    package's, scoring like one fresh flatten of every resource; a row
    whose fresh strings overflow the table leaves the batch untouched."""
    jset, tset = sets
    base = [_pod(i) for i in range(3)]
    late = [_pod(i, name=f"late-{i}") for i in range(3, 6)]
    out = []
    for side, cps, fl, batcher in (
            ("jax", jset, jax_flatten, JaxBatcher),
            ("torch", tset, torch_flatten, AdmissionBatcher)):
        raw = cps.flatten_packed(base)
        v_used = int(raw.dictv.shape[0])
        padded, _ = batcher._pad_admission(raw)
        padded = fl.grow_dict_headroom(padded, v_used // 4 + 1)
        rows = fl.split_packed_rows(cps.flatten_packed(late))
        n = fl.graft_packed_rows(padded, rows, len(base), v_used)
        assert n == len(late), side
        out.append(padded)
    assert_batches_equal(*out)
    want = tset.evaluate_device(tset.flatten_packed(base + late))
    got = tset.evaluate_device(out[1])
    assert np.array_equal(got[:len(base) + len(late)], want)
    # overflow: the table is full, a row with any fresh string is refused
    raw = tset.flatten_packed(base[:1])
    padded, _ = AdmissionBatcher._pad_admission(raw)
    v_full = int(padded.dictv.shape[0])
    fresh = torch_flatten.split_packed_rows(tset.flatten_packed(
        [_pod(9, image="completely-new-image:tag-xyz", name="unseen")]))
    before = padded.cells.copy()
    assert torch_flatten.graft_packed_rows(padded, fresh, 1, v_full) == 0
    assert np.array_equal(padded.cells, before)


def test_pad_admission_matches_jax(sets):
    """_pad_admission on both packages (pow2 buckets, floor 16, and a
    floor the caller passes) gives the same batch; padding never touches
    the port's verdicts."""
    jset, tset = sets
    resources = [_pod(i) for i in range(5)]
    for floor in (None, 4):
        jb, jn = JaxBatcher._pad_admission(jset.flatten_packed(resources),
                                           floor=floor)
        tb, tn = AdmissionBatcher._pad_admission(
            tset.flatten_packed(resources), floor=floor)
        assert jn == tn == 5
        assert_batches_equal(jb, tb)
        assert tb.n == (16 if floor is None else 8)
        v = tset.evaluate_device(tb)
        assert np.array_equal(v[:5], tset.evaluate_device(
            tset.flatten_packed(resources)))
        assert (v[5:] == 0).all()


# ------------------------------------------------------- FlattenRowCache

def _both(fn):
    """Run ``fn(cls)`` on the JAX package's class and the port's; the
    results must be equal."""
    a, b = fn(JaxRowCache), fn(FlattenRowCache)
    assert a == b
    return b


def _stats(cache):
    s = dict(cache.stats())
    s.pop("fabric_hits", None)          # the fleet tier's (0 here)
    return s


def test_digest_canonicalizes_key_order():
    def run(cls):
        a = {"kind": "Pod", "spec": {"x": 1, "y": 2}}
        b = {"spec": {"y": 2, "x": 1}, "kind": "Pod"}
        c = {"kind": "Pod", "spec": {"x": 1, "y": 3}}
        return (cls.digest(a), cls.digest(b), cls.digest(c),
                cls.digest(a, {"operation": "CREATE"}))
    d = _both(run)
    assert d[0] == d[1] != d[2] and d[3] != d[0]


def test_digest_unserializable_is_none_and_counts_miss():
    def run(cls):
        cache = cls()
        d = cls.digest({"spec": {"x": object()}})
        got = cache.get("fp", d)
        cache.put("fp", None, "row")     # silently skipped
        return d, got, _stats(cache), len(cache)
    assert _both(run) == (None, None, {"rows": 0, "hits": 0, "misses": 1,
                                       "extended": 0,
                                       "survival_ratio": 0.0}, 0)


def test_lru_eviction_and_counters():
    def run(cls):
        cache = cls(max_rows=4)
        digs = [cls.digest({"i": i}) for i in range(6)]
        for i in range(4):
            cache.put("fp", digs[i], f"row{i}")
        seen = [cache.get("fp", digs[0])]
        cache.put("fp", digs[4], "row4")             # evicts 1 (LRU)
        cache.put("fp", digs[5], "row5")             # evicts 2
        seen += [len(cache), cache.get("fp", digs[1]),
                 cache.get("fp", digs[2]), cache.get("fp", digs[0])]
        return seen, _stats(cache), cache.survival_ratio()
    seen, stats, ratio = _both(run)
    assert seen == ["row0", 4, None, None, "row0"]
    assert stats["hits"] == 2 and stats["misses"] == 2 and ratio == 0.5


def test_fingerprint_partitions_key_space():
    def run(cls):
        cache = cls()
        d = cls.digest({"kind": "Pod"})
        cache.put("fp-old", d, "old-row")
        out = (cache.get("fp-new", d), cache.get("fp-old", d))
        cache.clear()
        return out, len(cache)
    assert _both(run) == ((None, "old-row"), 0)


def test_get_row_put_row_across_epochs():
    """put_row stores a row with its dictionary coordinates; get_row
    hands it back at the same epoch, refreshes it (a hit, ``extended``)
    after paths are appended, and misses on a foreign lineage — the
    same answers and counters on both packages."""
    def run(cls, inc, load, fl):
        cache = cls()
        cps = inc.refresh([load(d) for d in POLICY_DOCS[:2]])
        t = cps.tensors
        res = [_pod(i) for i in range(3)]
        rows = fl.split_packed_rows(cps.flatten_packed(res))
        digs = [cls.digest(r) for r in res]
        for d, row in zip(digs, rows):
            cache.put_row(t.memo_space, d, row, t.n_paths, t.dict_epoch,
                          fingerprint=t.fingerprint)
        same = [cache.get_row(t.memo_space, d, r, t)
                for d, r in zip(digs, res)]
        cps2 = inc.refresh([load(d) for d in POLICY_DOCS + [TIER_DOC]])
        t2 = cps2.tensors
        assert t2.n_paths > t.n_paths
        ext = [cache.get_row(t2.memo_space, d, r, t2)
               for d, r in zip(digs, res)]
        miss = cache.get_row("another-lineage", digs[0], res[0], t2)
        none = cache.get_row(t2.memo_space, None, res[0], t2)
        rows_out = [(r.cells, r.str_bytes, r.dictv, int(r.bmeta))
                    for r in same + ext]
        return rows_out, miss, none, _stats(cache), t2.memo_space == t.memo_space

    a = run(JaxRowCache, JaxIncremental(), jax_load_policy, jax_flatten)
    b = run(FlattenRowCache, IncrementalCompiler(device="cpu"),
            torch_load_policy, torch_flatten)
    for ra, rb in zip(a[0], b[0]):
        for x, y in zip(ra[:3], rb[:3]):
            assert np.array_equal(x, y)
        assert ra[3] == rb[3]
    assert a[1:] == b[1:]
    assert b[3] == {"rows": 3, "hits": 6, "misses": 2, "extended": 3,
                    "survival_ratio": 0.75}
    assert b[4] is True
