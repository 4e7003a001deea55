"""The port's native flattener (``kyverno_tpu_torch/csrc/ktpu_flatten.cpp``
through ``models/native_flatten.py``) against the JAX package's native
flattener and against the Python flatteners of both packages, byte for
byte: the packed arrays (cells, bmeta, dictv, str_bytes in interning
order) of both entries (the dict walk and JSON bytes), every lane of the
FlatBatch entry, request envelopes, the chunked flatten with
``merge_packed``, ``KTPU_NATIVE=0``, one case per counted fallback, and a
build that fails raising instead of falling back.
"""

from collections import OrderedDict
import json

import numpy as np
import pytest

from kyverno_tpu.models import native_flatten as jax_nf
from kyverno_tpu.models.flatten import BATCH_ARRAYS, DICT_ARRAYS
from kyverno_tpu_torch.models import native_flatten as nf
from kyverno_tpu_torch.models.flatten import PackedBatch, flatten_batch
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse)
    both_sets,
    corpus_docs,
    corpus_resources,
    jax_flatten_batch,
)

# Policies whose paths read the edge values below: quantities, numbers,
# durations, booleans, the effective namespace and the request envelope.
EDGE_POLICIES = [{
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "edge-values"},
    "spec": {"rules": [
        {"name": "annotations", "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"message": "m", "pattern": {"metadata": {
             "name": "?*", "annotations": {"mem": ">=1", "team": "?*",
                                           "big": ">1"}}}}},
        {"name": "requests", "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"message": "m", "pattern": {"spec": {"containers": [{
             "resources": {"requests": {"memory": ">=64Mi", "cpu": "<1"},
                           "limits": {"memory": "<=2Gi", "cpu": "*"}}}]}}}},
        {"name": "ports", "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"message": "m", "pattern": {"spec": {
             "=(containers)": [{"=(ports)": [{"containerPort": ">0"}]}],
             "=(replicas)": "<5", "=(hostNetwork)": False}}}},
        {"name": "timeout", "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"message": "m", "deny": {"conditions": {"any": [
             {"key": "{{request.object.metadata.annotations.timeout}}",
              "operator": "DurationGreaterThan", "value": "1h"},
             {"key": "{{request.object.metadata.annotations.ctl}}",
              "operator": "Equals", "value": "x"}]}}}},
        {"name": "envelope",
         "match": {"resources": {"kinds": ["Pod", "Namespace"],
                                 "namespaces": ["prod*"]}},
         "validate": {"message": "m", "deny": {"conditions": {"any": [
             {"key": "{{request.operation}}", "operator": "Equals",
              "value": "DELETE"},
             {"key": "{{request.userInfo.username}}", "operator": "Equals",
              "value": "alice"}]}}}},
    ]}}]

# The edge values of the JAX package's own native-flattener test.
EDGE_RESOURCES = [
    # deep numeric / quantity / duration strings
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "edge", "namespace": "prod",
                  "annotations": {"timeout": "1h30m", "mem": "0.1",
                                  "team": "α-unicode- "}},
     "spec": {"containers": [
         {"name": "c", "image": "nginx:latest",
          "resources": {"requests": {"memory": "64Mi", "cpu": 0.5},
                        "limits": {"memory": "1e3", "cpu": 2}}},
         {"name": "d", "image": "x" * 80},  # > STR_LEN -> host lane
     ]}},
    # null leaves, scalar-through, empty containers
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": None, "labels": {"tier": "web"}},
     "spec": {"containers": [], "hostNetwork": "not-a-bool"}},
    # non-dict spec: null-break chains
    {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "nb"},
     "spec": "oops"},
    # Namespace kind: effective-namespace synthetic path
    {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "prod-1"}},
    # floats that exercise Go scientific formatting + big ints
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "nums", "annotations": {"mem": "2Gi"}},
     "spec": {"containers": [{"name": "n", "ports": [
         {"containerPort": 10.25}, {"containerPort": 2 ** 70},
         {"containerPort": -3}, {"containerPort": 1e-7},
     ]}]}},
    # binary-repr artifact float: host lane on both tiers
    {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "f"},
     "spec": {"replicas": 0.1 + 0.2}},
    # >36-digit number part: host lane with empty numeric lanes
    {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "cap",
     "annotations": {"mem": "0.0000000000000000000000000000000000001e31",
                     "big": "9" * 40}},
     "spec": {}},
    # unicode whitespace / digits: host lane with empty numeric lanes
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "u", "annotations": {
         "timeout": " 30s", "mem": "６４4Mi", "ctl": "\x1c5s"}},
     "spec": {}},
]


def envelope_case():
    """Resources with admission envelopes (a None envelope among them)."""
    resources = EDGE_RESOURCES + [
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "a", "namespace": "prod-2"},
         "spec": {"hostNetwork": True}},
        {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "b"},
         "spec": {}}]
    requests = [{"operation": op, "namespace": "prod",
                 "userInfo": {"username": user, "groups": ["dev"]}}
                for op, user in zip(["CREATE", "DELETE", "UPDATE"] * 4,
                                    ["alice", "bob", "x" * 70] * 4)]
    requests = requests[:len(resources)]
    requests[2] = None
    return resources, requests


CASES = {
    "anchor": lambda: (corpus_docs("anchor"), corpus_resources("anchor", 300),
                       None),
    "library": lambda: (corpus_docs("library250"),
                        corpus_resources("library250", 400), None),
    "wide": lambda: (corpus_docs("wide"), corpus_resources("wide", 40), None),
    "edge": lambda: (EDGE_POLICIES + corpus_docs("crosscheck"),
                     EDGE_RESOURCES, None),
    "envelope": lambda: (EDGE_POLICIES, *envelope_case()),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    docs, resources, requests = CASES[request.param]()
    jset, tset = both_sets(docs)
    return request.param, jset, tset, resources, requests


@pytest.fixture(autouse=True)
def _counts():
    nf.reset_fallbacks()
    yield


def packed_of(fb) -> PackedBatch:
    cells, bmeta, str_bytes, dictv = fb.packed_args()
    return PackedBatch(n=fb.n, e=fb.e, cells=cells, bmeta=bmeta,
                       str_bytes=str_bytes, dictv=dictv)


def assert_packed_equal(got, want, what: str):
    assert got is not None, what
    assert (got.n, got.e) == (want.n, want.e), what
    for name in ("cells", "bmeta", "dictv", "str_bytes"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert g.tobytes() == w.tobytes(), (what, name)
    assert got.packed_blob()[0].tobytes() == want.packed_blob()[0].tobytes()


def assert_flat_equal(got, want, what: str):
    assert (got.n, got.e) == (want.n, want.e), what
    for name in BATCH_ARRAYS + DICT_ARRAYS + ("num_val",):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert np.array_equal(g, w), (what, name)
    assert got.strings == want.strings, what


def no_fallbacks():
    return all(v == 0 for v in nf.FALLBACKS.values())


def test_both_entries_equal_python_and_jax(case):
    """Dict walk and JSON bytes: the port's native packed output equals
    its Python flattener's, the JAX Python flattener's and the JAX native
    flattener's."""
    name, jset, tset, resources, requests = case
    python = packed_of(flatten_batch(resources, tset.tensors,
                                     requests=requests))
    assert_packed_equal(python, packed_of(jax_flatten_batch(
        resources, jset.tensors, requests=requests)), f"{name} python")
    jax_native = jax_nf.NativeFlattener(jset.tensors).flatten_packed(
        resources, requests=requests)
    assert_packed_equal(jax_native, python, f"{name} jax native")
    port = nf.NativeFlattener(tset.tensors)
    walk = port.flatten_packed(resources, requests=requests)
    assert nf._pylib is not None, "the build has no dict-walk entry"
    assert_packed_equal(walk, python, f"{name} dict walk")
    docs = json.dumps(resources).encode()
    reqs = json.dumps(requests).encode() if requests is not None else None
    from_json = port.flatten_packed(json_docs=docs, n_docs=len(resources),
                                    json_reqs=reqs)
    assert_packed_equal(from_json, python, f"{name} json bytes")
    engine = tset.flatten_packed(resources, requests=requests)
    assert_packed_equal(engine, python, f"{name} engine")
    assert not hasattr(engine, "_flat")         # not the Python fallback
    assert no_fallbacks(), nf.FALLBACKS
    if name in ("edge", "envelope"):
        flat = python.to_flat()
        assert flat.host_flag.any() and flat.num_ok.any() and flat.dur_any.any()


def test_flat_batch_entry_equal(case):
    """``ktpu_flatten_batch`` (the FlatBatch behind ``cps.flatten``):
    every lane equals the Python flatteners' and the JAX native one's."""
    name, jset, tset, resources, requests = case
    want = flatten_batch(resources, tset.tensors, requests=requests)
    assert_flat_equal(jax_flatten_batch(resources, jset.tensors,
                                        requests=requests), want, "jax python")
    got = tset.flatten(resources, requests=requests)
    assert_flat_equal(got, want, f"{name} native")
    assert_flat_equal(jax_nf.NativeFlattener(jset.tensors).flatten(
        resources, requests=requests), want, f"{name} jax native")
    assert got.packed_blob()[0].tobytes() == want.packed_blob()[0].tobytes()
    assert no_fallbacks(), nf.FALLBACKS


def test_chunks_merge_to_the_whole_batch(case, monkeypatch):
    """``flatten_packed_chunks`` over worker threads, its chunks joined by
    ``merge_packed``, equals one whole-batch flatten and the JAX
    package's chunked flatten."""
    name, jset, tset, resources, requests = case
    monkeypatch.setenv("KTPU_FLATTEN_WORKERS", "3")
    whole = packed_of(flatten_batch(resources, tset.tensors,
                                    requests=requests))
    chunk = max(1, -(-len(resources) // 3))
    got = nf.flatten_packed_chunks(tset.tensors, resources,
                                   requests=requests, chunk=chunk)
    want = jax_nf.flatten_packed_chunks(jset.tensors, resources,
                                        requests=requests, chunk=chunk)
    assert_packed_equal(want, whole, f"{name} jax chunks")
    assert_packed_equal(got, whole, f"{name} chunks")
    assert no_fallbacks(), nf.FALLBACKS


def test_kill_switch_uses_the_python_flattener(case, monkeypatch):
    name, jset, tset, resources, requests = case
    native = tset.flatten_packed(resources, requests=requests)
    monkeypatch.setenv("KTPU_NATIVE", "0")
    got = tset.flatten_packed(resources, requests=requests)
    assert hasattr(got, "_flat")                 # the Python flattener's
    assert_packed_equal(got, native, f"{name} KTPU_NATIVE=0")
    assert_packed_equal(jset.flatten_packed(resources, requests=requests),
                        native, f"{name} jax KTPU_NATIVE=0")
    flat = tset.flatten(resources, requests=requests)
    assert_flat_equal(flat, jax_nf.flatten_batch_fast(
        resources, jset.tensors, requests=requests),
        f"{name} flatten KTPU_NATIVE=0")
    assert no_fallbacks(), nf.FALLBACKS


# ------------------------------------------------------------ fallbacks

def _fallback_case(kind: str):
    """(policy docs, resources) that send one batch down one fallback."""
    docs = EDGE_POLICIES
    base = [dict(r) for r in EDGE_RESOURCES[:4]]
    if kind == "unserializable":
        bad = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "s", "annotations": {"team": {"a", "b"}}}}
        return docs, base + [bad]
    if kind == "walk_rejected":
        bad = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "k", "annotations": {7: "x", "team": "t"}}}
        return docs, base + [bad]
    if kind == "parse_error":
        bad = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "n"}, "spec": {"replicas": float("nan")}}
        return docs, base + [bad]
    if kind == "newline":
        nl = {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
              "metadata": {"name": "newline-key"},
              "spec": {"rules": [{
                  "name": "nl", "match": {"resources": {"kinds": ["Pod"]}},
                  "validate": {"message": "m", "pattern": {"metadata": {
                      "annotations": {"a\nb": "?*"}}}}}]}}
        return docs + [nl], base
    if kind == "dict_overflow":
        # two pods whose twelve containers hold distinct quantities:
        # about fifty strings, many more than the first guess of 2 x B
        return docs, [{"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": f"many-{k}"},
                       "spec": {"containers": [{
                           "name": f"c{i}", "resources": {
                               "requests": {"memory": f"{i + 1}Mi",
                                            "cpu": f"{i + k}m"},
                               "limits": {"memory": f"{i + 1}Gi",
                                          "cpu": str(i + 2 + k)}}}
                           for i in range(12)]}} for k in range(2)]
    raise KeyError(kind)


# the counts each entry makes: cps.flatten (FlatBatch), cps.flatten_packed
# (each native attempt that gives up counts: the dict walk, then JSON)
FALLBACK_COUNTS = {
    "unserializable": ({"unserializable": 1},
                       {"walk_rejected": 1, "unserializable": 1}),
    "walk_rejected": ({}, {"walk_rejected": 1}),
    "parse_error": ({"parse_error": 1},
                    {"walk_rejected": 1, "parse_error": 1}),
    "newline": ({"newline": 1}, {"newline": 1}),
    "dict_overflow": ({"dict_overflow": 1}, {"dict_overflow": 2}),
}


@pytest.mark.parametrize("kind", list(FALLBACK_COUNTS))
def test_counted_fallback(kind, monkeypatch):
    """Each fallback the JAX package takes for an input is taken here too,
    counted by reason, with output equal to the JAX package's and to the
    Python flattener's."""
    docs, resources = _fallback_case(kind)
    jset, tset = both_sets(docs)
    if kind == "dict_overflow":
        # a small dictionary cap stands in for 2^24 strings; a fresh
        # handle so that no earlier size guess skips the retry
        monkeypatch.setattr(nf, "DICT_CAP", 8)
        monkeypatch.setattr(nf, "STR_CAP_MIN", 4)
        monkeypatch.setattr(nf, "_flattener_cache", OrderedDict())
    want = flatten_batch(resources, tset.tensors)
    flat_counts, packed_counts = FALLBACK_COUNTS[kind]
    expect = {k: 0 for k in nf.FALLBACKS}

    got = tset.flatten(resources)
    assert nf.FALLBACKS == {**expect, **flat_counts}, nf.FALLBACKS
    assert_flat_equal(got, want, f"{kind} flatten")
    assert got.packed_blob()[0].tobytes() == \
        jset.flatten(resources).packed_blob()[0].tobytes()

    nf.reset_fallbacks()
    got_p = tset.flatten_packed(resources)
    assert nf.FALLBACKS == {**expect, **packed_counts}, nf.FALLBACKS
    assert_packed_equal(got_p, packed_of(want), f"{kind} flatten_packed")
    assert_packed_equal(jset.flatten_packed(resources), packed_of(want),
                        f"{kind} jax flatten_packed")


@pytest.mark.parametrize("how", ["broken source", "no compiler"])
def test_failed_build_raises(how, monkeypatch, tmp_path):
    """A native flattener that does not build makes flatten() and
    evaluate() raise: no quiet fallback to the Python flattener."""
    _, tset = both_sets(EDGE_POLICIES)
    monkeypatch.setattr(nf, "_lib", None)
    monkeypatch.setattr(nf, "_pylib", None)
    monkeypatch.setattr(nf, "BUILT", {})
    monkeypatch.setattr(nf, "BUILD_DIR", tmp_path)
    if how == "broken source":
        src = tmp_path / "ktpu_flatten.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(nf, "CPP", src)
    else:
        monkeypatch.setattr(nf.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="native flattener|g\\+\\+"):
        tset.flatten(EDGE_RESOURCES)
    with pytest.raises(RuntimeError, match="native flattener|g\\+\\+"):
        tset.evaluate(EDGE_RESOURCES)
    with pytest.raises(RuntimeError, match="native flattener|g\\+\\+"):
        tset.flatten_packed(EDGE_RESOURCES)
    monkeypatch.setenv("KTPU_NATIVE", "0")
    assert tset.flatten(EDGE_RESOURCES).n == len(EDGE_RESOURCES)


def test_library_is_hash_named_and_loaded_once():
    nf._load_lib()
    path = nf.BUILT["path"]
    assert path.startswith(str(nf.BUILD_DIR)) and "libktpu_flatten-" in path
    assert path in {str(nf.lib_path(v)) for v in nf._variants()}
    assert nf._load_lib() is nf._load_lib()


def test_packed_helpers_equal_jax(case):
    """The packed half of the flattener module: ``PackedBatch.strings`` and
    ``to_flat`` of the native output, ``pad_packed``,
    ``pad_to_buckets_packed`` and ``merge_packed`` of uneven chunks, each
    equal to the JAX package's on the same arrays."""
    from kyverno_tpu.models import flatten as jax_flatten
    from kyverno_tpu_torch.models import flatten as port_flatten

    name, jset, tset, resources, requests = case
    got = tset.flatten_packed(resources, requests=requests)
    want = jset.flatten_packed(resources, requests=requests)
    assert_packed_equal(got, want, name)
    assert got.strings == want.strings
    assert_flat_equal(got.to_flat(), want.to_flat(), f"{name} to_flat")
    assert_flat_equal(got.to_flat(), flatten_batch(
        resources, tset.tensors, requests=requests), f"{name} to_flat python")
    for multiple in (1, 3, 8):
        g = port_flatten.pad_packed(got.cells, got.bmeta, multiple)
        w = jax_flatten.pad_packed(want.cells, want.bmeta, multiple)
        assert g[2] == w[2] and g[0].tobytes() == w[0].tobytes()
        assert g[1].tobytes() == w[1].tobytes()
    (gp, gn), (wp, wn) = (port_flatten.pad_to_buckets_packed(got),
                          jax_flatten.pad_to_buckets_packed(want))
    assert gn == wn
    assert_packed_equal(gp, wp, f"{name} buckets")
    cuts = [0, 1, len(resources) // 3, len(resources)]
    parts = [tset.flatten_packed(resources[a:b], requests=(
        requests[a:b] if requests is not None else None))
        for a, b in zip(cuts, cuts[1:]) if b > a]
    merged = port_flatten.merge_packed(parts)
    assert_packed_equal(merged, jax_flatten.merge_packed(
        [jset.flatten_packed(resources[a:b], requests=(
            requests[a:b] if requests is not None else None))
         for a, b in zip(cuts, cuts[1:]) if b > a]), f"{name} merge")
    assert_packed_equal(merged, got, f"{name} merge = whole")
