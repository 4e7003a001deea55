"""K7 on both packages: the mesh, ``sharded_scan`` and K7's counts.

The port's mesh is a small type of its own (an array of torch devices
that may name one device more than once); its tests build
``["cpu"] * 8`` where the JAX package runs on conftest's 8 virtual CPU
devices. The same seeded pods go through the JAX package's
``sharded_scan`` and the port's, 1D and 2D: verdicts, fails and passes
must be equal, exactly. ``rule_counts_plain`` (K7's counts on the CPU,
the plain version of eval_rules' counts form) is held to
``jnp.sum(v == V_FAIL, axis=0)``, the JAX program's count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import CompiledPolicySet as JaxPolicySet
from kyverno_tpu.models.engine import shard_policies as jax_shard_policies
from kyverno_tpu.ops.eval import V_FAIL as JAX_FAIL
from kyverno_tpu.ops.eval import V_PASS as JAX_PASS
from kyverno_tpu.parallel import make_mesh as jax_make_mesh
from kyverno_tpu.parallel import sharded_scan as jax_sharded_scan
from kyverno_tpu.parallel.mesh import parse_mesh_shape as jax_parse
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import CompiledPolicySet, Verdict
from kyverno_tpu_torch.models.engine import shard_policies
from kyverno_tpu_torch.ops import _build
from kyverno_tpu_torch.ops import eval as ev
from kyverno_tpu_torch.parallel import (
    make_mesh,
    mesh_from_env,
    parse_mesh_shape,
    sharded_eval_fn,
    sharded_scan,
)
from kyverno_tpu_torch.parallel.mesh import (
    Mesh,
    data_axis_size,
    is_2d,
    policy_axis_size,
)
from kyverno_tpu_torch.runtime import hostlane
from tests.torch_parity import corpus_docs, one_torch_thread  # noqa: F401

CPU8 = ["cpu"] * 8


def make_pod(i: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": f"p{i}"},
        "spec": {"containers": [
            {"name": "c", "image": "nginx:latest" if i % 2 else "nginx:1.21"}
        ]},
    }


def _mixed_docs() -> list[dict]:
    """tests/ops/test_mesh.py's synthetic mixed-lane corpus: device globs,
    numeric bounds and a host-lane variable pattern."""
    def doc(name, pattern):
        return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
                "metadata": {"name": name},
                "spec": {"validationFailureAction": "enforce", "rules": [{
                    "name": "r", "match": {"resources": {"kinds": ["Pod"]}},
                    "validate": {"message": "m", "pattern": pattern}}]}}
    out = [doc(f"weight-{i}", {"spec": {"weight": f"<={30 + 20 * i}"}})
           for i in range(4)]
    out.append(doc("no-latest",
                   {"spec": {"containers": [{"image": "!*:latest"}]}}))
    out.append(doc("self-name",
                   {"metadata": {"name": "{{request.object.metadata.name}}"}}))
    return out


def _mixed_pod(i):
    p = make_pod(i)
    p["spec"]["weight"] = (i * 17) % 120
    return p


# test_sharded_scan_resolves_host_lane's policy: one device rule, one rule
# the device leaves to the host lane
MIXED_LANES = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "mixed-lanes"},
    "spec": {"rules": [
        {"name": "no-latest",
         "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"pattern": {"spec": {"containers": [
             {"image": "!*:latest"}]}}}},
        {"name": "name-is-itself",
         "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"pattern": {"metadata": {
             "name": "{{request.object.metadata.name}}"}}}},
    ]},
}


def _sets(docs):
    return (JaxPolicySet([jax_load_policy(d) for d in docs]),
            CompiledPolicySet([torch_load_policy(d) for d in docs],
                              device="cpu"))


@pytest.fixture(autouse=True)
def _fresh_host_memo():
    hostlane.host_cache().clear()
    yield
    hostlane.host_cache().clear()


def _assert_scan_equal(got, want):
    (v, f, p), (jv, jf, jp) = got, want
    assert v.dtype == np.int8 and v.shape == jv.shape
    np.testing.assert_array_equal(v, np.asarray(jv))
    assert f.dtype == np.int64 and p.dtype == np.int64
    np.testing.assert_array_equal(f, np.asarray(jf))
    np.testing.assert_array_equal(p, np.asarray(jp))
    assert not (v == Verdict.HOST).any()
    # the counts are those of the resolved matrix
    np.testing.assert_array_equal(f, (v == Verdict.FAIL).sum(axis=0))
    np.testing.assert_array_equal(p, (v == Verdict.PASS).sum(axis=0))


# ------------------------------------------------------------- grammar

GRAMMAR = [("", 8), ("1", 8), ("1d", 8), (" 1D ", 8), ("auto", 8),
           ("auto", 4), ("auto", 16), ("auto", 3), ("auto", 1), ("2x4", 8),
           ("4X2", 8), ("8x1", 8), ("2x2", 8), ("garbage", 8), ("0x8", 8),
           ("2x", 8), ("x4", 8), ("2x4x1", 8), ("-1x-8", 8), ("1x1", 1)]


@pytest.mark.parametrize("spec,n", GRAMMAR)
def test_mesh_shape_grammar_matches_jax(spec, n):
    try:
        want = ("ok", jax_parse(spec, n))
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", parse_mesh_shape(spec, n))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


# ---------------------------------------------------------------- mesh

def test_make_mesh_default_stays_1d(monkeypatch):
    monkeypatch.delenv("KTPU_MESH_SHAPE", raising=False)
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    mesh, jmesh = make_mesh(CPU8), jax_make_mesh()
    assert not is_2d(mesh)
    assert mesh.axis_names == jmesh.axis_names == ("data",)
    assert mesh.devices.shape == jmesh.devices.shape == (8,)
    assert policy_axis_size(mesh) == 1
    assert data_axis_size(mesh) == 8
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert mesh_from_env(CPU8) is None


@pytest.mark.parametrize("spec", ["2x4", "4x2", "auto", "1d"])
def test_env_selects_the_mesh_shape(monkeypatch, spec):
    from kyverno_tpu.parallel import mesh_from_env as jax_mesh_from_env

    monkeypatch.setenv("KTPU_MESH_SHAPE", spec)
    mesh, jmesh = mesh_from_env(CPU8), jax_mesh_from_env()
    assert mesh is not None
    assert mesh.axis_names == jmesh.axis_names
    assert mesh.devices.shape == jmesh.devices.shape
    assert mesh.shape == dict(jmesh.shape)


def test_explicit_shape_overrides_env(monkeypatch):
    monkeypatch.setenv("KTPU_MESH_SHAPE", "2x4")
    mesh = make_mesh(CPU8, shape=(4, 2))
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("policy", "data")
    assert policy_axis_size(mesh) == 4 and data_axis_size(mesh) == 2
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh(CPU8, shape=(2, 3))


def test_mesh_needs_a_card_unless_given_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(["cuda:0"])
    with pytest.raises(ValueError):
        Mesh(np.array(CPU8).reshape(2, 4), ("data",))


def test_1d_program_refuses_2d_mesh():
    cps = CompiledPolicySet([torch_load_policy(_mixed_docs()[0])],
                            device="cpu")
    with pytest.raises(ValueError, match="2D"):
        sharded_eval_fn(cps, make_mesh(CPU8, shape=(2, 4)))


# --------------------------------------------------------- K7's counts

@pytest.mark.parametrize("seed,B,R", [(0, 1, 1), (1, 37, 5), (2, 64, 33),
                                      (3, 300, 210), (4, 0, 7)])
def test_rule_counts_plain_matches_jnp_sum(seed, B, R):
    """Seeded int8 matrices holding every verdict code (HOST cells among
    them) and padded rows (all NOT_APPLICABLE), R not a multiple of 32."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 6, size=(B, R)).astype(np.int8)
    v[B - B // 4:] = Verdict.NOT_APPLICABLE          # padded rows
    fails, passes = ev.rule_counts_plain(torch.from_numpy(v))
    want_f = np.asarray(jnp.sum(jnp.asarray(v) == JAX_FAIL, axis=0))
    want_p = np.asarray(jnp.sum(jnp.asarray(v) == JAX_PASS, axis=0))
    assert fails.dtype == passes.dtype == torch.int32
    np.testing.assert_array_equal(fails.numpy(), want_f)
    np.testing.assert_array_equal(passes.numpy(), want_p)


def test_rule_counts_takes_the_plain_version_on_the_cpu_only():
    """K7's counts come from eval_rules_counts, whose CPU route is
    eval_rules_plain then rule_counts_plain over the live columns, with
    no launch counted."""
    _, tset = _sets(_mixed_docs())
    blob, shp = tset.to_device(tset.flatten_packed(
        [_mixed_pod(i) for i in range(40)]))
    plan = tset.plan
    live = plan.R - 1                                 # a live-column slice
    m = ev.match_matrix(plan, blob, *shp)
    saved = dict(_build.LAUNCHES)
    try:
        _build.reset_launches()
        v, fails, passes = ev.eval_rules_counts(plan, blob, *shp, m, live)
        assert set(_build.LAUNCHES.values()) == {0}
    finally:
        _build.LAUNCHES.update(saved)
    want = ev.eval_rules_plain(plan, blob, *shp, m)
    assert torch.equal(v, want)
    wf, wp = ev.rule_counts_plain(want[:, :live].contiguous())
    assert torch.equal(fails, wf) and torch.equal(passes, wp)
    with pytest.raises(ValueError, match="unsupported device"):
        ev.eval_rules_counts(plan, blob.to("meta"), *shp, m.to("meta"), live)


def test_evaluate_live_slices_the_verdicts():
    """evaluate_live_counts: K1 -> the counts form, the verdicts sliced
    to the live columns and counted over them."""
    _, tset = _sets(_mixed_docs())
    batch = tset.flatten_packed([_mixed_pod(i) for i in range(9)])
    blob, shp = tset.to_device(batch)
    live = tset.tensors.n_rules_live
    full = ev.evaluate_blob(tset.plan, blob, *shp)
    got, fails, passes = ev.evaluate_live_counts(tset.plan, blob, *shp, live)
    assert got.shape == (9, live)
    assert torch.equal(got, full[:, :live])
    wf, wp = ev.rule_counts_plain(full[:, :live])
    assert torch.equal(fails, wf) and torch.equal(passes, wp)
    with pytest.raises(ValueError, match="live"):
        ev.evaluate_live_counts(tset.plan, blob, *shp, tset.plan.R + 1)


@pytest.mark.parametrize("n,multiple", [(13, 8), (16, 8), (5, 3), (1, 1)])
def test_pad_batch_matches_jax(n, multiple):
    """FlatBatch padding to the mesh: every lane padded with its fill
    (flatten.PAD_FILL), equal to the JAX package's, and the padded rows
    score NOT_APPLICABLE."""
    from kyverno_tpu.models.flatten import flatten_batch as jax_flatten
    from kyverno_tpu.parallel import pad_batch as jax_pad_batch
    from kyverno_tpu_torch.models.flatten import BATCH_ARRAYS
    from kyverno_tpu_torch.parallel import pad_batch

    jset, tset = _sets(_mixed_docs())
    pods = [_mixed_pod(i) for i in range(n)]
    got, b = pad_batch(tset.flatten(pods), multiple)
    want, jb = jax_pad_batch(jax_flatten(pods, jset.tensors), multiple)
    assert b == jb == n and got.n == want.n == -(-n // multiple) * multiple
    for name in BATCH_ARRAYS + ("num_val",):
        a, w = getattr(got, name), getattr(want, name)
        assert a.dtype == w.dtype, name
        np.testing.assert_array_equal(a, w, err_msg=name)
    v = tset.evaluate_device(got)
    assert (v[n:] == Verdict.NOT_APPLICABLE).all()
    np.testing.assert_array_equal(v[:n], tset.evaluate_device(tset.flatten(pods)))


# ----------------------------------------------------- sharded_scan, 1D

@pytest.fixture(scope="module")
def crosscheck():
    return _sets(corpus_docs("crosscheck"))


def test_sharded_scan_matches_jax_on_13_pods(crosscheck):
    jset, tset = crosscheck
    resources = [make_pod(i) for i in range(13)]    # not a multiple of 8
    want = jax_sharded_scan(jset, resources, jax_make_mesh())
    got = sharded_scan(tset, resources, make_mesh(CPU8))
    _assert_scan_equal(got, want)
    np.testing.assert_array_equal(got[0], tset.evaluate(resources))


def test_sharded_scan_chunked_matches_jax(crosscheck):
    """A snapshot beyond chunk_size streams through the worker pool
    (3 workers); the result equals the JAX package's and the unchunked
    scan's."""
    jset, tset = crosscheck
    resources = [make_pod(i) for i in range(29)]
    want = jax_sharded_scan(jset, resources, jax_make_mesh())
    got = sharded_scan(tset, resources, make_mesh(CPU8), chunk_size=8,
                       flatten_workers=3)
    _assert_scan_equal(got, want)
    whole = sharded_scan(tset, resources, make_mesh(CPU8))
    _assert_scan_equal(got, whole)


def test_sharded_scan_resolves_host_lane():
    jset, tset = _sets([MIXED_LANES])
    assert bool(tset.tensors.rule_host_only[1])
    resources = [make_pod(i) for i in range(13)]
    want = jax_sharded_scan(jset, resources, jax_make_mesh())
    got = sharded_scan(tset, resources, make_mesh(CPU8))
    _assert_scan_equal(got, want)
    # the host rule passes every pod (name == itself after substitution)
    assert int(got[2][1]) == len(resources)
    np.testing.assert_array_equal(got[0], tset.evaluate(resources))


def test_sharded_scan_of_no_resources():
    _, tset = _sets([MIXED_LANES])
    v, f, p = sharded_scan(tset, [], make_mesh(CPU8))
    assert v.shape == (0, 2) and f.tolist() == [0, 0] and p.tolist() == [0, 0]


# ----------------------------------------------------- sharded_scan, 2D

@pytest.fixture(scope="module")
def mixed_scan():
    """The 1D scan of the mixed-lane corpus on both packages."""
    jset, tset = _sets(_mixed_docs())
    resources = [_mixed_pod(i) for i in range(23)]  # ragged
    want = jax_sharded_scan(jset, resources, jax_make_mesh())
    got = sharded_scan(tset, resources, make_mesh(CPU8))
    return jset, tset, resources, got, want


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_2d_scan_matches_1d_and_jax(mixed_scan, shape):
    jset, tset, resources, one_d, jax_1d = mixed_scan
    _assert_scan_equal(one_d, jax_1d)
    np.testing.assert_array_equal(one_d[0], tset.evaluate(resources))
    jsps = jax_shard_policies(jset.policies, shape[0])
    sps = shard_policies(tset.policies, shape[0], device="cpu")
    want = jax_sharded_scan(jsps, resources, jax_make_mesh(shape=shape))
    got = sharded_scan(sps, resources, make_mesh(CPU8, shape=shape))
    _assert_scan_equal(got, want)
    _assert_scan_equal(got, one_d)


def test_2d_chunked_pipeline_parity(mixed_scan):
    _, tset, resources, one_d, _ = mixed_scan
    sps = shard_policies(tset.policies, 2, device="cpu")
    mesh = make_mesh(CPU8, shape=(2, 4))
    got = sharded_scan(sps, resources, mesh, chunk_size=8, flatten_workers=3)
    _assert_scan_equal(got, one_d)


def test_plain_set_wrapped_on_the_fly(mixed_scan):
    jset, tset, resources, one_d, _ = mixed_scan
    got = sharded_scan(tset, resources, make_mesh(CPU8, shape=(4, 2)))
    _assert_scan_equal(got, one_d)
    want = jax_sharded_scan(jset, resources, jax_make_mesh(shape=(4, 2)))
    _assert_scan_equal(got, want)


def test_shard_programs_cache_on_the_shard(mixed_scan):
    from kyverno_tpu_torch.parallel.mesh import shard_eval_fns

    _, tset, _, _, _ = mixed_scan
    sps = shard_policies(tset.policies, 2, device="cpu")
    mesh = make_mesh(CPU8, shape=(2, 4))
    first = shard_eval_fns(sps, mesh)
    again = shard_eval_fns(sps, mesh)
    assert [fn for _, fn in first] == [fn for _, fn in again]
    with pytest.raises(ValueError, match="policy axis"):
        shard_eval_fns(sps, make_mesh(CPU8, shape=(4, 2)))
    with pytest.raises(ValueError, match="2D"):
        shard_eval_fns(sps, make_mesh(CPU8))
