"""The streaming admission plane on the port: the wire codec
(``models/flatten.py``), ``runtime/stream_server.py`` and its two
transports, against the JAX package's on the CPU.

- The JAX package's battery ``tests/runtime/test_stream_server.py``, case
  by case, on the port (``torch_parity.mirror_battery``; the JAX side of
  each case is the battery's own file), with the policy cache on
  ``device="cpu"``. Its grpc case keeps its ``importorskip("grpc")``.
- The codec across packages: rows and blocks of seeded resources, encoded
  by each package, are the same bytes, and each package decodes the
  other's frames into read-only views equal to what was encoded.
- Clients and servers across packages: a JAX ``StreamClient`` against the
  port's ``StreamServer`` and the port's client against the JAX server,
  on both transports, answer JSON, ROW and BLOCK frames as each
  package's own pair does. Both batchers run the JAX tests'
  deterministic routing with screens that cannot time out, so the lane
  an answer takes does not depend on the host's load.
"""

import copy
import random

import numpy as np
import pytest

import chip_smoke
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import flatten as jax_flatten
from kyverno_tpu.runtime import batch as jax_batch
from kyverno_tpu.runtime import client as jax_client
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu.runtime import policycache as jax_policycache
from kyverno_tpu.runtime import stream_server as jax_stream
from kyverno_tpu.runtime import webhook as jax_webhook
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import flatten as torch_flatten
from kyverno_tpu_torch.runtime import batch as torch_batch
from kyverno_tpu_torch.runtime import client as torch_client
from kyverno_tpu_torch.runtime import hostlane as torch_hostlane
from kyverno_tpu_torch.runtime import policycache as torch_policycache
from kyverno_tpu_torch.runtime import stream_server as torch_stream
from kyverno_tpu_torch.runtime import webhook as torch_webhook
from tests.torch_parity import (both_sets, corpus_docs, corpus_resources,
                                mirror_battery, random_pod)
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

_CPU_CACHE = ("PolicyCache()", 'PolicyCache(device="cpu")')

globals().update(mirror_battery("tests/runtime/test_stream_server.py",
                                (_CPU_CACHE,)))


@pytest.fixture(autouse=True)
def _detach_host_lane_pools():
    """A webhook server attaches its oracle pool to its package's
    process-wide host lane: detach both after each case."""
    yield
    for mod in (jax_hostlane, torch_hostlane):
        mod.resolver().attach_pool(None, None)


# ------------------------------------------------------------ the codec

CORPORA = ("anchor", "wide", "fuzz3", "library250")
N_RESOURCES = 12


def _sets_and_resources(corpus: str):
    docs = corpus_docs(corpus)
    if corpus == "library250":
        docs = docs[::10]
    jset, tset = both_sets(docs)
    return jset, tset, corpus_resources(corpus, N_RESOURCES)


def _row_arrays(row) -> tuple:
    return (np.asarray(row.cells), int(row.bmeta), np.asarray(row.str_bytes),
            np.asarray(row.dictv))


def _block_arrays(block) -> tuple:
    return (int(block.n), int(block.e), np.asarray(block.cells),
            np.asarray(block.bmeta), np.asarray(block.str_bytes),
            np.asarray(block.dictv))


def _equal(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("corpus", CORPORA)
def test_rows_encode_to_the_same_bytes(corpus):
    jset, tset, resources = _sets_and_resources(corpus)
    jrows = jax_stream.flatten_rows_for_wire(jset, resources)
    trows = torch_stream.flatten_rows_for_wire(tset, resources)
    assert len(jrows) == len(trows) == N_RESOURCES
    for jr, tr in zip(jrows, trows):
        jb = jax_flatten.encode_packed_row(jr)
        tb = torch_flatten.encode_packed_row(tr)
        assert jb == tb


@pytest.mark.parametrize("corpus", CORPORA)
def test_blocks_encode_to_the_same_bytes(corpus):
    jset, tset, resources = _sets_and_resources(corpus)
    jb = jax_flatten.encode_packed_block(
        jax_stream.flatten_block_for_wire(jset, resources))
    tb = torch_flatten.encode_packed_block(
        torch_stream.flatten_block_for_wire(tset, resources))
    assert jb == tb


@pytest.mark.parametrize("writer,reader", [(jax_flatten, torch_flatten),
                                           (torch_flatten, jax_flatten)])
@pytest.mark.parametrize("corpus", CORPORA)
def test_each_package_decodes_the_others_frames(corpus, writer, reader):
    """A frame of several rows then a block, written by one package, read
    by the other at its offsets: read-only views equal to what was
    written, and the reader's encoding of them is the writer's bytes."""
    jset, tset, resources = _sets_and_resources(corpus)
    cps, stream = ((jset, jax_stream) if writer is jax_flatten
                   else (tset, torch_stream))
    rows = stream.flatten_rows_for_wire(cps, resources)
    block = stream.flatten_block_for_wire(cps, resources)
    buf = b"".join([writer.encode_packed_row(r) for r in rows]
                   + [writer.encode_packed_block(block)])
    off = 0
    for row in rows:
        back, off = reader.decode_packed_row(buf, off)
        assert _equal(_row_arrays(back), _row_arrays(row))
        assert not back.cells.flags.writeable
        assert not back.dictv.flags.writeable
        assert reader.encode_packed_row(back) == writer.encode_packed_row(row)
    back, off = reader.decode_packed_block(buf, off)
    assert off == len(buf)
    assert _equal(_block_arrays(back), _block_arrays(block))
    assert not back.cells.flags.writeable
    assert not back.str_bytes.flags.writeable
    assert (reader.encode_packed_block(back)
            == writer.encode_packed_block(block))


def test_payload_codec_is_the_same_bytes():
    """The frame envelopes: JSON, ROW and BLOCK admission frames with and
    without a traceparent, verdict and error frames."""
    jset, tset, resources = _sets_and_resources("anchor")
    tp = "00-" + "ab" * 16 + "-00000000000000a1-01"
    review = {"request": {"uid": "u", "object": resources[0]}}
    for t in (None, tp):
        assert (jax_stream.encode_json_frame(7, review, traceparent=t)
                == torch_stream.encode_json_frame(7, review, traceparent=t))
        jrow = jax_stream.flatten_rows_for_wire(jset, resources[:1])[0]
        trow = torch_stream.flatten_rows_for_wire(tset, resources[:1])[0]
        assert (jax_stream.encode_row_frame(8, "Pod", "ns", jrow,
                                            traceparent=t)
                == torch_stream.encode_row_frame(8, "Pod", "ns", trow,
                                                 traceparent=t))
        jblk = jax_stream.flatten_block_for_wire(jset, resources)
        tblk = torch_stream.flatten_block_for_wire(tset, resources)
        assert (jax_stream.encode_block_frame(9, "Pod", "ns", jblk,
                                              traceparent=t)
                == torch_stream.encode_block_frame(9, "Pod", "ns", tblk,
                                                   traceparent=t))
    for ftype in (jax_stream.F_VERDICT, jax_stream.F_ERROR):
        p = jax_stream.encode_payload(ftype, 3, b"body", traceparent=tp)
        assert p == torch_stream.encode_payload(ftype, 3, b"body",
                                                traceparent=tp)
        assert (jax_stream.decode_payload_ex(p)
                == torch_stream.decode_payload_ex(p))


# ------------------------------------- clients and servers across packages

SEED = 20261018
N_FRAMES = 8


def _library() -> list[dict]:
    """One policy of each family of the synthetic library (its host-lane
    slice included), in enforce mode."""
    seen, docs = set(), []
    for d in chip_smoke._synth_policy_docs(250):
        fam = d["metadata"]["name"].rsplit("-v", 1)[0]
        if fam not in seen:
            seen.add(fam)
            d = copy.deepcopy(d)
            d["spec"]["validationFailureAction"] = "enforce"
            docs.append(d)
    return docs


LIBRARY = _library()


def _pods(n: int = N_FRAMES) -> list[dict]:
    rng = random.Random(SEED)
    out = []
    for i in range(n):
        pod = random_pod(rng)
        pod["metadata"]["namespace"] = "default"
        pod["metadata"]["name"] = f"pod-{i}"
        out.append(pod)
    return out


def _review(resource: dict, i: int) -> dict:
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": f"u{i}", "kind": {"kind": "Pod"},
                        "namespace": "default", "operation": "CREATE",
                        "object": resource}}


class _Stack:
    """One package's stream server over its webhook, its batcher pinned
    to the device lane with screens that cannot time out."""

    def __init__(self, name: str, transport: str):
        if name == "jax":
            load, batch, client, pc, webhook, stream = (
                jax_load_policy, jax_batch, jax_client, jax_policycache,
                jax_webhook, jax_stream)
            cache = pc.PolicyCache()
        else:
            load, batch, client, pc, webhook, stream = (
                torch_load_policy, torch_batch, torch_client,
                torch_policycache, torch_webhook, torch_stream)
            cache = pc.PolicyCache(device="cpu")
        self.stream = stream
        for d in LIBRARY:
            cache.add(load(copy.deepcopy(d)))
        b = batch.AdmissionBatcher(
            cache, window_s=0.002, burst_threshold=1, continuous=True,
            dispatch_cost_init_s=0.0, oracle_cost_init_s=1.0,
            cold_flush_fallback=False, result_cache_ttl_s=0.0)
        b._device_favored = lambda *a, **k: True
        for name_ in ("screen", "screen_row"):
            fn = getattr(b, name_)

            def patient(*a, _fn=fn, **k):
                k.update(deadline_free=True, timeout_s=300.0)
                return _fn(*a, **k)

            setattr(b, name_, patient)
        self.batcher = b
        self.server = webhook.WebhookServer(
            policy_cache=cache, client=client.FakeCluster(),
            admission_batcher=b)
        self.server.oracle_pool.stop()
        self.server.oracle_pool = None
        self.cps = cache.compiled(pc.PolicyType.VALIDATE_ENFORCE, "Pod",
                                  "default")
        self.ss = stream.StreamServer(self.server, b, None,
                                      transport=transport).start()
        assert self.ss.transport_name == transport

    def close(self) -> None:
        self.ss.stop()
        self.server.stop()
        self.batcher.stop()


def _answers(client_stack: _Stack, server_stack: _Stack, frame: str,
             transport: str) -> list:
    """Frames tokenized by the client's package (its own compiled set of
    the same policies) to the server's stream port."""
    cl = client_stack.stream.StreamClient(server_stack.ss.port,
                                          transport=transport)
    pods = _pods()
    try:
        if frame == "json":
            ids = [cl.submit_json(_review(p, i)) for i, p in enumerate(pods)]
        elif frame == "row":
            rows = client_stack.stream.flatten_rows_for_wire(
                client_stack.cps, pods)
            ids = [cl.submit_row("Pod", "default", r) for r in rows]
        else:
            half = len(pods) // 2
            ids = [cl.submit_block(
                "Pod", "default", client_stack.stream.flatten_block_for_wire(
                    client_stack.cps, chunk))
                for chunk in (pods[:half], pods[half:])]
        return [cl.result(i, timeout=300.0) for i in ids]
    finally:
        cl.close()


@pytest.mark.parametrize("frame", ["json", "row", "block"])
@pytest.mark.parametrize("transport", ["socket", "grpc"])
def test_clients_and_servers_answer_alike_across_packages(transport, frame):
    if transport == "grpc":
        pytest.importorskip("grpc")
    stacks = {name: _Stack(name, transport) for name in ("jax", "torch")}
    try:
        got = {(c, s): _answers(stacks[c], stacks[s], frame, transport)
               for c in ("jax", "torch") for s in ("jax", "torch")}
    finally:
        for st in stacks.values():
            st.close()
    want = got[("jax", "jax")]
    for pair, answers in got.items():
        assert answers == want, pair
    if frame == "json":
        allowed = [a["response"]["allowed"] for a in want]
    elif frame == "row":
        allowed = [a["allowed"] for a in want]
    else:
        allowed = [r["allowed"] for a in want for r in a["rows"]]
    assert len(allowed) == N_FRAMES
    assert True in allowed and False in allowed
    for s in ("jax", "torch"):
        assert not stacks[s].ss.plane.stats.get("frame_errors")
