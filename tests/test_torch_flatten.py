"""Port flattener parity: the packed blob is byte-identical to the JAX
package's, and the unpacked lanes — the port's numpy ``unpack_batch`` and
the plain PyTorch decode of the blob (K2) — equal ``unpack_batch(xp=np)``."""

import numpy as np
import pytest
import torch

from kyverno_tpu.models.flatten import (
    BATCH_ARRAYS,
    DICT_ARRAYS,
    unpack_batch as jax_unpack_batch,
)
from kyverno_tpu.ops.eval import _split_blob
from kyverno_tpu_torch.convert import batch_from_numpy
from kyverno_tpu_torch.models.flatten import pad_to_buckets, unpack_batch
from kyverno_tpu_torch.ops.eval import blob_parts, unpack_lanes_plain
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import both_sets, corpus_docs, corpus_resources

CASES = [("library250", 300), ("crosscheck", 120), ("fuzz3", 80),
         ("fuzz17", 80)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def flat_pair(request):
    corpus, n = request.param
    jset, tset = both_sets(corpus_docs(corpus))
    resources = corpus_resources(corpus, n)
    return jset.flatten(resources), tset.flatten(resources)


def test_packed_blob_byte_identical(flat_pair):
    jb, tb = flat_pair
    (jblob, jshp), (tblob, tshp) = jb.packed_blob(), tb.packed_blob()
    assert jshp == tshp
    assert jblob.dtype == tblob.dtype == np.uint32
    assert jblob.tobytes() == tblob.tobytes()


def test_unpacked_lanes_equal(flat_pair):
    jb, tb = flat_pair
    want = jax_unpack_batch(*jb.packed_args(), xp=np)
    got_np = unpack_batch(*tb.packed_args(), xp=np)
    blob, shp = tb.packed_blob()
    got_t = unpack_lanes_plain(torch.from_numpy(blob.view(np.int32)), *shp)
    names = BATCH_ARRAYS + DICT_ARRAYS
    assert len(want) == len(got_np) == len(got_t) == len(names)
    for name, w, a, t in zip(names, want, got_np, got_t):
        assert w.dtype == a.dtype and np.array_equal(w, a), name
        assert np.array_equal(w.astype(np.int64),
                              t.numpy().astype(np.int64)), name


def test_blob_split_matches(flat_pair):
    """The port's views of the blob are the JAX package's _split_blob."""
    _, tb = flat_pair
    blob, shp = tb.packed_blob()
    cells, bmeta, str_bytes, dictv = (np.asarray(x) for x in _split_blob(blob, *shp))
    c, b, d, s = blob_parts(torch.from_numpy(blob.view(np.int32)), *shp)
    assert np.array_equal(cells.reshape(-1).view(np.int32), c.numpy())
    assert np.array_equal(bmeta.view(np.int32), b.numpy())
    assert np.array_equal(dictv.view(np.int32), d.numpy())
    assert np.array_equal(str_bytes, s.numpy())


def test_bucket_padding_and_carried_batch():
    """pad_to_buckets equals the JAX package's, and a batch carried across
    from the packed arrays gives the same blob."""
    from kyverno_tpu.models.flatten import pad_to_buckets as jax_pad

    jset, tset = both_sets(corpus_docs("crosscheck"))
    resources = corpus_resources("crosscheck", 37)
    (jp, jn), (tp, tn) = jax_pad(jset.flatten(resources)), pad_to_buckets(
        tset.flatten(resources))
    assert jn == tn and jp.packed_blob()[0].tobytes() == tp.packed_blob()[0].tobytes()
    carried = batch_from_numpy(*jp.packed_args())
    assert carried.packed_blob()[0].tobytes() == jp.packed_blob()[0].tobytes()
