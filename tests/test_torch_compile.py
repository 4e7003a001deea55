"""Port compiler parity: every field of kyverno_tpu_torch's PolicyTensors
equals the JAX package's compile of the same policies, exactly."""

import os

import numpy as np
import pytest

from tests.torch_parity import (
    FUZZ_SEEDS,
    both_sets,
    corpus_docs,
    policy_files,
    tensor_fields,
)

CORPORA = (["library250", "crosscheck", "deny_only"]
           + [f"fuzz{s}" for s in FUZZ_SEEDS]
           + ["file:" + os.path.basename(p) for p in policy_files()])

# host-side provenance: the rule IRs are objects of each package, compared
# through their public summary below; segment spans are assembled alike
_OBJECT_FIELDS = {"rules", "segments"}


@pytest.mark.parametrize("corpus", CORPORA)
def test_policy_tensors_equal(corpus):
    jset, tset = both_sets(corpus_docs(corpus))
    jf, tf = tensor_fields(jset.tensors), tensor_fields(tset.tensors)
    assert jf.keys() == tf.keys()
    for name, a in jf.items():
        b = tf[name]
        if name in _OBJECT_FIELDS:
            continue
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), name
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            assert a.shape == b.shape and np.array_equal(a, b), name
        elif name == "dict_base":
            assert (a is None) == (b is None), name
        else:
            assert a == b, (name, a, b)
    assert len(jset.tensors.segments) == len(tset.tensors.segments)
    for sa, sb in zip(jset.tensors.segments, tset.tensors.segments):
        assert vars(sa) == vars(sb)
    # rule IRs: the same routing decision and reason for every rule
    assert [(r.rule_name, r.host_only, r.host_reason_code)
            for r in jset.rule_irs] == \
        [(r.rule_name, r.host_only, r.host_reason_code) for r in tset.rule_irs]


def test_library_shape():
    """The 250-policy library at full width: 250 rules, 2 host-only,
    248 check rows, 248 aux rows, 3 NFA patterns of 48 states."""
    _, tset = both_sets(corpus_docs("library250"))
    t = tset.tensors
    assert t.n_rules == 250 and int(t.rule_host_only.sum()) == 2
    assert t.chk_op.size == 248 and t.ax_op.size == 248
    assert t.nfa_char.shape == (3, 48)


def test_crosscheck_reaches_gates_and_conditions():
    """The cross-check corpora are the ones that compile to gate and
    condition rows, so the eval parity tests cover stage 3 whole."""
    _, tset = both_sets(corpus_docs("crosscheck"))
    t = tset.tensors
    assert t.n_gates >= 1 and int(t.chk_is_cond.sum()) >= 1
    assert int((t.chk_track_depth >= 0).sum()) >= 2
