"""The CPU oracle: the port's JMESPath, variable substitution and
``validate`` against the JAX package's, exactly — results, error types
and messages, not only statuses.

(a) JMESPath over the expressions and documents of the JAX package's
unit tests (one case per expression) and a set of number and string
formatting cases; context queries and ``substitute_all`` over the
documents of its context tests.
(b) ``validate``: every rule's status and message for every (policy,
resource) pair of the policy files, the cross-check corpora, the anchor
corpus, the deny-only set, a store-backed ``context:`` rule and the
request-reading host rules under their admission payloads.
"""

import random

import numpy as np
import pytest

import chip_smoke
from kyverno_tpu.engine import jmespath as jax_jp
from kyverno_tpu.engine import variables as jax_vars
from kyverno_tpu.engine.context import Context as JaxContext
from kyverno_tpu_torch.engine import jmespath as torch_jp
from kyverno_tpu_torch.engine import variables as torch_vars
from kyverno_tpu_torch.engine.context import Context as TorchContext
from tests.ops.test_cross_check import random_pod
from tests.torch_parity import (
    JMESPATH_FORMAT_CASES,
    REQUEST_POLICIES,
    STORE_CONTEXT_POLICY,
    SUBSTITUTE_DOCS,
    build_context,
    context_expressions,
    corpus_docs,
    jmespath_cases,
    mock_stores,
    policy_files,
    request_payload,
    request_resources,
    validate_rows,
)


def _outcome(fn, *args):
    """(kind, value): the result, or the error's class name and text."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # the error itself is what is compared
        return type(e).__name__, str(e)


def _same(a, b) -> bool:
    """Equal values of equal types all the way down (1 != 1.0 != True)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)


def _assert_same(want, got):
    assert want[0] == got[0], (want, got)
    if want[0] == "ok":
        assert _same(want[1], got[1]), (want, got)
    else:
        assert want[1] == got[1], (want, got)


JP_CASES = jmespath_cases() + JMESPATH_FORMAT_CASES


def test_jmespath_cases_cover_the_unit_tests():
    assert len(jmespath_cases()) >= 60
    assert any(e.startswith("regex_replace_all(") for e, _ in JP_CASES)


@pytest.mark.parametrize("expr,doc", JP_CASES,
                         ids=[f"{i}:{e[:40]}" for i, (e, _) in enumerate(JP_CASES)])
def test_jmespath_search(expr, doc):
    _assert_same(_outcome(jax_jp.search, expr, doc),
                 _outcome(torch_jp.search, expr, doc))


CTX_EXPRS = context_expressions()


@pytest.mark.parametrize("expr", CTX_EXPRS)
def test_context_query(expr):
    jctx, tctx = build_context(JaxContext), build_context(TorchContext)
    assert _same(jctx.snapshot(), tctx.snapshot())
    _assert_same(_outcome(jax_jp.search, expr, jctx.snapshot()),
                 _outcome(torch_jp.search, expr, tctx.snapshot()))
    _assert_same(_outcome(jctx.query, expr), _outcome(tctx.query, expr))


@pytest.mark.parametrize("i", range(len(SUBSTITUTE_DOCS)))
def test_substitute_all(i):
    doc = SUBSTITUTE_DOCS[i]
    jctx, tctx = build_context(JaxContext), build_context(TorchContext)
    for jfn, tfn in ((jax_vars.substitute_all, torch_vars.substitute_all),
                     (jax_vars.substitute_all_in_preconditions,
                      torch_vars.substitute_all_in_preconditions)):
        _assert_same(_outcome(jfn, jctx, doc), _outcome(tfn, tctx, doc))


def test_substitute_references():
    for doc in ({"validate": {"pattern": {"spec": {"cpu": "4",
                                                   "limit": "$(../cpu)"}}}},
                {"a": {"b": "val", "c": {"d": "$(../../b)"}}},
                {"spec": {"min": "2", "check": "$(<=../min)"}},
                {"a": "$(./nope)"}, {"a": "\\$(keep)"}):
        _assert_same(_outcome(jax_vars.substitute_references, doc),
                     _outcome(torch_vars.substitute_references, doc))


# ------------------------------------------------------------- validate

def _pods(n: int) -> list[dict]:
    rng = random.Random(20260729)
    return [random_pod(rng) for _ in range(n)]


def _resources(n: int) -> list[dict]:
    rng = np.random.default_rng(7)
    return [chip_smoke.random_resource(rng) for _ in range(n)]


def _validate_corpus(docs, resources, payloads=None) -> dict:
    """Compares every pair; returns the statuses seen, so that a test can
    assert its corpus reached them."""
    seen: dict[str, int] = {}
    for d in docs:
        for i, res in enumerate(resources):
            p = payloads[i] if payloads is not None else None
            want = validate_rows("jax", d, res, p)
            got = validate_rows("torch", d, res, p)
            assert got == want, (d["metadata"]["name"], i)
            for _, status, _ in got:
                seen[status] = seen.get(status, 0) + 1
    return seen


VALIDATE_CORPORA = {
    "policy_files": (lambda: [d for f in policy_files()
                              for d in corpus_docs("file:" + f.rsplit("/", 1)[1])],
                     lambda: _pods(24)),
    "crosscheck": (lambda: corpus_docs("crosscheck"), lambda: _pods(24)),
    "anchor": (lambda: chip_smoke.anchor_policy_docs(7), lambda: _resources(24)),
    "deny_only": (lambda: corpus_docs("deny_only"), lambda: _resources(48)),
}


@pytest.mark.parametrize("corpus", list(VALIDATE_CORPORA))
def test_validate_statuses_and_messages(corpus):
    docs, resources = (f() for f in VALIDATE_CORPORA[corpus])
    seen = _validate_corpus(docs, resources)
    assert "PASS" in seen and ("FAIL" in seen or "ERROR" in seen), seen
    if corpus in ("crosscheck", "anchor"):
        assert {"PASS", "FAIL", "SKIP", "ERROR"} <= set(seen), seen


@pytest.mark.parametrize("values", [{"registries.allowed": "docker.io"},
                                    {"registries.allowed": "quay.io"}, None],
                         ids=["allowed", "denied", "undeclared"])
def test_validate_store_backed_context(values):
    with mock_stores(values):
        seen = _validate_corpus([STORE_CONTEXT_POLICY], _pods(6))
    want = {"allowed": "PASS", "denied": "FAIL", "undeclared": "ERROR"}
    key = "undeclared" if values is None else (
        "allowed" if values["registries.allowed"] == "docker.io" else "denied")
    assert set(seen) == {want[key]} and seen[want[key]] >= 2, seen


def test_validate_with_admission_payloads():
    resources = request_resources(30)
    payloads = [request_payload(i, r) for i, r in enumerate(resources)]
    seen = _validate_corpus(REQUEST_POLICIES, resources, payloads)
    assert {"PASS", "FAIL", "ERROR"} <= set(seen), seen
