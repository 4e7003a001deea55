"""Shared inputs and JAX-side references for the tests/test_torch_*.py
parity suite: the PyTorch port (``kyverno_tpu_torch``, on the CPU, where
every kernel wrapper runs its plain PyTorch version) against the JAX
package on the same inputs.

The CPU oracle's inputs are here too: the JMESPath cases of the JAX
package's own unit tests (read from their sources), the documents of its
context tests, the policies of the validate corpora, a store-backed
``context:`` rule, and host-lane rules that read the admission request
with the request payloads they read.

The JAX side runs ``build_eval_fn_blob``, its own device entry, jitted: at
the suite's small batches one compile costs 2-5 s, about a quarter of the
first eager run of the same program.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import glob as _glob
import os
import random
import re
from dataclasses import fields

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from kyverno_tpu.analysis import difffuzz
from kyverno_tpu.api.load import load_policies_from_path
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import CompiledPolicySet as JaxPolicySet
from kyverno_tpu.models.flatten import flatten_batch as jax_flatten_batch
from kyverno_tpu.ops.eval import build_eval_fn_blob, build_scan_fn_blob
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models import CompiledPolicySet as TorchPolicySet
from tests.ops.test_cross_check import (
    ADVERSARIAL_POLICIES,
    SYNTHETIC_POLICIES,
    random_pod,
)

POLICY_DIR = os.path.join(os.path.dirname(__file__), "policies")
FUZZ_SEEDS = (3, 17, 41)

DENY_ONLY = [
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "deny-ns"},
     "spec": {"rules": [{
         "name": "deny-ns", "match": {"resources": {"kinds": ["Pod"]}},
         "validate": {"deny": {"conditions": {"any": [
             {"key": "{{ request.object.metadata.namespace }}",
              "operator": "In", "value": ["prod", "dev"]}]}}}}]}},
    {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
     "metadata": {"name": "deny-replicas"},
     "spec": {"rules": [{
         "name": "deny-replicas",
         "match": {"resources": {"kinds": ["Deployment"]}},
         "validate": {"deny": {"conditions": {"all": [
             {"key": "{{ request.object.spec.replicas }}",
              "operator": "GreaterThan", "value": 3}]}}}}]}},
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the plain versions on the CPU while a
    module runs. The suite runs in several processes at once, and
    PyTorch's default of a thread a core then oversubscribes the cores:
    a plain kernel's many small operations take tens of times longer.
    The results are integers either way. Import it into a test module to
    apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def policy_files() -> list[str]:
    return sorted(_glob.glob(os.path.join(POLICY_DIR, "*.yaml")))


def corpus_docs(name: str) -> list[dict]:
    """Policy documents of a named corpus (YAML files load on the JAX
    side and are handed over as their raw dicts)."""
    if name == "library250":
        return bench._synth_policy_docs(250)
    if name == "library1000":
        return bench._synth_policy_docs(1000)
    if name == "crosscheck":
        return SYNTHETIC_POLICIES + ADVERSARIAL_POLICIES
    if name == "deny_only":
        return DENY_ONLY
    if name == "wide":
        return chip_smoke.wide_policy_docs()
    if name == "anchor":
        return chip_smoke.anchor_policy_docs(7)
    if name.startswith("fuzz"):
        seed = int(name[4:])
        return difffuzz.gen_policy_docs(random.Random(seed), seed, n_policies=6)
    if name.startswith("file:"):
        return [p.raw for p in load_policies_from_path(
            os.path.join(POLICY_DIR, name[5:]))]
    raise KeyError(name)


def corpus_resources(name: str, n: int) -> list[dict]:
    if name == "library250":
        return [bench.mixed_resource(i) for i in range(n)]
    if name == "wide":
        rng = np.random.default_rng(3)
        return [chip_smoke.wide_resource(rng, containers=16 if i == 0 else 0)
                for i in range(n)]
    if name == "anchor":
        rng = np.random.default_rng(11)
        return [chip_smoke.random_resource(rng) for _ in range(n)]
    if name.startswith("fuzz"):
        rng = random.Random(1000 + int(name[4:]))
        return [difffuzz.gen_resource(rng, rng.choice(("Pod", "Deployment",
                                                       "Scale")))
                for _ in range(n)]
    rng = random.Random(20260729)
    return [random_pod(rng) for _ in range(n)]


# A kind no policy names: the device's kind prefilter of every host-only
# rule lets it through (unknown kinds and the padding share one id), and
# the oracle answers NOT_APPLICABLE.
UNKNOWN_KIND = {"apiVersion": "example.io/v1", "kind": "Widget",
                "metadata": {"name": "w-1", "namespace": "prod"},
                "spec": {"containers": [{"name": "web", "image": "nginx:latest"}]}}


def both_sets(docs: list[dict]):
    """(JAX CompiledPolicySet, port CompiledPolicySet on the CPU)."""
    jset = JaxPolicySet([jax_load_policy(d) for d in docs])
    tset = TorchPolicySet([torch_load_policy(d) for d in docs], device="cpu")
    return jset, tset


def tensor_fields(tensors) -> dict:
    """Every dataclass field of a PolicyTensors, keyed by name."""
    return {f.name: getattr(tensors, f.name) for f in fields(tensors)}


def jax_blob(jset, resources):
    return jax_flatten_batch(resources, jset.tensors).packed_blob()


def jax_verdicts(jset, resources) -> np.ndarray:
    blob, shp = jax_blob(jset, resources)
    v = np.asarray(build_eval_fn_blob(jset.tensors)(blob, *shp))
    return v[:, :jset.tensors.n_rules_live]


def jax_scan(jset, resources):
    blob, shp = jax_blob(jset, resources)
    return tuple(np.asarray(x) for x in build_scan_fn_blob(jset.tensors)(blob, *shp))


# ---------------------------------------------------------------- oracle

UNIT_DIR = os.path.join(os.path.dirname(__file__), "unit")


def _literal(node):
    try:
        return True, ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return False, None


def jmespath_cases() -> list[tuple[str, object]]:
    """Every ``(expression, document)`` that tests/unit/test_jmespath.py
    searches: the literal arguments of its ``search`` calls and the rows
    of its ``parametrize`` tables (``{}`` where a table has no document),
    in source order, each pair once."""
    tree = ast.parse(open(os.path.join(UNIT_DIR, "test_jmespath.py")).read())
    cases: list[tuple[str, object]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "search" and len(node.args) == 2:
            ok_e, expr = _literal(node.args[0])
            ok_d, doc = _literal(node.args[1])
            if ok_e and ok_d:
                cases.append((expr, doc))
        elif isinstance(fn, ast.Attribute) and fn.attr == "parametrize":
            ok, names = _literal(node.args[0])
            if not ok or "expr" not in names.split(","):
                continue
            names = [n.strip() for n in names.split(",")]
            ok, rows = _literal(node.args[1])
            for row in rows if ok else ():
                doc = row[names.index("data")] if "data" in names else {}
                cases.append((row[names.index("expr")], doc))
    out, seen = [], set()
    for expr, doc in cases:
        key = (expr, repr(doc))
        if key not in seen:
            seen.add(key)
            out.append((expr, doc))
    return out


# Number, string and object formatting through the kyverno functions and
# the core ones, where a port most easily drifts by a byte.
JMESPATH_FORMAT_CASES = [
    ("divide(`1`, `3`)", {}),
    ("divide(`7`, `2`)", {}),
    ("multiply(`1.5`, `3`)", {}),
    ("add(`0.1`, `0.2`)", {}),
    ("subtract(`1e21`, `1`)", {}),
    ("modulo(`7.5`, `2`)", {}),
    ("modulo(`7`, `0`)", {}),
    ("to_string(a)", {"a": 1.5}),
    ("to_string(a)", {"a": {"k": [1, True, None, "x"]}}),
    ("to_string(a)", {"a": 1e21}),
    ("to_number('1e3')", {}),
    ("to_number('0x10')", {}),
    ("join(', ', a)", {"a": ["x", "y"]}),
    ("join(', ', a)", {"a": ["x", 1]}),
    ("sum(a)", {"a": [1, 2.5]}),
    ("avg(a)", {"a": [1, 2]}),
    ("max(a)", {"a": ["b", "a"]}),
    ("length(a)", {"a": "\u00e9\u00e9"}),
    ("split(a, '')", {"a": "ab"}),
    ("regex_match('^[0-9]+$', `1.5`)", {}),
    ("base64_decode('!!')", {}),
    ("compare(`1`, 'a')", {}),
    ("a[?b == `1.0`].c", {"a": [{"b": 1, "c": "int"}, {"b": 1.0, "c": "float"}]}),
    ("contains(a, `1`)", {"a": [1.0]}),
]


def context_expressions() -> list[str]:
    """The JMESPath expressions of tests/unit/test_context_variables.py:
    the arguments of its ``query`` calls and the insides of the
    ``{{...}}`` variables in its string literals, each once."""
    tree = ast.parse(open(
        os.path.join(UNIT_DIR, "test_context_variables.py")).read())
    exprs: list[str] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("query", "has_changed") and node.args):
            ok, e = _literal(node.args[0])
            if ok and isinstance(e, str):
                exprs.append(e)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            exprs.extend(m.strip() for m in re.findall(r"\{\{([^{}]*)\}\}",
                                                       node.value))
    return sorted(set(exprs))


def build_context(ctx_cls) -> object:
    """A context holding every document tests/unit/test_context_variables.py
    builds: the resource and its old version, nested variables, a service
    account and a pod's images."""
    ctx = ctx_cls()
    ctx.add_resource({
        "metadata": {"name": "mypod", "namespace": "prod",
                     "labels": {"app": "web", "app-name": "x"}},
        "spec": {"replicas": 3, "cpu": 1.5, "big": 1e21,
                 "containers": [{"name": "c", "image": "nginx:latest"}]}})
    ctx.add_old_resource({"metadata": {"name": "gone"},
                          "spec": {"replicas": 1}})
    ctx.add_json({"inner": "{{request.object.metadata.name}}",
                  "cfg": {"n": "{{request.object.metadata.name}}"},
                  "x": 1, "a": {"x": 1}})
    ctx.add_service_account("system:serviceaccount:kube-system:builder")
    ctx.add_image_info({"kind": "Pod", "spec": {"containers": [
        {"name": "c", "image": "nginx:latest"},
        {"name": "r", "image": "quay.io/org/app@sha256:" + "a" * 64}]}})
    return ctx


# Documents for substitute_all: those of the context tests, and messages
# that turn non-strings (numbers, bools, null, objects) into strings.
SUBSTITUTE_DOCS = [
    {"message": "name is {{request.object.metadata.name}}"},
    {"replicas": "{{request.object.spec.replicas}}"},
    {"msg": "labels: {{request.object.metadata.labels}}"},
    {"{{request.object.metadata.name}}-suffix": 1},
    {"m": "literal \\{{not.a.var}} kept"},
    {"m": "x-{{inner}}"},
    {"m": "{{inner}}"},
    {"v": "{{cfg}}"},
    {"m": "cpu {{request.object.spec.cpu}} big {{request.object.spec.big}}"},
    {"m": "replicas {{request.object.spec.replicas}} of {{ x }}"},
    {"m": "old {{request.oldObject.spec.replicas}} images "
          "{{images.containers.r.digest}}"},
    {"m": "sa {{serviceAccountName}}/{{serviceAccountNamespace}}"},
    {"m": "{{request.object.metadata.labels.app-name}}"},
    {"m": "missing {{request.object.nope}}"},
    {"m": "{{ divide(`1`, `3`) }} and {{ to_string(`true`) }} and {{ `null` }}"},
    {"m": "{{ request.object.spec.containers[0] }}"},
]


def validate_rows(engine: str, policy_doc: dict, resource: dict,
                  payload: dict | None = None) -> list[tuple]:
    """``validate`` of one policy document on one resource, by the JAX
    package (``engine="jax"``) or the port (``"torch"``): each rule
    response's name, status and message. With ``payload`` the policy
    context is the engine's admission recipe
    (``CompiledPolicySet._request_policy_context``)."""
    if engine == "jax":
        from kyverno_tpu.engine.context import Context
        from kyverno_tpu.engine.policy_context import PolicyContext
        from kyverno_tpu.engine.validation import validate
        load, cps_cls = jax_load_policy, JaxPolicySet
    else:
        from kyverno_tpu_torch.engine.context import Context
        from kyverno_tpu_torch.engine.policy_context import PolicyContext
        from kyverno_tpu_torch.engine.validation import validate
        load, cps_cls = torch_load_policy, TorchPolicySet
    policy = load(copy.deepcopy(policy_doc))
    resource = copy.deepcopy(resource)
    if payload is None:
        jctx = Context()
        jctx.add_resource(resource)
        pctx = PolicyContext(policy=policy, new_resource=resource,
                             json_context=jctx)
    else:
        pctx = cps_cls._request_policy_context(None, resource,
                                               copy.deepcopy(payload))
        pctx.policy = policy
    resp = validate(pctx)
    return [(r.name, r.status.name, r.message)
            for r in resp.policy_response.rules]


STORE_CONTEXT_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "test-policy"},
    "spec": {"rules": [{
        "name": "allowed-registries",
        "match": {"resources": {"kinds": ["Pod"]}},
        "context": [{"name": "registries",
                     "configMap": {"name": "regs", "namespace": "default"}}],
        "validate": {
            "message": "registry {{registries.allowed}} for "
                       "{{request.object.metadata.name}}",
            "deny": {"conditions": {"all": [
                {"key": "{{registries.allowed}}", "operator": "NotEquals",
                 "value": "docker.io"}]}}}}]}}


@contextlib.contextmanager
def mock_stores(values: dict | None):
    """Both packages' mock context stores on, holding ``values`` for
    STORE_CONTEXT_POLICY's rule (``None``: mock on, nothing declared)."""
    from kyverno_tpu import store as jax_store
    from kyverno_tpu_torch import store as torch_store

    for st in (jax_store, torch_store):
        st.set_mock(True)
        rules = [] if values is None else [
            st.Rule(name="allowed-registries", values=dict(values))]
        st.set_context(st.Context(policies=[
            st.Policy(name="test-policy", rules=rules)]))
    try:
        yield
    finally:
        for st in (jax_store, torch_store):
            st.set_mock(False)
            st.set_context(st.Context())


def _host_rule(name: str, rule: dict) -> dict:
    rule = dict(rule, name=name)
    rule.setdefault("match", {"resources": {"kinds": ["Pod"]}})
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name}, "spec": {"rules": [rule]}}


# Host-lane rules (a variable in the pattern or a condition's value) that
# read what only an admission request carries: the user, the service
# account, the roles, the namespace's labels, the images.
REQUEST_POLICIES = [
    _host_rule("user-echo", {"validate": {
        "message": "{{request.userInfo.username}} may not create "
                   "{{request.object.metadata.name}}",
        "pattern": {"metadata": {"name": "{{request.object.metadata.name}}"},
                    "spec": {"containers": [{"image": "!*:latest"}]}}}}),
    _host_rule("deny-builder", {"validate": {
        "message": "service account {{serviceAccountName}} denied",
        "deny": {"conditions": {"any": [
            {"key": "builder", "operator": "Equals",
             "value": "{{serviceAccountName}}"}]}}}}),
    _host_rule("admins-only", {
        "match": {"any": [{"resources": {"kinds": ["Pod"]},
                           "clusterRoles": ["admin"]}]},
        "validate": {"message": "namespace must be {{request.namespace}}",
                     "pattern": {"metadata": {
                         "namespace": "{{request.namespace}}"}}}}),
    _host_rule("prod-namespaces", {
        "match": {"resources": {"kinds": ["Pod"], "namespaceSelector": {
            "matchLabels": {"env": "prod"}}}},
        "exclude": {"subjects": [{"kind": "Group", "name": "ops"}]},
        "validate": {"message": "tag {{images.containers.web.tag}} on "
                                "{{request.object.metadata.name}}",
                     "pattern": {"spec": {"containers": [{
                         "image": "*:{{images.containers.web.tag}}"}]}}}}),
]


def request_payload(i: int, resource: dict) -> dict | None:
    """The admission payload of row ``i`` (every fifth row has none)."""
    if i % 5 == 4:
        return None
    ns = (resource.get("metadata") or {}).get("namespace", "default")
    user = ("system:serviceaccount:kube-system:builder" if i % 3 == 0
            else f"user-{i}")
    return {
        "request": {"operation": "CREATE", "namespace": ns,
                    "object": resource,
                    "userInfo": {"username": user, "uid": f"uid-{i}",
                                 "groups": ["system:authenticated"]
                                 + (["ops"] if i % 4 == 1 else [])}},
        "namespace_labels": {"env": "prod" if i % 2 else "dev"},
        "roles": [f"{ns}:viewer"],
        "cluster_roles": ["admin"] if i % 3 != 2 else [],
        "exclude_group_role": ["system:nodes"],
    }


def request_resources(n: int) -> list[dict]:
    rng = random.Random(20260731)
    out = []
    for i in range(n):
        pod = random_pod(rng)
        pod["metadata"]["namespace"] = rng.choice(["prod", "dev", "default"])
        if i % 2 == 0:
            pod["spec"]["containers"] = [{"name": "web", "image": rng.choice(
                ["nginx:latest", "nginx:1.21", "redis:6"])}]
        out.append(pod)
    return out


# ------------------------------------------------- mirrored batteries
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_PACKAGE = re.compile(r"\bkyverno_tpu\b")


def mirror_battery(relpath: str, subs=(), drop=()) -> dict:
    """The port's copy of one of the JAX package's test modules: its
    source with every ``kyverno_tpu`` import (and dotted string) pointed
    at ``kyverno_tpu_torch``, then ``subs`` — ``(old, new)`` pairs, each
    of which must occur, for what the port does differently on purpose
    (its default device, a renamed span) — run into a module namespace
    of its own. ``drop`` names the cases (``"Class.test"`` or
    ``"test"``) whose modules the port does not have yet.

    Returns the objects pytest collects, for the caller's module globals:
    test functions and classes under names prefixed with the battery's
    stem (``test_watch_unit__test_x``, ``Test_watch_unit__TestY``), and
    the battery's module-level fixtures under their own names."""
    path = os.path.join(ROOT, relpath)
    with open(path, encoding="utf-8") as f:
        src = _JAX_PACKAGE.sub("kyverno_tpu_torch", f.read())
    for old, new in subs:
        assert old in src, (relpath, old)
        src = src.replace(old, new)
    stem = os.path.splitext(os.path.basename(relpath))[0][len("test_"):]
    ns = {"__name__": f"tests.mirror_{stem}", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    for case in drop:
        owner, _, name = case.rpartition(".")
        if owner:
            delattr(ns[owner], name)
        else:
            del ns[name]
    out = {}
    for name, obj in ns.items():
        if name.startswith("test_") and callable(obj):
            out[f"test_{stem}__{name}"] = obj
        elif name.startswith("Test") and isinstance(obj, type):
            out[f"Test_{stem}__{name}"] = obj
        elif hasattr(obj, "_fixture_function_marker"):
            out[name] = obj
    return out


# ------------------------------------------- the fleet and workload planes

FLEET_SEED = 20261018


def fleet_docs(n_per_family: int = 2) -> list:
    """The first ``n_per_family`` policies of each family of the 250-policy
    library, in enforce mode: 16, the host-only family's two included."""
    out, seen = [], {}
    for d in chip_smoke.enforce_docs(chip_smoke._synth_policy_docs(250)):
        family = d["metadata"]["name"].rsplit("-v", 1)[0]
        if seen.get(family, 0) < n_per_family:
            seen[family] = seen.get(family, 0) + 1
            out.append(d)
    return out


def fleet_trace(mod, events: int = 120):
    """A seeded churn trace of ``workload.trace`` module ``mod`` (either
    package's) over :func:`fleet_docs`: three namespaces, 12 body
    templates (``chip_smoke.fleet_body``), 24 pod names, and four of the
    library's policies landing again every third of the events."""
    return mod.synthesize(events=events, namespaces=3, distinct_bodies=12,
                          name_pool=24, policy_churn_every=events // 3,
                          policy_docs=chip_smoke.churn_docs(fleet_docs()),
                          seed=FLEET_SEED, make_body=chip_smoke.fleet_body)


def count_plain_launches(monkeypatch) -> None:
    """Rehearse a chip_smoke phase on the CPU. There the wrappers run their
    plain versions and count no launch, so count the calls the device path
    makes (``ops.eval``'s ``eval_rules`` and ``glob_match_matrix``); and the
    plain versions make the batcher's dispatch cost large, so keep its
    screens on the device lane, as on the card."""
    from kyverno_tpu_torch.ops import _build
    from kyverno_tpu_torch.ops import eval as ev
    from kyverno_tpu_torch.runtime.batch import AdmissionBatcher

    rules, glob_ = ev.eval_rules, ev.glob_match_matrix

    def counted_rules(*a, **k):
        _build.note_launch("eval_rules")
        return rules(*a, **k)

    def counted_glob(*a, **k):
        _build.note_launch("glob_nfa")
        return glob_(*a, **k)

    monkeypatch.setattr(ev, "eval_rules", counted_rules)
    monkeypatch.setattr(ev, "glob_match_matrix", counted_glob)
    monkeypatch.setattr(AdmissionBatcher, "_device_favored",
                        lambda self, *a, **k: True)
