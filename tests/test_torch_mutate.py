"""The serial mutate engine on both packages: ``mutate`` (rule chaining,
variables, preconditions, foreach), the handlers (strategic merge,
RFC 6902 strings, raw patches, overlay), ``force_mutate``, and the JSON
patch and strategic-merge pieces under them.

Every case of tests/unit/test_mutation.py runs on the JAX package and on
the port with the same inputs: the responses (each rule's name, type,
status, message and patches, the counts, the patched resource) and the
patch bytes (``json.dumps``) are equal, and the JAX test's own
expectations hold on the port. tests/unit/test_fuzz_mutate.py's seeded
invariants run on the port, with port-vs-JAX equality on the same seeds.
"""

import json
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest

import kyverno_tpu.engine.mutate.json_patch as jax_json_patch
import kyverno_tpu.engine.mutate.strategic_merge as jax_strategic_merge
import kyverno_tpu_torch.engine.mutate.json_patch as json_patch
import kyverno_tpu_torch.engine.mutate.strategic_merge as strategic_merge
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.engine.context import Context as JaxContext
from kyverno_tpu.engine.force_mutate import force_mutate as jax_force_mutate
from kyverno_tpu.engine.mutate.handlers import apply_mutation as jax_apply
from kyverno_tpu.engine.mutation import mutate as jax_mutate
from kyverno_tpu.engine.policy_context import PolicyContext as JaxPolicyContext
from kyverno_tpu.engine.validate_pattern import match_pattern as jax_match
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.engine.context import Context
from kyverno_tpu_torch.engine.force_mutate import ForceMutateError, force_mutate
from kyverno_tpu_torch.engine.mutate.handlers import apply_mutation
from kyverno_tpu_torch.engine.mutation import mutate
from kyverno_tpu_torch.engine.policy_context import PolicyContext
from kyverno_tpu_torch.engine.response import RuleStatus
from kyverno_tpu_torch.engine.validate_pattern import match_pattern
from kyverno_tpu_torch.utils.jsoncopy import json_copy

JAX = SimpleNamespace(load=jax_load_policy, Context=JaxContext,
                      PolicyContext=JaxPolicyContext, mutate=jax_mutate,
                      force_mutate=jax_force_mutate, jp=jax_json_patch,
                      sm=jax_strategic_merge, apply=jax_apply,
                      match=jax_match)
PORT = SimpleNamespace(load=load_policy, Context=Context,
                       PolicyContext=PolicyContext, mutate=mutate,
                       force_mutate=force_mutate, jp=json_patch,
                       sm=strategic_merge, apply=apply_mutation,
                       match=match_pattern)


def make_ctx(pkg, policy_doc, resource, extra=None):
    jctx = pkg.Context()
    jctx.add_resource(json_copy(resource))
    if extra is not None:
        jctx.add_json(extra)
    return pkg.PolicyContext(policy=pkg.load(json_copy(policy_doc)),
                             new_resource=json_copy(resource),
                             json_context=jctx)


def response_view(resp) -> tuple:
    """Everything of an EngineResponse but its clocks: the patched
    resource, the patch bytes, the counts and each rule's name, type,
    status, message and patch bytes."""
    pr = resp.policy_response
    return (resp.patched_resource, json.dumps(resp.patches),
            pr.rules_applied_count, pr.rules_error_count,
            (pr.policy.name, pr.policy.validation_failure_action),
            (pr.resource.kind, pr.resource.api_version,
             pr.resource.namespace, pr.resource.name),
            [(r.name, r.type.value, r.status.value, r.message,
              json.dumps(r.patches)) for r in pr.rules])


def mutate_both(policy_doc, resource, extra=None):
    """The port's EngineResponse, after holding it to the JAX one's."""
    got = mutate(make_ctx(PORT, policy_doc, resource, extra))
    want = jax_mutate(make_ctx(JAX, policy_doc, resource, extra))
    assert response_view(got) == response_view(want)
    return got


def policy_with_rule(rule, name="test-policy"):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name}, "spec": {"rules": [rule]}}


def pod(name="test-pod", labels=None):
    meta = {"name": name}
    if labels is not None:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [{"name": "ctr", "image": "nginx:1.21"}]}}


def both(fn):
    """``fn(package)`` on each package; the port's result, after holding
    it to the JAX one's (the same bytes as JSON)."""
    got, want = fn(PORT), fn(JAX)
    assert json.dumps(got) == json.dumps(want)
    assert got == want
    return got


# ------------------------------------------------------------ JSON patch

def test_apply_basic_ops():
    doc = {"a": 1, "b": [1, 2]}
    ops = [{"op": "replace", "path": "/a", "value": 9},
           {"op": "add", "path": "/b/-", "value": 3},
           {"op": "remove", "path": "/b/0"},
           {"op": "add", "path": "/c/d", "value": "x"}]   # ensure-path
    out = both(lambda k: k.jp.apply_patch_ops(doc, ops))
    assert out == {"a": 9, "b": [2, 3], "c": {"d": "x"}}
    assert doc == {"a": 1, "b": [1, 2]}                    # input untouched


def test_negative_index_and_missing_remove():
    ops = [{"op": "replace", "path": "/b/-1", "value": 99},
           {"op": "remove", "path": "/nope"}]
    out = both(lambda k: k.jp.apply_patch_ops({"b": [1, 2, 3]}, ops))
    assert out == {"b": [1, 2, 99]}


@pytest.mark.parametrize("ops", [
    [{"op": "move", "from": "/a", "path": "/z"}],
    [{"op": "copy", "from": "/b/1", "path": "/b/0"}],
    [{"op": "test", "path": "/a", "value": 1}],
    [{"op": "add", "path": "/m~1n~0o", "value": 5}],
], ids=["move", "copy", "test", "escaped"])
def test_other_ops(ops):
    both(lambda k: k.jp.apply_patch_ops({"a": 1, "b": [1, 2]}, ops))


@pytest.mark.parametrize("ops", [
    [{"op": "test", "path": "/a", "value": 2}],
    [{"op": "replace", "path": "/b/7", "value": 0}],
    [{"op": "bogus", "path": "/a"}],
], ids=["test-fails", "out-of-range", "unknown-op"])
def test_failing_ops_raise_alike(ops):
    with pytest.raises(jax_json_patch.JsonPatchError) as want:
        jax_json_patch.apply_patch_ops({"a": 1, "b": [1, 2]}, ops)
    with pytest.raises(json_patch.JsonPatchError) as got:
        json_patch.apply_patch_ops({"a": 1, "b": [1, 2]}, ops)
    assert str(got.value) == str(want.value)


def test_create_patch_roundtrip():
    src = {"a": 1, "b": {"c": [1, 2, 3]}, "d": "keep"}
    dst = {"a": 2, "b": {"c": [1, 9]}, "e": True}
    ops = both(lambda k: k.jp.create_patch(src, dst))
    assert json_patch.apply_patch_ops(src, ops) == dst


def test_generate_patches_filters_status_and_metadata():
    src = {"metadata": {"resourceVersion": "1"}, "status": {"x": 1}, "spec": {}}
    dst = {"metadata": {"resourceVersion": "2", "labels": {"a": "b"}},
           "status": {"x": 2}, "spec": {"replicas": 1}}
    paths = [p["path"] for p in both(lambda k: k.jp.generate_patches(src, dst))]
    assert "/spec/replicas" in paths and "/metadata/labels" in paths
    assert not any("/status" in p for p in paths)
    assert not any("resourceVersion" in p for p in paths)


def test_removal_reordering():
    patches = [{"op": "remove", "path": f"/a/{i}"} for i in range(3)]
    out = both(lambda k: k.jp.filter_and_sort_patches(patches))
    assert [p["path"] for p in out] == ["/a/2", "/a/1", "/a/0"]


def test_escape_token():
    for key in ("plain", "a/b", "x~y", "~/", ""):
        assert json_patch.escape_token(key) == jax_json_patch.escape_token(key)


# -------------------------------------------------------- strategic merge

def test_map_merge_and_null_delete():
    base = {"a": {"x": 1, "y": 2}, "keep": True}
    patch = {"a": {"x": 9, "y": None, "z": 3}}
    assert both(lambda k: k.sm.merge(patch, base)) == {
        "a": {"x": 9, "z": 3}, "keep": True}


def test_list_merge_by_name():
    base = {"containers": [{"name": "a", "image": "old"}, {"name": "b"}]}
    patch = {"containers": [{"name": "a", "image": "new"}, {"name": "c"}]}
    assert both(lambda k: k.sm.merge(patch, base))["containers"] == [
        {"name": "a", "image": "new"}, {"name": "b"}, {"name": "c"}]


def test_scalar_list_replaces():
    assert both(lambda k: k.sm.merge({"args": ["x"]},
                                     {"args": ["a", "b"]})) == {"args": ["x"]}


def test_add_anchor():
    resource = {"metadata": {"labels": {"existing": "1"}}}
    pattern = {"metadata": {"labels": {"+(existing)": "nope", "+(new)": "added"}}}
    out = both(lambda k: k.sm.strategic_merge_patch(resource, pattern))
    assert out["metadata"]["labels"] == {"existing": "1", "new": "added"}


def test_condition_anchor_gates_patch():
    pattern = {"spec": {"(hostNetwork)": True, "priority": 100}}
    on = both(lambda k: k.sm.strategic_merge_patch(
        {"spec": {"hostNetwork": True}}, pattern))
    off = both(lambda k: k.sm.strategic_merge_patch(
        {"spec": {"hostNetwork": False}}, pattern))
    assert on["spec"]["priority"] == 100 and "priority" not in off["spec"]


def test_condition_anchor_missing_key_skips():
    pattern = {"spec": {"(hostNetwork)": True, "priority": 100}}
    res = {"spec": {}}
    assert both(lambda k: k.sm.strategic_merge_patch(res, pattern)) == res


def test_anchored_list_element_expands_by_name():
    pattern = {"spec": {"containers": [
        {"(image)": "*:latest", "imagePullPolicy": "Always"}]}}
    resource = {"spec": {"containers": [{"name": "a", "image": "nginx:latest"},
                                        {"name": "b", "image": "redis:6"}]}}
    out = both(lambda k: k.sm.strategic_merge_patch(resource, pattern))
    by_name = {c["name"]: c for c in out["spec"]["containers"]}
    assert by_name["a"]["imagePullPolicy"] == "Always"
    assert "imagePullPolicy" not in by_name["b"]


def test_preprocess_strips_anchor_only_patterns():
    out = both(lambda k: k.sm.pre_process_pattern(
        {"spec": {"(hostNetwork)": False}}, {"spec": {"hostNetwork": False}}))
    assert out == {}


@pytest.mark.parametrize("pattern", [
    {"spec": {"<(hostNetwork)": True, "priority": 1}},
    {"spec": {"(hostNetwork)": True}},
], ids=["global", "condition"])
def test_condition_errors_raise_alike(pattern):
    resource = {"spec": {"hostNetwork": False}}
    errors = (jax_strategic_merge.ConditionError,
              jax_strategic_merge.GlobalConditionError)
    with pytest.raises(errors) as want:
        jax_strategic_merge.pre_process_pattern(pattern, resource)
    port_errors = (strategic_merge.ConditionError,
                   strategic_merge.GlobalConditionError)
    with pytest.raises(port_errors) as got:
        strategic_merge.pre_process_pattern(pattern, resource)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- mutate

ADD_LABEL = {
    "name": "add-label",
    "match": {"resources": {"kinds": ["Pod"]}},
    "mutate": {"patchStrategicMerge": {
        "metadata": {"labels": {"+(app)": "default-app"}}}},
}


def test_adds_missing_label():
    resp = mutate_both(policy_with_rule(ADD_LABEL), pod(labels={}))
    r = resp.policy_response.rules[0]
    assert r.status is RuleStatus.PASS
    assert resp.patched_resource["metadata"]["labels"]["app"] == "default-app"
    assert any(p["path"].endswith("labels") or "app" in p["path"]
               for p in r.patches)


def test_existing_label_untouched_reports_skip():
    resp = mutate_both(policy_with_rule(ADD_LABEL), pod(labels={"app": "mine"}))
    assert resp.policy_response.rules[0].status is RuleStatus.SKIP
    assert resp.patched_resource["metadata"]["labels"]["app"] == "mine"


def test_json6902_patch():
    rule = {"name": "6902", "match": {"resources": {"kinds": ["Pod"]}},
            "mutate": {"patchesJson6902": (
                "- op: add\n  path: /metadata/labels/env\n  value: prod\n")}}
    resp = mutate_both(policy_with_rule(rule), pod(labels={}))
    assert resp.policy_response.rules[0].status is RuleStatus.PASS
    assert resp.patched_resource["metadata"]["labels"]["env"] == "prod"


@pytest.mark.parametrize("mutation", [
    {"patchesJson6902": "- op: [unclosed"},
    {"patchesJson6902": "op: add"},
    {"patchesJson6902": "- op: replace\n  path: /spec/missing/x\n  value: 1\n"},
    {"patches": [{"op": "add", "path": "/metadata/labels/raw", "value": "1"},
                 {"op": "remove", "path": "/metadata/nothing"}]},
    {"patches": [{"op": "replace", "path": "/spec/nothing/x", "value": 1}]},
    {"overlay": {"metadata": {"labels": {"+(overlay)": "yes"}}}},
    {"patchStrategicMerge": {"spec": {"(hostNetwork)": True, "x": 1}}},
    {"foreach": [{"list": "request.object.spec.containers"}]},
], ids=["6902-bad-yaml", "6902-not-a-list", "6902-fails", "raw-patches",
        "raw-patch-fails", "overlay", "condition-miss", "foreach-no-merge"])
def test_handler_outcomes(mutation):
    """Each handler's outcome, PASS, SKIP or ERROR with its message, is
    the JAX package's."""
    rule = {"name": "r", "match": {"resources": {"kinds": ["Pod"]}},
            "mutate": mutation}
    mutate_both(policy_with_rule(rule), pod(labels={"a": "b"}))
    res = pod(labels={"a": "b"})
    p = load_policy(policy_with_rule(rule)).spec.rules[0].mutation
    jp = jax_load_policy(policy_with_rule(rule)).spec.rules[0].mutation
    got, want = apply_mutation(p, json_copy(res)), jax_apply(jp, json_copy(res))
    assert (got.status.value, got.message, json.dumps(got.patches),
            got.patched_resource) == (want.status.value, want.message,
                                      json.dumps(want.patches),
                                      want.patched_resource)


def test_rule_chaining():
    policy = {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
              "metadata": {"name": "chain"},
              "spec": {"rules": [
                  {"name": "first", "match": {"resources": {"kinds": ["Pod"]}},
                   "mutate": {"patchStrategicMerge": {
                       "metadata": {"labels": {"+(stage)": "one"}}}}},
                  {"name": "second", "match": {"resources": {"kinds": ["Pod"]}},
                   "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
                       "copied": "{{request.object.metadata.labels.stage}}"}}}}},
              ]}}
    resp = mutate_both(policy, pod(labels={}))
    assert [r.status for r in resp.policy_response.rules] == [
        RuleStatus.PASS, RuleStatus.PASS]
    labels = resp.patched_resource["metadata"]["labels"]
    assert labels["stage"] == "one" and labels["copied"] == "one"


def test_variable_substitution_in_patch():
    rule = {"name": "var-label", "match": {"resources": {"kinds": ["Pod"]}},
            "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
                "appname": "{{request.object.metadata.name}}"}}}}}
    resp = mutate_both(policy_with_rule(rule), pod(name="my-pod", labels={}))
    assert resp.patched_resource["metadata"]["labels"]["appname"] == "my-pod"


def test_unresolved_variable_errors():
    rule = {"name": "var-missing", "match": {"resources": {"kinds": ["Pod"]}},
            "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
                "x": "{{request.object.metadata.nothing.here}}"}}}}}
    resp = mutate_both(policy_with_rule(rule), pod(labels={}))
    assert resp.policy_response.rules[0].status is RuleStatus.ERROR


@pytest.mark.parametrize("operation,status", [
    ("UPDATE", RuleStatus.SKIP), ("CREATE", RuleStatus.PASS)])
def test_preconditions(operation, status):
    rule = dict(ADD_LABEL, preconditions={"all": [
        {"key": "{{request.operation}}", "operator": "Equals",
         "value": "CREATE"}]})
    resp = mutate_both(policy_with_rule(rule), pod(labels={}),
                       extra={"request": {"operation": operation}})
    assert resp.policy_response.rules[0].status is status


def test_kind_mismatch_reports_no_rule():
    resp = mutate_both(policy_with_rule(ADD_LABEL),
                       dict(pod(labels={}), kind="Service"))
    assert resp.policy_response.rules == []


FOREACH = {
    "name": "foreach-pull-policy",
    "match": {"resources": {"kinds": ["Pod"]}},
    "mutate": {"foreach": [{
        "list": "request.object.spec.containers",
        "patchStrategicMerge": {"spec": {"containers": [
            {"(name)": "{{element.name}}", "imagePullPolicy": "IfNotPresent"}]}},
    }]},
}
TWO_CONTAINERS = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p"},
                  "spec": {"containers": [{"name": "a", "image": "x:1"},
                                          {"name": "b", "image": "y:2"}]}}


def test_foreach_mutation():
    resp = mutate_both(policy_with_rule(FOREACH), TWO_CONTAINERS)
    assert resp.policy_response.rules[0].status is RuleStatus.PASS
    for c in resp.patched_resource["spec"]["containers"]:
        assert c["imagePullPolicy"] == "IfNotPresent"


@pytest.mark.parametrize("entry", [
    {"list": "request.object.spec.nothing"},
    {"list": "request.object.spec.containers",
     "preconditions": {"all": [{"key": "a", "operator": "Equals",
                                "value": "b"}]}},
    {"list": "request.object.spec.containers[?name == 'zzz']"},
], ids=["empty-list", "preconditions-miss", "no-element"])
def test_foreach_outcomes(entry):
    fe = dict(FOREACH["mutate"]["foreach"][0], **entry)
    rule = dict(FOREACH, mutate={"foreach": [fe]})
    mutate_both(policy_with_rule(rule), TWO_CONTAINERS)


def test_force_mutate_ignores_preconditions():
    rule = {"name": "add-label", "match": {"resources": {"kinds": ["Pod"]}},
            "preconditions": {"all": [
                {"key": "x", "operator": "Equals", "value": "never"}]},
            "mutate": {"patchStrategicMerge": {
                "metadata": {"labels": {"forced": "yes"}}}}}
    out = both(lambda k: k.force_mutate(
        None, k.load(policy_with_rule(rule)), pod(labels={})))
    assert out["metadata"]["labels"]["forced"] == "yes"


def test_force_mutate_placeholder_for_unresolved_vars():
    rule = {"name": "add-var-label", "match": {"resources": {"kinds": ["Pod"]}},
            "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
                "who": "{{request.userInfo.username}}"}}}}}
    out = both(lambda k: k.force_mutate(
        None, k.load(policy_with_rule(rule)), pod(labels={})))
    assert out["metadata"]["labels"]["who"] == "placeholderValue"


def test_force_mutate_every_handler_and_its_error():
    rules = [
        {"name": "o", "match": {"resources": {"kinds": ["Pod"]}},
         "mutate": {"overlay": {"metadata": {"labels": {"o": "1"}}}}},
        {"name": "p", "match": {"resources": {"kinds": ["Pod"]}},
         "mutate": {"patches": [{"op": "add", "path": "/metadata/labels/p",
                                 "value": "2"}]}},
        {"name": "j", "match": {"resources": {"kinds": ["Pod"]}},
         "mutate": {"patchesJson6902":
                    "- op: add\n  path: /metadata/labels/j\n  value: '3'\n"}},
        FOREACH,
    ]
    doc = {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
           "metadata": {"name": "all"}, "spec": {"rules": rules}}
    out = both(lambda k: k.force_mutate(None, k.load(doc), TWO_CONTAINERS))
    assert out["metadata"]["labels"] == {"o": "1", "p": "2", "j": "3"}
    bad = policy_with_rule({"name": "bad",
                            "match": {"resources": {"kinds": ["Pod"]}},
                            "mutate": {"patchesJson6902": "op: add"}})
    with pytest.raises(Exception) as want:
        jax_force_mutate(None, jax_load_policy(bad), pod())
    with pytest.raises(ForceMutateError) as got:
        force_mutate(None, load_policy(bad), pod())
    assert str(got.value) == str(want.value)


# ------------------------------------------------- seeded invariants

KEYS = ["alpha", "beta", "gamma", "labels", "mode"]
VALS = ["on", "off", "x1", "3", "250m", ""]


def rand_sm_pattern(rng, depth=0):
    """Strategic-merge pattern: maps with plain and +(add) keys, each bare
    key once."""
    if depth >= 2 or rng.random() < 0.45:
        return rng.choice(VALS + [True, False, 7])
    out = {}
    for key in rng.sample(KEYS, rng.randint(1, 3)):
        if rng.random() < 0.4:
            key = f"+({key})"
        out[key] = rand_sm_pattern(rng, depth + 1)
    return out


def rand_resource(rng, i):
    def val(depth=0):
        if depth >= 2 or rng.random() < 0.55:
            return rng.choice(VALS + [True, 0, 5, None])
        return {rng.choice(KEYS): val(depth + 1)
                for _ in range(rng.randint(0, 3))}

    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": f"cm-{i}"},
            "data": {rng.choice(KEYS): val() for _ in range(rng.randint(0, 3))}}


def run_mutate(pkg, policy_doc, resource):
    return pkg.mutate(make_ctx(pkg, policy_doc, resource))


@pytest.mark.parametrize("seed", range(1, 9))
def test_mutate_invariants(seed):
    """tests/unit/test_fuzz_mutate.py's invariants on the port (the
    patches replay to the patched resource; a second pass is a no-op; an
    anchor-free pattern matches what it merged), and every response the
    JAX package's, on the same seeds."""
    rng = random.Random(990 + seed)
    checked = 0
    for i in range(12):
        pattern = {"data": rand_sm_pattern(rng)}
        doc = {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
               "metadata": {"name": f"m-{i}"},
               "spec": {"rules": [{
                   "name": f"m-{i}-r",
                   "match": {"resources": {"kinds": ["ConfigMap"]}},
                   "mutate": {"patchStrategicMerge": pattern}}]}}
        for j in range(6):
            resource = rand_resource(rng, j)
            resp = run_mutate(PORT, doc, resource)
            assert response_view(resp) == response_view(
                run_mutate(JAX, doc, resource))
            if RuleStatus.ERROR in [r.status for r in resp.policy_response.rules]:
                continue
            checked += 1
            replayed = json_patch.apply_patch_ops(resource, resp.patches)
            assert replayed == resp.patched_resource, (pattern, resource)
            resp2 = run_mutate(PORT, doc, resp.patched_resource)
            assert resp2.patched_resource == resp.patched_resource, pattern
            assert resp2.patches == [], pattern
            if "+(" not in str(pattern):
                check = match_pattern(resp.patched_resource, pattern)
                assert check.matched, (pattern, resp.patched_resource)
    assert checked > 0


def test_mutate_package_loads_without_pyyaml():
    """The mutate path imports PyYAML only where it parses a
    patchesJson6902 string: with PyYAML unimportable the modules load
    and a strategic merge runs."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import kyverno_tpu_torch.engine.mutate as m\n"
        "import kyverno_tpu_torch.engine.mutate.batch\n"
        "import kyverno_tpu_torch.engine.mutation\n"
        "import kyverno_tpu_torch.engine.force_mutate\n"
        "out = m.strategic_merge_patch({'a': {}}, {'a': {'+(b)': 1}})\n"
        "assert out == {'a': {'b': 1}}, out\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
