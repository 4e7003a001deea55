"""Autogen on both packages, and the autogen'd library through the port's
device path on the CPU.

Every case of tests/unit/test_autogen.py runs on the JAX package and on
the port with the same inputs: ``can_auto_gen``'s answers, the generated
rules and the autogen'd policy documents are equal byte for byte as JSON,
and the JAX test's own expectations hold on the port. The 250-policy
library of chip_smoke.py goes through the policy webhook's steps in both
packages to the same 670 rules.

The slice as a whole: a cut of that library, autogen'd, with a policy
whose CronJob twin's path passes ``MAX_SEGMENTS`` (so that column is
host-only in both packages) and one whose message and preconditions read
variables that autogen shifts into the pod template, is evaluated over
the [autogen] population of chip_smoke.py by the port (``device="cpu"``:
the plain kernels, then the host lane) and by the JAX package's
``CompiledPolicySet.evaluate``; the int8 matrices are equal.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
import kyverno_tpu.policy.autogen as jax_autogen
import kyverno_tpu_torch.policy.autogen as autogen
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models import CompiledPolicySet as JaxPolicySet
from kyverno_tpu.models.compiler import MAX_SEGMENTS as JAX_MAX_SEGMENTS
from kyverno_tpu.policy import openapi as jax_openapi
from kyverno_tpu.policy import validation as jax_validation
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.models import CompiledPolicySet
from kyverno_tpu_torch.models.compiler import MAX_SEGMENTS, SEP
from kyverno_tpu_torch.runtime import hostlane
from kyverno_tpu_torch.utils.jsoncopy import json_copy
from tests.torch_parity import one_torch_thread  # noqa: F401

JAX_STEPS = SimpleNamespace(
    load_policy=jax_load_policy, apply_defaults=jax_autogen.apply_defaults,
    mutate_policy_for_autogen=jax_autogen.mutate_policy_for_autogen,
    validate_policy=jax_validation.validate_policy,
    validate_policy_mutation=jax_openapi.validate_policy_mutation)
CONTROLLERS_ANNOTATION = "pod-policies.kyverno.io/autogen-controllers"


def pod_policy(rule_extra=None, annotations=None):
    rule = {
        "name": "check-labels",
        "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {
            "message": "label required",
            "pattern": {"metadata": {"labels": {"app": "?*"}}},
        },
    }
    rule.update(rule_extra or {})
    return {
        "apiVersion": "kyverno.io/v1",
        "kind": "ClusterPolicy",
        "metadata": {"name": "p", "annotations": annotations or {}},
        "spec": {"rules": [rule]},
    }


def both(fn):
    """``fn(module)`` on each package's autogen module; the port's result,
    after holding it to the JAX one's (the same bytes as JSON)."""
    got, want = fn(autogen), fn(jax_autogen)
    assert json.dumps(got) == json.dumps(want)
    assert got == want
    return got


def _with(doc, path, value):
    doc = json_copy(doc)
    node = doc["spec"]["rules"][0]
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return doc


# ------------------------------------------------------------ can_auto_gen

@pytest.mark.parametrize("doc, want", [
    (pod_policy(), (True, "DaemonSet,Deployment,Job,StatefulSet,CronJob")),
    (_with(pod_policy(), ("match", "resources", "name"), "foo"),
     (False, "none")),
    (_with(pod_policy(), ("match", "resources", "kinds"),
           ["Pod", "Deployment"]), (False, "none")),
    (pod_policy({"validate": {"deny": {"conditions": []}}}), (False, "none")),
    (pod_policy({"exclude": {"resources": {"selector": {
        "matchLabels": {"a": "b"}}}}}), (False, "none")),
    (pod_policy({"match": {"any": [{"resources": {
        "kinds": ["Pod", "Service"]}}]}}), (False, "none")),
    (pod_policy({"mutate": {"patchesJson6902": "- op: add"}}),
     (False, "none")),
    (pod_policy({"generate": {"kind": "ConfigMap", "name": "x"}}),
     (False, "none")),
], ids=["pod-rule", "name-match", "mixed-kinds", "deny", "exclude-selector",
        "any-mixed-kinds", "json6902", "generate"])
def test_can_auto_gen(doc, want):
    assert both(lambda m: list(m.can_auto_gen(doc))) == list(want)


# ------------------------------------------------------- generated rules

FOREACH_MUTATE = {"mutate": {"foreach": [{
    "list": "request.object.spec.containers",
    "patchStrategicMerge": {"spec": {"containers": [{
        "(name)": "{{ element.name }}", "imagePullPolicy": "Always"}]}}}]},
    "validate": None}
RULE_SHAPES = {
    "pattern": pod_policy(),
    "variables": pod_policy({"validate": {
        "message": "bad {{request.object.spec.containers[0].image}} in "
                   "{{request.object.metadata.name}}",
        "pattern": {"spec": {"containers": [{"image": "?*"}]}}}}),
    "any-pattern": pod_policy({"validate": {"message": "m", "anyPattern": [
        {"spec": {"hostNetwork": False}},
        {"metadata": {"labels": {"trusted": "true"}}}]}}),
    "foreach-validate": pod_policy({"validate": {"message": "m", "foreach": [{
        "list": "request.object.spec.containers",
        "pattern": {"image": "!*:latest"}}]}}),
    "patch-strategic-merge": pod_policy({"validate": None, "mutate": {
        "patchStrategicMerge": {"metadata": {"labels": {
            "+(team)": "{{request.object.metadata.namespace}}"}}}}}),
    "overlay": pod_policy({"validate": None, "mutate": {
        "overlay": {"spec": {"hostNetwork": False}}}}),
    "foreach-mutate": pod_policy(FOREACH_MUTATE),
    "verify-images": pod_policy({"validate": None, "verifyImages": [
        {"image": "ghcr.io/acme/*", "key": "k1"}]}),
    "context-preconditions-exclude": pod_policy({
        "context": [{"name": "cm", "configMap": {"name": "c",
                                                 "namespace": "d"}}],
        "preconditions": {"all": [{
            "key": "{{request.object.spec.containers[0].name}}",
            "operator": "NotEquals", "value": ""}]},
        "exclude": {"resources": {"kinds": ["Pod"],
                                  "namespaces": ["kube-system"]}}}),
    "exclude-namespaces-only": pod_policy({
        "exclude": {"resources": {"namespaces": ["kube-system"]}}}),
    "match-any": pod_policy({"match": {"any": [
        {"resources": {"kinds": ["Pod"], "namespaces": ["prod"]}}]}}),
    "annotation-none": pod_policy(
        annotations={CONTROLLERS_ANNOTATION: "none"}),
    "annotation-subset": pod_policy(
        annotations={CONTROLLERS_ANNOTATION: "Deployment"}),
    "annotation-with-cronjob": pod_policy(
        annotations={CONTROLLERS_ANNOTATION: "Deployment,CronJob"}),
    "annotation-all": pod_policy(annotations={CONTROLLERS_ANNOTATION: "all"}),
    "already-autogen": pod_policy({"name": "autogen-check-labels"}),
    "not-a-pod-rule": _with(pod_policy(), ("match", "resources", "kinds"),
                            ["Service"]),
}


def _drop_none(doc):
    for r in doc["spec"]["rules"]:
        for k in [k for k, v in r.items() if v is None]:
            del r[k]
    return doc


@pytest.mark.parametrize("shape", sorted(RULE_SHAPES))
def test_generate_pod_controller_rules(shape):
    doc = _drop_none(json_copy(RULE_SHAPES[shape]))
    rules = both(lambda m: m.generate_pod_controller_rules(json_copy(doc)))
    by_name = {r["name"]: r for r in rules}
    # tests/unit/test_autogen.py's expectations, on the port
    if shape == "pattern":
        assert set(by_name) == {"autogen-check-labels",
                                "autogen-cronjob-check-labels"}
        auto = by_name["autogen-check-labels"]
        assert auto["match"]["resources"]["kinds"] == [
            "DaemonSet", "Deployment", "Job", "StatefulSet"]
        assert auto["validate"]["pattern"] == {
            "spec": {"template": {"metadata": {"labels": {"app": "?*"}}}}}
        cron = by_name["autogen-cronjob-check-labels"]
        assert cron["match"]["resources"]["kinds"] == ["CronJob"]
        assert cron["validate"]["pattern"] == {"spec": {"jobTemplate": {
            "spec": {"template": {"metadata": {"labels": {"app": "?*"}}}}}}}
    elif shape == "variables":
        assert "request.object.spec.template.spec.containers" in \
            by_name["autogen-check-labels"]["validate"]["message"]
        assert ("request.object.spec.jobTemplate.spec.template.spec."
                "containers") in \
            by_name["autogen-cronjob-check-labels"]["validate"]["message"]
    elif shape in ("annotation-none", "already-autogen", "not-a-pod-rule"):
        assert rules == []
    elif shape == "annotation-subset":
        assert len(rules) == 1
        assert rules[0]["match"]["resources"]["kinds"] == ["Deployment"]
    else:
        assert rules


@pytest.mark.parametrize("shape", ["pattern", "variables",
                                   "patch-strategic-merge", "foreach-mutate"])
def test_rule_for_controllers_and_cronjob_rule(shape):
    """The two generators called directly, with every controllers string
    the webhook may pass them."""
    rule = _drop_none(json_copy(RULE_SHAPES[shape]))["spec"]["rules"][0]
    for controllers in ("Deployment", "all", "Job", "DaemonSet,Job",
                        "CronJob", "", "Deployment,CronJob"):
        both(lambda m: m.generate_rule_for_controllers(json_copy(rule),
                                                       controllers))
        both(lambda m: m.generate_cronjob_rule(json_copy(rule), controllers))


def test_apply_defaults_and_mutate_policy():
    assert both(lambda m: m.apply_defaults(pod_policy()))["spec"][
        "failurePolicy"] == "Fail"
    kept = pod_policy()
    kept["spec"].update(validationFailureAction="enforce", background=False)
    both(lambda m: m.apply_defaults(kept))
    got = autogen.mutate_policy_for_autogen(load_policy(pod_policy()))
    want = jax_autogen.mutate_policy_for_autogen(jax_load_policy(pod_policy()))
    assert json.dumps(got.raw) == json.dumps(want.raw)
    assert got.spec.validation_failure_action == "audit"
    assert [r.name for r in got.spec.rules] == \
        [r.name for r in want.spec.rules]
    assert len(got.spec.rules) == 3


def test_rule_names_cut_at_63_characters():
    """Two Pod rules whose names share their first 60 characters: their
    autogen'd names are cut to the same 63 characters in both packages,
    and the policy's validation reports the same errors."""
    stem = "r" * 60
    doc = pod_policy()
    rule = doc["spec"]["rules"][0]
    doc["spec"]["rules"] = [dict(rule, name=stem + "-one"),
                            dict(rule, name=stem + "-two")]
    rules = both(lambda m: m.generate_pod_controller_rules(json_copy(doc)))
    names = [r["name"] for r in rules]
    assert all(len(n) == 63 for n in names)
    assert len(set(names)) == 2 and len(names) == 4     # two pairs collide
    got = autogen.mutate_policy_for_autogen(load_policy(json_copy(doc)))
    want = jax_autogen.mutate_policy_for_autogen(
        jax_load_policy(json_copy(doc)))
    assert json.dumps(got.raw) == json.dumps(want.raw)
    from kyverno_tpu_torch.policy.validation import validate_policy

    errs = validate_policy(got)
    assert errs == jax_validation.validate_policy(want)
    assert any("duplicate rule name" in e for e in errs)


def test_library_autogens_as_the_jax_package_does():
    """chip_smoke.py's 250-policy library through the policy webhook's
    steps: 670 rules, 420 of them autogen'd, no error, and every
    autogen'd policy document equal to the JAX package's, byte for byte
    as JSON."""
    docs = chip_smoke._synth_policy_docs(250)
    got, got_errs = chip_smoke.autogen_policies(docs,
                                                chip_smoke.policy_steps())
    want, want_errs = chip_smoke.autogen_policies(docs, JAX_STEPS)
    assert got_errs == want_errs == []
    assert [json.dumps(p.raw) for p in got] == \
        [json.dumps(p.raw) for p in want]
    cols = chip_smoke.rule_columns(got)
    assert len(cols) == 670
    assert sum(r.startswith("autogen-") for _, r in cols) == 420


# --------------------------------------------------------- the slice

DEEP_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "projected-paths"},
    "spec": {"rules": [{
        "name": "projected-path-set",
        "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {
            "message": "projected configMap items need a path",
            "pattern": {"spec": {"volumes": [{"projected": {"sources": [
                {"configMap": {"items": [{"path": "?*"}]}}]}}]}}},
    }]},
}
SHIFTED_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "named-first-container"},
    "spec": {"rules": [{
        "name": "first-container-requests",
        "match": {"resources": {"kinds": ["Pod"]}},
        "preconditions": {"all": [{
            "key": "{{ request.object.spec.containers[0].image }}",
            "operator": "NotEquals", "value": "redis:6"}]},
        "validate": {
            "message": "{{ request.object.spec.containers[0].name }} "
                       "needs requests",
            "pattern": {"spec": {"containers": [{"resources": {
                "requests": {"memory": "?*"}}}]}}},
    }]},
}
DENY_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "deny-latest-pods"},
    "spec": {"rules": [{
        "name": "deny-pod-latest",
        "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {
            "message": "{{ request.object.metadata.name }} uses latest",
            "deny": {"conditions": {"any": [{
                "key": "{{ request.object.spec.containers[0].image }}",
                "operator": "Equals", "value": "nginx:latest"}]}}},
    }]},
}


def pod_spec(resource: dict) -> dict:
    """The pod spec of a Pod or of a pod controller."""
    spec = resource["spec"]
    if resource["kind"] == "Pod":
        return spec
    if resource["kind"] == "CronJob":
        spec = spec["jobTemplate"]["spec"]
    return spec["template"]["spec"]


def jax_autogen_matrix(docs: list, resources: list, chunk: int = 2000):
    """The JAX package's side of [autogen]: ``docs`` through its policy
    webhook steps, then its ``CompiledPolicySet.evaluate`` over
    ``resources``, ``chunk`` at a time, columns by (policy, rule) in
    ``chip_smoke.rule_columns``' order. Returns (the JAX set, the int8
    matrix)."""
    pols, errs = chip_smoke.autogen_policies(docs, JAX_STEPS)
    assert errs == []
    cols = chip_smoke.rule_columns(pols)
    jset = JaxPolicySet(pols)
    order = [cols[(r.policy.name, r.rule.name)] for r in jset.rule_refs]
    out = np.zeros((len(resources), len(cols)), dtype=np.int8)
    for a in range(0, len(resources), chunk):
        m = jset.evaluate(resources[a:a + chunk])
        out[a:a + m.shape[0], order] = m[:, :len(order)]
    return jset, out


def jax_autogen_pin(n: int = chip_smoke.AUTOGEN_RESOURCES) -> tuple:
    """chip_smoke.py's [autogen] pin: the histogram and sha256 of the JAX
    package's matrix over autogen_resource(0..n-1) (about a minute at
    10,000 on a CPU)."""
    _, m = jax_autogen_matrix(chip_smoke._synth_policy_docs(250), [
        chip_smoke.autogen_resource(i) for i in range(n)])
    return (np.bincount(m.ravel().astype(np.int64), minlength=6).tolist(),
            chip_smoke.matrix_sha(m))


def slice_resources() -> list:
    """200 resources of the [autogen] population, then 30 pod-bearing
    ones that carry projected configMap items, with a path or without."""
    out = [chip_smoke.autogen_resource(i) for i in range(200)]
    for i in range(200, 235):
        r = chip_smoke.autogen_resource(i)
        if r["kind"] == "Service":
            continue
        pod_spec(r)["volumes"] = [{"name": "p", "projected": {"sources": [
            {"configMap": {"name": "c", "items": [
                {"key": "k", "path": f"p{i}" if i % 2 else ""}]}}]}}]
        out.append(r)
    return out


def test_autogend_library_evaluates_as_the_jax_package_does():
    docs = (chip_smoke._synth_policy_docs(250)[:40]
            + [DEEP_POLICY, SHIFTED_POLICY, DENY_POLICY])
    port_pols, errs = chip_smoke.autogen_policies(docs,
                                                  chip_smoke.policy_steps())
    assert errs == []
    resources = slice_resources()
    assert {r["kind"] for r in resources} == set(chip_smoke.AUTOGEN_KINDS)
    cps = CompiledPolicySet(port_pols, device="cpu")
    jset, want = jax_autogen_matrix(docs, resources, chunk=len(resources))
    names = [(r.policy.name, r.rule.name) for r in cps.rule_refs]
    assert names == [(r.policy.name, r.rule.name) for r in jset.rule_refs]
    assert names == list(chip_smoke.rule_columns(port_pols))
    assert 100 <= len(names) <= 130
    # deny rules never autogen; the other two policies have both twins
    assert [n for p, n in names if p == "deny-latest-pods"] == \
        ["deny-pod-latest"]
    deep = {n: i for i, (p, n) in enumerate(names) if p == "projected-paths"}
    t = cps.tensors
    assert [bool(t.rule_host_only[deep[n]]) for n in (
        "projected-path-set", "autogen-projected-path-set",
        "autogen-cronjob-projected-path-set")] == [False, False, True]
    cron_ir = cps.rule_irs[deep["autogen-cronjob-projected-path-set"]]
    assert cron_ir.host_reason == "path too deep"
    assert max(len(c.path.split(SEP)) for c in cron_ir.checks) > \
        MAX_SEGMENTS == JAX_MAX_SEGMENTS
    assert np.array_equal(t.rule_host_only, jset.tensors.rule_host_only)

    hostlane.host_cache().clear()
    device = cps.evaluate_device(cps.flatten(resources))
    got = cps.evaluate(resources)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape == (len(resources), len(names))
    diff = np.argwhere(got != want)
    assert diff.size == 0, (
        f"{len(diff)} cells differ; first (b, r) {diff[:3].tolist()}, "
        f"port {got[tuple(diff[0])]}, JAX {want[tuple(diff[0])]}")
    # the host lane resolved every HOST cell, the deep CronJob column's
    # among them, and the resolved matrix holds PASS, FAIL and ERROR
    assert (device == 5).any() and not (got == 5).any()
    cron_col = deep["autogen-cronjob-projected-path-set"]
    cron_rows = [b for b, r in enumerate(resources) if r["kind"] == "CronJob"]
    assert (device[cron_rows, cron_col] == 5).all()
    assert {1, 2} <= set(got[cron_rows, cron_col].tolist())
    hist = np.bincount(got.ravel().astype(np.int64), minlength=6)
    assert hist[1] and hist[2] and hist[4]
    # the host lane's messages, shifted variables substituted, are the
    # JAX package's; a Deployment's FAIL text names its template's first
    # container
    hostlane.host_cache().clear()
    msgs, jax_msgs = {}, {}
    cps.resolve_host_cells(resources, device.copy(), messages_out=msgs)
    jset.resolve_host_cells(resources, jset.evaluate_device(
        jset.flatten(resources)), messages_out=jax_msgs)
    assert msgs == jax_msgs
    col = names.index(("named-first-container",
                       "autogen-first-container-requests"))
    fails = [msgs[(b, col)] for b, r in enumerate(resources)
             if r["kind"] == "Deployment" and (b, col) in msgs
             and got[b, col] == 2]
    assert fails and all("needs requests" in m for m in fails)
    hostlane.host_cache().clear()
