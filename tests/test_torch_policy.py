"""The policy plane on both packages: ``validate_policy`` (structural
checks), the OpenAPI schema registry (``validate_resource``,
``validate_policy_mutation``) and its CRD sync (``convert_openapi_schema``,
``schemas_from_crd``, ``schemas_from_openapi_v2``, ``CrdSync``).

Every case of tests/unit/test_generation.py's policy-validation class,
tests/unit/test_openapi.py and tests/unit/test_crd_sync.py runs on the JAX
package and on the port with the same inputs: the error lists and the
converted schemas are equal, and the JAX tests' own expectations hold on
the port. Each package keeps its own schema registry; a ``CrdSync`` of
each watches one shared ``FakeCluster`` of the JAX package. The policy
webhook's validation steps (``validate_policy``, then
``validate_policy_mutation``) stand in for the JAX tests' webhook cases.
"""

import json
from types import SimpleNamespace

import pytest

import kyverno_tpu.policy.crd_sync as jax_crd_sync
import kyverno_tpu.policy.openapi as jax_openapi
import kyverno_tpu.policy.validation as jax_validation
import kyverno_tpu_torch.policy.crd_sync as crd_sync
import kyverno_tpu_torch.policy.openapi as openapi
import kyverno_tpu_torch.policy.validation as validation
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.runtime.client import FakeCluster
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.utils.jsoncopy import json_copy

JAX = SimpleNamespace(load=jax_load_policy, v=jax_validation,
                      oa=jax_openapi, crd=jax_crd_sync)
PORT = SimpleNamespace(load=load_policy, v=validation, oa=openapi,
                       crd=crd_sync)


def both(fn):
    """``fn(package)`` on each package; the port's result, after holding
    it to the JAX one's (the same bytes as JSON)."""
    got, want = fn(PORT), fn(JAX)
    assert json.dumps(got) == json.dumps(want)
    assert got == want
    return got


def policy(rules, name="p", **spec):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name}, "spec": {"rules": rules, **spec}}


def validate_both(doc):
    return both(lambda k: k.v.validate_policy(k.load(json_copy(doc))))


# ------------------------------------------------------- validate_policy

POD_MATCH = {"resources": {"kinds": ["Pod"]}}
GEN_POLICY = policy([{
    "name": "default-deny",
    "match": {"resources": {"kinds": ["Namespace"]}},
    "generate": {"apiVersion": "networking.k8s.io/v1",
                 "kind": "NetworkPolicy", "name": "default-deny",
                 "namespace": "{{request.object.metadata.name}}",
                 "synchronize": True,
                 "data": {"spec": {"podSelector": {}}}}}],
    name="add-networkpolicy")

POLICY_CASES = {
    "valid": (GEN_POLICY, None),
    "multiple-actions": (policy([{
        "name": "two-actions", "match": POD_MATCH,
        "validate": {"pattern": {"spec": {}}},
        "mutate": {"patchStrategicMerge": {"metadata": {}}}}]),
        "multiple operations"),
    "duplicate-rule-names": (policy([
        {"name": "r", "match": POD_MATCH,
         "validate": {"pattern": {"spec": {}}}},
        {"name": "r", "match": POD_MATCH,
         "validate": {"pattern": {"spec": {}}}}]), "duplicate rule name"),
    "unknown-variable": (policy([{
        "name": "r", "match": POD_MATCH,
        "validate": {"message": "{{undefinedthing.foo}}",
                     "pattern": {"spec": {}}}}]),
        "not defined in the rule context"),
    "long-name": (policy([{"name": "r", "match": POD_MATCH,
                           "validate": {"pattern": {"spec": {}}}}],
                         name="n" * 64), "no more than 63"),
    "empty-rule-name": (policy([{"name": "", "match": POD_MATCH,
                                 "validate": {"pattern": {}}}]),
                        "must not be empty"),
    "any-and-all": (policy([{
        "name": "r", "match": {"any": [POD_MATCH], "all": [POD_MATCH]},
        "validate": {"pattern": {"spec": {}}}}]), "cannot be used together"),
    "no-match": (policy([{"name": "r", "match": {"resources": {}},
                          "validate": {"pattern": {"spec": {}}}}]),
                 "match is required"),
    "no-kind": (policy([{"name": "r", "match": {"resources": {
        "namespaces": ["prod"]}}, "validate": {"pattern": {"spec": {}}}}]),
        "at least one kind"),
    "context-two-sources": (policy([{
        "name": "r", "match": POD_MATCH,
        "context": [{"name": "c", "configMap": {"name": "x"},
                     "variable": {"value": 1}}],
        "validate": {"pattern": {"spec": {}}}}]), "exactly one of"),
    "validate-two-forms": (policy([{
        "name": "r", "match": POD_MATCH,
        "validate": {"pattern": {"spec": {}}, "deny": {}}}]),
        "validate requires exactly one"),
    "json6902-path": (policy([{
        "name": "r", "match": POD_MATCH,
        "mutate": {"patchesJson6902": "- op: add\n  path: spec/x\n"
                                      "  value: 1\n"}}]), "forward slash"),
    "json6902-ok": (policy([{
        "name": "r", "match": POD_MATCH,
        "mutate": {"patchesJson6902": "- op: add\n  path: /spec/x\n"
                                      "  value: 1\n"}}]), None),
    "generate-data-and-clone": (policy([{
        "name": "r", "match": POD_MATCH,
        "generate": {"kind": "Secret", "name": "s", "data": {},
                     "clone": {"name": "a", "namespace": "b"}}}]),
        "exactly one of data or clone"),
    "background-user-info": (policy([{
        "name": "r", "match": POD_MATCH,
        "validate": {"message": "{{request.userInfo.username}}",
                     "pattern": {"spec": {}}}}], background=True),
        "cannot reference admission request data"),
    "context-variable-defined": (policy([{
        "name": "r", "match": POD_MATCH,
        "context": [{"name": "cm", "configMap": {"name": "x",
                                                 "namespace": "y"}}],
        "validate": {"message": "{{cm.data.k}}", "pattern": {"spec": {}}}}]),
        None),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_validate_policy(case):
    doc, want = POLICY_CASES[case]
    errors = validate_both(doc)
    if want is None:
        assert errors == []
    else:
        assert any(want in e for e in errors), errors


# ------------------------------------------------------ validate_resource

@pytest.fixture(autouse=True)
def _clean_schemas():
    yield
    for k in (PORT, JAX):
        for kind in ("Gadget", "Widget"):
            k.oa.unregister_schema(kind)


RESOURCE_CASES = {
    "valid-pod": ({"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "p", "labels": {"a": "b"}},
                   "spec": {"containers": [{
                       "name": "c", "image": "nginx:1.21",
                       "resources": {"requests": {"memory": "64Mi"}},
                       "ports": [{"containerPort": 80}]}]}}, None),
    "unknown-field": ({"kind": "Pod", "spec": {"containers": [
        {"name": "c", "imagePullPolice": "Always"}]}}, "imagePullPolice"),
    "wrong-type": ({"kind": "Pod", "spec": {"hostNetwork": "yes"}},
                   "boolean"),
    "unknown-kind": ({"kind": "MyCRD", "whatever": 1}, None),
    "deployment-template": ({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "d"},
        "spec": {"replicas": "two", "template": {"spec": {"containers": [
            {"name": "c", "image": "x", "ports": [
                {"containerPort": "http"}]}]}}}}, "replicas"),
    "cronjob": ({"apiVersion": "batch/v1", "kind": "CronJob",
                 "metadata": {"name": "c"},
                 "spec": {"schedule": "* * * * *", "jobTemplate": {
                     "spec": {"template": {"spec": {"containers": [
                         {"name": "c", "image": "x"}]}}}}}}, None),
}


@pytest.mark.parametrize("case", sorted(RESOURCE_CASES))
def test_validate_resource(case):
    doc, want = RESOURCE_CASES[case]
    errors = both(lambda k: k.oa.validate_resource(json_copy(doc)))
    if want is None:
        assert errors == []
    else:
        assert any(want in e for e in errors), errors


def test_registered_schema():
    for k in (PORT, JAX):
        k.oa.register_schema("Gadget", k.oa.obj({
            "kind": k.oa.STRING, "apiVersion": k.oa.STRING,
            "metadata": k.oa.obj(open_=True), "size": k.oa.STRING}))
    assert both(lambda k: k.oa.validate_resource(
        {"kind": "Gadget", "size": "big"})) == []
    errs = both(lambda k: k.oa.validate_resource({"kind": "Gadget",
                                                  "size": 3}))
    assert any("size" in e for e in errs)
    # each package's registry is its own
    PORT.oa.unregister_schema("Gadget")
    assert not PORT.oa.has_schema("Gadget") and JAX.oa.has_schema("Gadget")


# ----------------------------------------------- validate_policy_mutation

def mutate_policy(pattern, kinds=("Pod",), **spec):
    return policy([{"name": "m-r",
                    "match": {"resources": {"kinds": list(kinds)}},
                    "mutate": {"patchStrategicMerge": pattern}}],
                  name="m", **spec)


MUTATION_CASES = {
    "valid": (mutate_policy({"metadata": {"labels": {"+(team)": "x"}}}),
              None),
    "unknown-field": (mutate_policy({"spec": {"containers": [
        {"name": "c", "imagePullPolice": "Always"}]}}), "imagePullPolice"),
    "wrong-type": (mutate_policy({"spec": {"hostNetwork": "true"}}),
                   "hostNetwork"),
    "unknown-kind": (mutate_policy({"spec": {"anything": 1}},
                                   kinds=("MyCRD",)), None),
    "schema-validation-off": (mutate_policy(
        {"spec": {"hostNetwork": "true"}}, schemaValidation=False), None),
    "two-kinds": (mutate_policy({"spec": {"replicas": "x"}},
                                kinds=("Deployment", "StatefulSet")),
                  "replicas"),
}


@pytest.mark.parametrize("case", sorted(MUTATION_CASES))
def test_validate_policy_mutation(case):
    doc, want = MUTATION_CASES[case]
    errs = both(lambda k: k.oa.validate_policy_mutation(k.load(json_copy(doc))))
    if want is None:
        assert errs == []
    else:
        assert errs and want in errs[0]


@pytest.mark.parametrize("pattern, allowed", [
    ({"spec": {"hostNetwork": "not-a-bool"}}, False),
    ({"metadata": {"labels": {"+(team)": "x"}}}, True),
], ids=["schema-invalid-blocked", "valid-allowed"])
def test_policy_webhook_validation_steps(pattern, allowed):
    """The policy webhook's checks (webhook.py ``_policy_validation``
    without ``can_i_generate``): the structural check, then the mutate
    schema check; the same errors from each package."""
    doc = mutate_policy(pattern)

    def steps(k):
        p = k.load(json_copy(doc))
        return k.v.validate_policy(p) or k.oa.validate_policy_mutation(p)

    errs = both(steps)
    assert (errs == []) == allowed
    if not allowed:
        assert "hostNetwork" in "; ".join(errs)


# ------------------------------------------------------------ CRD sync

def _crd(kind="Gadget", group="acme.io", props=None, served=True):
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{kind.lower()}s.{group}"},
        "spec": {
            "group": group,
            "names": {"kind": kind, "plural": f"{kind.lower()}s"},
            "versions": [{
                "name": "v1", "served": served, "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "apiVersion": {"type": "string"},
                        "kind": {"type": "string"},
                        "metadata": {"type": "object",
                                     "x-kubernetes-preserve-unknown-fields":
                                         True},
                        "spec": {"type": "object", "properties": (props or {
                            "replicas": {"type": "integer"},
                            "mode": {"type": "string"},
                            "port": {"x-kubernetes-int-or-string": True},
                            "limits": {"type": "object",
                                       "additionalProperties":
                                           {"type": "string"}},
                        })},
                    },
                }},
            }],
        },
    }


WIDGET_DOC = {"definitions": {
    "io.acme.v1.Widget": {
        "type": "object",
        "properties": {"kind": {"type": "string"},
                       "apiVersion": {"type": "string"},
                       "metadata": {
                           "x-kubernetes-preserve-unknown-fields": True},
                       "spec": {"$ref": "#/definitions/WidgetSpec"}},
        "x-kubernetes-group-version-kind": [
            {"group": "acme.io", "kind": "Widget", "version": "v1"}],
    },
    "WidgetSpec": {"type": "object",
                   "properties": {"size": {"type": "integer"}}},
}}

CONVERSION_CASES = {
    "basic-shapes": {
        "type": "object",
        "properties": {
            "a": {"type": "string"},
            "b": {"type": "array", "items": {"type": "integer"}},
            "c": {"type": "object",
                  "additionalProperties": {"type": "boolean"}},
            "d": {"x-kubernetes-int-or-string": True},
            "e": {"type": "number"}, "f": {"type": "boolean"},
            "g": {"type": "object", "additionalProperties": True},
            "h": {"allOf": [{"type": "string"}]},
        }},
    "ref-cycle": {"$ref": "#/definitions/Inner"},
    "empty": {},
    "preserve-unknown": {"x-kubernetes-preserve-unknown-fields": True},
}
CYCLE_DEFS = {"Inner": {"type": "object", "properties": {
    "x": {"type": "string"}, "self": {"$ref": "#/definitions/Inner"}}}}


@pytest.mark.parametrize("case", sorted(CONVERSION_CASES))
def test_convert_openapi_schema(case):
    s = both(lambda k: k.crd.convert_openapi_schema(
        json_copy(CONVERSION_CASES[case]), json_copy(CYCLE_DEFS)))
    # tests/unit/test_crd_sync.py's expectations, on the port
    if case == "basic-shapes":
        assert s["type"] == "object" and not s["open"]
        assert s["fields"]["a"] == {"type": "string"}
        assert s["fields"]["b"]["items"] == {"type": "integer"}
        assert s["fields"]["c"] == {"type": "map",
                                    "values": {"type": "boolean"}}
        assert s["fields"]["d"] == {"type": "intstr"}
    elif case == "ref-cycle":
        assert s["fields"]["x"] == {"type": "string"}
        assert s["fields"]["self"]["type"] in ("object", "any")
    else:
        assert s == {"type": "any"}


def test_schemas_from_crd_and_openapi_document():
    out = both(lambda k: k.crd.schemas_from_openapi_v2(json_copy(WIDGET_DOC)))
    assert out["Widget"]["fields"]["spec"]["fields"]["size"] == \
        {"type": "integer"}
    assert set(both(lambda k: k.crd.schemas_from_crd(_crd()))) == {"Gadget"}
    assert both(lambda k: k.crd.schemas_from_crd(_crd(served=False))) == {}


def test_crd_schema_checks_documents():
    """schemas_from_crd -> register_schema -> validate_resource: a valid
    document and invalid ones, the same errors from each package."""
    for k in (PORT, JAX):
        for kind, schema in k.crd.schemas_from_crd(_crd()).items():
            k.oa.register_schema(kind, schema)
    assert both(lambda k: k.oa.validate_resource(
        {"kind": "Gadget", "spec": {"replicas": 3, "port": "http",
                                    "limits": {"cpu": "1"}}})) == []
    for bad in ({"replicas": "three"}, {"bogus": 1}, {"limits": {"cpu": 1}}):
        assert both(lambda k: k.oa.validate_resource(
            {"kind": "Gadget", "spec": bad}, "Gadget"))


def syncs(client):
    return {"port": PORT.crd.CrdSync(client), "jax": JAX.crd.CrdSync(client)}


def has_both(kind) -> bool:
    got, want = PORT.oa.has_schema(kind), JAX.oa.has_schema(kind)
    assert got == want
    return got


def test_sync_once_registers_crd_kinds():
    client = FakeCluster([_crd()])
    assert not has_both("Gadget")
    counts = {k: s.sync_once() for k, s in syncs(client).items()}
    assert counts["port"] == counts["jax"] >= 1
    assert has_both("Gadget")
    assert both(lambda k: k.oa.validate_resource(
        {"kind": "Gadget", "spec": {"replicas": 3}}, "Gadget")) == []
    assert both(lambda k: k.oa.validate_resource(
        {"kind": "Gadget", "spec": {"replicas": "three"}}, "Gadget"))


def test_watch_events_register_and_unregister():
    client = FakeCluster()
    ss = syncs(client)
    for s in ss.values():
        s.run()                  # FakeCluster: the global watch seam
    client.create_resource(_crd())
    assert has_both("Gadget")
    client.update_resource(_crd(served=False))
    assert not has_both("Gadget")
    client.update_resource(_crd())
    assert has_both("Gadget")
    client.delete_resource("apiextensions.k8s.io/v1",
                           "CustomResourceDefinition", "", "gadgets.acme.io")
    assert not has_both("Gadget")


def test_openapi_document_feeds_sync_and_pruning():
    client = FakeCluster([_crd()])
    client.openapi_document = json_copy(WIDGET_DOC)
    ss = syncs(client)
    for s in ss.values():
        s.sync_once()
    assert has_both("Widget") and has_both("Gadget")
    assert both(lambda k: k.oa.validate_resource(
        {"kind": "Widget", "spec": {"size": "big"}}, "Widget"))
    client.delete_resource("apiextensions.k8s.io/v1",
                           "CustomResourceDefinition", "", "gadgets.acme.io")
    for s in ss.values():
        s.sync_once()            # ticker-mode full reconcile
    assert not has_both("Gadget") and has_both("Widget")
    assert ss["port"].syncs == ss["jax"].syncs == 2


def test_stopped_sync_is_inert():
    client = FakeCluster()
    ss = syncs(client)
    for s in ss.values():
        s.run()
        s.stop()
    client.create_resource(_crd())
    assert not has_both("Gadget")


def test_sync_over_informer_and_ticker_clients():
    """A client with ``ensure_informer`` gets the informer's callbacks;
    one with neither it nor ``watch`` gets the ticker thread."""

    class Informer:
        def __init__(self):
            self.handlers = None

        def list_resource(self, api_version, kind, namespace=""):
            return [_crd()]

        def ensure_informer(self, api_version, kind, on_event, on_sync):
            self.handlers = (on_event, on_sync)

    class Lister:
        def list_resource(self, api_version, kind, namespace=""):
            return [_crd(kind="Widget")]

    informers = {"port": Informer(), "jax": Informer()}
    for name, k in (("port", PORT), ("jax", JAX)):
        k.crd.CrdSync(informers[name]).run()
    assert has_both("Gadget")
    for inf in informers.values():
        inf.handlers[1]([])      # a re-list with no CRD prunes the kind
    assert not has_both("Gadget")
    for inf in informers.values():
        inf.handlers[0]("ADDED", _crd())
    assert has_both("Gadget")
    tickers = [k.crd.CrdSync(Lister(), resync_interval_s=3600.0)
               for k in (PORT, JAX)]
    for s in tickers:
        s.run()
    assert has_both("Widget")
    assert all(s._thread is not None and s._thread.is_alive() for s in tickers)
    for s in tickers:
        s.stop()
        s._thread.join(timeout=5)


def test_mutate_policy_against_fresh_crd_is_schema_checked():
    """Before the CRD lands its kind skips validation; after a sync, a
    mutate policy writing a schema-invalid field is rejected and a valid
    one passes, in both packages."""
    bad = mutate_policy({"spec": {"replicas": "three"}}, kinds=("Gadget",))
    good = mutate_policy({"spec": {"replicas": 3}}, kinds=("Gadget",))

    def check(doc):
        return both(lambda k: k.oa.validate_policy_mutation(
            k.load(json_copy(doc))))

    assert check(bad) == []
    client = FakeCluster([_crd()])
    for s in syncs(client).values():
        s.sync_once()
    errs = check(bad)
    assert errs and "replicas" in errs[0]
    assert check(good) == []
