"""The generate engine on both packages: ``generate`` (the admission-time
filter) and ``apply_generate_rule`` (``data`` and ``clone``
materialization) against the test's own client and each package's
``FakeCluster``.

Every case of tests/unit/test_generation.py's generate classes runs on the
JAX package and on the port with the same inputs: the rule responses
(name, type, status, message), the generated documents and their modes
are equal, and the JAX test's own expectations hold on the port. Its
policy-validation cases are in test_torch_policy.py.
"""

import json
from types import SimpleNamespace

import pytest

import kyverno_tpu.engine.generation as jax_generation
import kyverno_tpu_torch.engine.generation as generation
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.engine.context import Context as JaxContext
from kyverno_tpu.engine.policy_context import PolicyContext as JaxPolicyContext
from kyverno_tpu.runtime.client import FakeCluster as JaxFakeCluster
from kyverno_tpu_torch.api.load import load_policy
from kyverno_tpu_torch.engine.context import Context
from kyverno_tpu_torch.engine.policy_context import PolicyContext
from kyverno_tpu_torch.engine.response import RuleStatus
from kyverno_tpu_torch.runtime.client import FakeCluster
from kyverno_tpu_torch.utils.jsoncopy import json_copy

JAX = SimpleNamespace(load=jax_load_policy, Context=JaxContext,
                      PolicyContext=JaxPolicyContext, gen=jax_generation,
                      FakeCluster=JaxFakeCluster)
PORT = SimpleNamespace(load=load_policy, Context=Context,
                       PolicyContext=PolicyContext, gen=generation,
                       FakeCluster=FakeCluster)


class FakeClient:
    """tests/unit/test_generation.py's client: (kind, namespace, name) ->
    resource."""

    def __init__(self, resources=None):
        self.resources = resources or {}

    def get_resource(self, api_version, kind, namespace, name):
        return self.resources.get((kind, namespace, name))

    def list_resource(self, api_version, kind, namespace):
        return [v for (k, ns, _), v in self.resources.items()
                if k == kind and (not namespace or ns == namespace)]

    def get_configmap(self, namespace, name):
        return self.resources.get(("ConfigMap", namespace, name))


GEN_POLICY = {
    "apiVersion": "kyverno.io/v1",
    "kind": "ClusterPolicy",
    "metadata": {"name": "add-networkpolicy"},
    "spec": {"rules": [{
        "name": "default-deny",
        "match": {"resources": {"kinds": ["Namespace"]}},
        "generate": {
            "apiVersion": "networking.k8s.io/v1",
            "kind": "NetworkPolicy",
            "name": "default-deny",
            "namespace": "{{request.object.metadata.name}}",
            "synchronize": True,
            "data": {
                "spec": {"podSelector": {},
                         "policyTypes": ["Ingress", "Egress"]}
            },
        },
    }]},
}

CLONE_POLICY = {
    "apiVersion": "kyverno.io/v1",
    "kind": "ClusterPolicy",
    "metadata": {"name": "clone-secret"},
    "spec": {"rules": [{
        "name": "clone-regcred",
        "match": {"resources": {"kinds": ["Namespace"]}},
        "generate": {
            "apiVersion": "v1", "kind": "Secret", "name": "regcred",
            "namespace": "{{request.object.metadata.name}}",
            "clone": {"namespace": "default", "name": "regcred"},
        },
    }]},
}

SELF_CLONE_POLICY = {
    "apiVersion": "kyverno.io/v1",
    "kind": "ClusterPolicy",
    "metadata": {"name": "self-clone"},
    "spec": {"rules": [{
        "name": "r",
        "match": {"resources": {"kinds": ["Namespace"]}},
        "generate": {
            "apiVersion": "v1", "kind": "Secret", "name": "s",
            "namespace": "ns", "clone": {"namespace": "ns", "name": "s"},
        },
    }]},
}

NAMESPACE = {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": "team-a"}}
POD = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p"}}
SECRET = {
    "apiVersion": "v1", "kind": "Secret",
    "metadata": {"name": "regcred", "namespace": "default",
                 "resourceVersion": "7", "uid": "u1"},
    "data": {"token": "eA=="},
}


def make_ctx(pkg, policy_doc, resource, client=None):
    jctx = pkg.Context()
    jctx.add_resource(json_copy(resource))
    return pkg.PolicyContext(policy=pkg.load(json_copy(policy_doc)),
                             new_resource=json_copy(resource),
                             json_context=jctx, client=client)


def rules_view(resp) -> list:
    return [(r.name, r.type.value, r.status.value, r.message)
            for r in resp.policy_response.rules]


def generate_both(policy_doc, resource, old=None):
    """The port's response to ``generate``, after holding its rules, its
    policy and its resource to the JAX one's."""
    out = []
    for pkg in (PORT, JAX):
        ctx = make_ctx(pkg, policy_doc, resource)
        if old is not None:
            ctx.old_resource = json_copy(old)
        out.append(pkg.gen.generate(ctx))
    got, want = out
    assert rules_view(got) == rules_view(want)
    pr, wr = got.policy_response, want.policy_response
    assert (pr.policy.name, pr.resource.kind, pr.resource.name) == \
        (wr.policy.name, wr.resource.kind, wr.resource.name)
    return got


def apply_both(policy_doc, trigger, make_client):
    """``apply_generate_rule`` of the policy's first rule on each package,
    each with a client of its own from ``make_client(package)``; the
    port's (resource, mode), after holding it to the JAX one's (the same
    bytes as JSON)."""
    out = []
    for pkg in (PORT, JAX):
        client = make_client(pkg)
        ctx = make_ctx(pkg, policy_doc, trigger, client=client)
        out.append(pkg.gen.apply_generate_rule(
            ctx.policy.spec.rules[0], ctx, json_copy(trigger), client))
    got, want = out
    assert json.dumps(got) == json.dumps(want)
    return got


# ------------------------------------------------------------ the filter

@pytest.mark.parametrize("resource, old, want", [
    (NAMESPACE, None, [RuleStatus.PASS]),
    (POD, None, []),                     # a kind the rule does not match
    (POD, NAMESPACE, [RuleStatus.FAIL]),  # the old resource matched
], ids=["matching", "other-kind", "old-resource-matched"])
def test_generate_filter(resource, old, want):
    resp = generate_both(GEN_POLICY, resource, old)
    assert [r.status for r in resp.policy_response.rules] == want


def test_filter_preconditions_and_non_generate_rules():
    """A rule whose preconditions fail gives no row, a validate rule is
    not a generate rule, and a passing precondition keeps the row."""
    doc = json_copy(GEN_POLICY)
    rule = doc["spec"]["rules"][0]
    doc["spec"]["rules"] = [
        dict(rule, name="gated", preconditions={"all": [{
            "key": "{{request.object.metadata.name}}",
            "operator": "Equals", "value": "team-a"}]}),
        dict(rule, name="gated-out", preconditions={"all": [{
            "key": "{{request.object.metadata.name}}",
            "operator": "Equals", "value": "team-b"}]}),
        {"name": "a-validate-rule",
         "match": {"resources": {"kinds": ["Namespace"]}},
         "validate": {"pattern": {"metadata": {"name": "?*"}}}},
    ]
    resp = generate_both(doc, NAMESPACE)
    assert [(r.name, r.status) for r in resp.policy_response.rules] == \
        [("gated", RuleStatus.PASS)]


# ------------------------------------------------------- materialization

EXISTING_NETPOL = {("NetworkPolicy", "team-a", "default-deny"):
                   {"metadata": {"resourceVersion": "42"}}}


@pytest.mark.parametrize("policy, resources, mode", [
    (GEN_POLICY, {}, generation.MODE_CREATE),
    (GEN_POLICY, EXISTING_NETPOL, generation.MODE_UPDATE),
    (CLONE_POLICY, {("Secret", "default", "regcred"): SECRET},
     generation.MODE_CREATE),
    (SELF_CLONE_POLICY, {}, generation.MODE_SKIP),
], ids=["data-create", "data-update", "clone", "self-clone"])
def test_apply_generate_rule(policy, resources, mode):
    resource, got_mode = apply_both(
        policy, NAMESPACE, lambda pkg: FakeClient(json_copy(resources)))
    assert got_mode == mode
    if mode == generation.MODE_SKIP:
        assert resource is None
        return
    meta = resource["metadata"]
    assert meta["namespace"] == "team-a"              # substituted
    labels = meta["labels"]
    assert labels["kyverno.io/generated-by-policy"] == \
        policy["metadata"]["name"]
    assert labels["kyverno.io/generated-by-name"] == "team-a"
    if policy is GEN_POLICY:
        assert resource["kind"] == "NetworkPolicy"
        if mode == generation.MODE_UPDATE:
            assert meta["resourceVersion"] == "42"
    else:
        assert resource["data"] == {"token": "eA=="}
        assert "resourceVersion" not in meta and "uid" not in meta


def test_apply_generate_rule_over_fake_cluster():
    """A clone whose target exists (the target's own fields kept, an
    update), again after the target's data changed, and offline, against
    each package's FakeCluster as its client."""
    target = json_copy(SECRET)
    target["metadata"].update(namespace="team-a", uid="u9",
                              resourceVersion="3")
    resource, mode = apply_both(
        CLONE_POLICY, NAMESPACE,
        lambda pkg: pkg.FakeCluster([json_copy(SECRET),
                                     json_copy(target)]))
    assert mode == generation.MODE_UPDATE
    assert resource["metadata"]["uid"] == "u9"
    # a target whose data differs gets the source's
    target["data"] = {"token": "other"}
    resource, mode = apply_both(
        CLONE_POLICY, NAMESPACE,
        lambda pkg: pkg.FakeCluster([json_copy(SECRET),
                                     json_copy(target)]))
    assert mode == generation.MODE_UPDATE and resource["data"] == SECRET["data"]
    # offline (no client): a clone is skipped, data always creates
    assert apply_both(CLONE_POLICY, NAMESPACE, lambda pkg: None) == \
        (None, generation.MODE_SKIP)
    resource, mode = apply_both(GEN_POLICY, NAMESPACE, lambda pkg: None)
    assert mode == generation.MODE_CREATE


@pytest.mark.parametrize("policy, match", [
    (CLONE_POLICY, "not found"),
    ({**GEN_POLICY, "spec": {"rules": [{
        **GEN_POLICY["spec"]["rules"][0],
        "generate": {**GEN_POLICY["spec"]["rules"][0]["generate"],
                     "namespace": "{{request.object.metadata.nope}}"}}]}},
     "variable substitution failed"),
], ids=["clone-source-missing", "unresolvable-variable"])
def test_generate_errors(policy, match):
    """The same GenerateError, with the same message, from each package."""
    messages = []
    for pkg in (PORT, JAX):
        client = FakeClient()
        ctx = make_ctx(pkg, policy, NAMESPACE, client=client)
        with pytest.raises(pkg.gen.GenerateError, match=match) as e:
            pkg.gen.apply_generate_rule(ctx.policy.spec.rules[0], ctx,
                                        NAMESPACE, client)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_many_namespaces_generate_as_the_jax_package_does():
    """``generate`` then ``apply_generate_rule`` over 40 Namespaces with a
    ``data`` rule and a ``clone`` rule in one policy: the same documents
    and modes, in the same order."""
    doc = json_copy(GEN_POLICY)
    doc["spec"]["rules"].append(CLONE_POLICY["spec"]["rules"][0])
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        client = FakeClient({("Secret", "default", "regcred"):
                             json_copy(SECRET)})
        made = []
        for i in range(40):
            ns = {"apiVersion": "v1", "kind": "Namespace",
                  "metadata": {"name": f"team-{i}",
                               "labels": {"tier": str(i % 3)}}}
            ctx = make_ctx(pkg, doc, ns, client=client)
            resp = pkg.gen.generate(ctx)
            for rr in resp.policy_response.rules:
                if rr.status.value != "pass":
                    continue
                rule = next(r for r in ctx.policy.spec.rules
                            if r.name == rr.name)
                made.append(pkg.gen.apply_generate_rule(rule, ctx, ns,
                                                        client))
        out[name] = made
    assert len(out["port"]) == 80
    assert json.dumps(out["port"]) == json.dumps(out["jax"])
