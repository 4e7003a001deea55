"""Self-subject access review helpers.

Mirrors kyverno/pkg/auth (CanIOptions, auth.go:15-110) and
pkg/policy/generate/auth.go (the Operations wrapper): before accepting a
generate policy, the controller checks its *own* RBAC permissions to
create/update/get/delete the target kind, so a policy that kyverno cannot
actually execute is rejected at admission instead of failing later in the
generate controller.
"""

from __future__ import annotations


class CanIOptions:
    """auth.go:15 CanIOptions: one (kind, namespace, verb) access check."""

    def __init__(self, client, kind: str, namespace: str, verb: str):
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self.verb = verb

    def run_access_check(self) -> bool:
        """auth.go:43 RunAccessCheck: create a SelfSubjectAccessReview and
        read status.allowed. No client (offline/CLI) => allowed."""
        if self.client is None:
            return True
        review = {
            "apiVersion": "authorization.k8s.io/v1",
            "kind": "SelfSubjectAccessReview",
            "spec": {"resourceAttributes": {
                "namespace": self.namespace,
                "verb": self.verb,
                "resource": _plural(self.kind),
            }},
        }
        try:
            resp = self.client.create_resource(review)
        except Exception:
            return False
        return bool(((resp or {}).get("status") or {}).get("allowed", False))


def _pluralize(kind: str) -> str:
    """The JAX package's ``webhookconfig._pluralize``, kept here until
    the port has ``webhookconfig``."""
    k = kind.lower()
    if k.endswith(("s", "x", "z", "ch", "sh")):
        return k + "es"
    if k.endswith("y") and k[-2:-1] not in "aeiou":
        return k[:-1] + "ies"
    return k + "s"


def _plural(kind: str) -> str:
    return _pluralize(kind.split("/")[-1])


class Auth:
    """policy/generate/auth.go Operations implementation."""

    def __init__(self, client):
        self.client = client

    def can_i_create(self, kind: str, namespace: str) -> bool:
        return CanIOptions(self.client, kind, namespace, "create").run_access_check()

    def can_i_update(self, kind: str, namespace: str) -> bool:
        return CanIOptions(self.client, kind, namespace, "update").run_access_check()

    def can_i_delete(self, kind: str, namespace: str) -> bool:
        return CanIOptions(self.client, kind, namespace, "delete").run_access_check()

    def can_i_get(self, kind: str, namespace: str) -> bool:
        return CanIOptions(self.client, kind, namespace, "get").run_access_check()


def can_i_generate(policy, client) -> list[str]:
    """policy/generate/validate.go:102 canIGenerate: every generate rule's
    target kind must be creatable/updatable/gettable by the controller."""
    if client is None:
        return []
    auth = Auth(client)
    errors: list[str] = []
    for rule in policy.spec.rules:
        if not rule.has_generate():
            continue
        kind = rule.generation.kind
        namespace = rule.generation.namespace
        if "{{" in kind:
            continue  # variable kinds resolve at generate time
        if "{{" in namespace:
            namespace = ""  # variable target namespace -> cluster-wide check
        for verb, check in (("create", auth.can_i_create),
                            ("update", auth.can_i_update),
                            ("get", auth.can_i_get),
                            ("delete", auth.can_i_delete)):
            if not check(kind, namespace):
                errors.append(
                    f"rule {rule.name}: controller lacks permission to "
                    f"{verb} {kind} in namespace {namespace or '<cluster>'}")
    return errors
