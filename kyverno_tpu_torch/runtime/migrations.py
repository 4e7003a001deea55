"""One-shot backward-compatibility migrations, run by the leader at start.

Mirrors kyverno/pkg/backward_compatibility/add_labels.go:
``add_gr_labels`` stamps tracking labels onto pre-existing
GenerateRequests (AddLabels, :20) and ``add_clone_labels`` marks the
source resources of generate-clone policies (AddCloneLabel, :86), so
objects created by an older controller participate in the current
label-based lookups without manual intervention.
"""

from __future__ import annotations

import logging

log = logging.getLogger("kyverno.migrations")


def add_gr_labels(client, namespace: str = "kyverno") -> int:
    """AddLabels (add_labels.go:20): label every existing GenerateRequest
    with its policy/resource coordinates. Returns the number updated."""
    updated = 0
    for gr in client.list_resource("kyverno.io/v1", "GenerateRequest",
                                   namespace):
        spec = gr.get("spec") or {}
        resource = spec.get("resource") or {}
        meta = gr.setdefault("metadata", {})
        labels = meta.get("labels") or {}
        want = {
            "generate.kyverno.io/policy-name": spec.get("policy", ""),
            "generate.kyverno.io/resource-name": resource.get("name", ""),
            "generate.kyverno.io/resource-kind": resource.get("kind", ""),
            "generate.kyverno.io/resource-namespace":
                resource.get("namespace", ""),
        }
        if all(labels.get(k) == v for k, v in want.items()):
            continue
        labels.update(want)
        meta["labels"] = labels
        try:
            client.update_resource(gr)
            updated += 1
        except Exception:
            log.info("failed to label GenerateRequest %s",
                     meta.get("name", ""), exc_info=True)
    return updated


def add_clone_labels(client) -> int:
    """AddCloneLabel (add_labels.go:86): label the clone-source resources
    of generate policies so source updates re-trigger synchronization.
    Returns the number updated."""
    from ..api.load import load_policy

    updated = 0
    for doc in client.list_resource("kyverno.io/v1", "ClusterPolicy"):
        try:
            policy = load_policy(doc)
        except Exception:
            continue
        for rule in policy.spec.rules:
            clone = rule.generation.clone if rule.has_generate() else None
            if not clone or not clone.get("name"):
                continue
            kind = rule.generation.kind
            source = client.get_resource(
                rule.generation.api_version or "v1", kind,
                clone.get("namespace", ""), clone["name"])
            if source is None:
                continue
            meta = source.setdefault("metadata", {})
            labels = meta.get("labels") or {}
            key = "generate.kyverno.io/clone-policy-name"
            if policy.name in (labels.get(key) or "").split(","):
                continue
            labels[key] = (f"{labels[key]},{policy.name}"
                           if labels.get(key) else policy.name)
            meta["labels"] = labels
            try:
                client.update_resource(source)
                updated += 1
            except Exception:
                log.info("failed to label clone source %s/%s", kind,
                         clone["name"], exc_info=True)
    return updated


def run_all(client, namespace: str = "kyverno") -> None:
    """cmd/kyverno/main.go:523-524: both migrations, once, at startup."""
    add_gr_labels(client, namespace)
    add_clone_labels(client)
