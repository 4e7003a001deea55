"""Which policies a worker without a cluster client can evaluate.

The JAX package's oracle pool runs the per-request validate loop in
spawned worker processes, for *cluster-independent* policies only. This
module holds the predicate that decides it, :func:`pool_safe`; the host
lane reads it to choose a memo entry's lifetime (a pure policy's
verdict is a function of the policy and the body alone). The pool
itself waits for the policy cache and the webhook.
"""

from __future__ import annotations


def pool_safe(policy) -> bool:
    """True when every rule of the policy evaluates without a cluster
    client: no context entries (ConfigMap/APICall loads) at the rule
    level OR inside foreach entries — validate foreach carries its own
    ``context:`` list loaded per-iteration (ForEach.context), and a
    worker has no client/resource_cache to serve it."""
    for rule in policy.spec.rules:
        if rule.context:
            return False
        for fe in list(rule.validation.foreach) + list(rule.mutation.foreach):
            if fe.context:
                return False
    return True
