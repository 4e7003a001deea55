"""ForceMutate: apply mutate rules unconditionally (CLI dry-runs).

Mirrors kyverno/pkg/engine/forceMutate.go:56. Unresolvable
variables become placeholders when no context is given; anchors still
resolve against the resource (a condition miss yields an empty patch).
"""

from __future__ import annotations

import copy

from .mutate.handlers import (
    process_patches_json6902,
    process_raw_patches,
    process_strategic_merge,
)
from .response import RuleStatus
from .variables import substitute_all_force_mutate


class ForceMutateError(Exception):
    pass


def force_mutate(ctx, policy, resource: dict) -> dict:
    """forceMutate.go:56 ForceMutate: returns the fully mutated resource."""
    resource = copy.deepcopy(resource)
    for rule in policy.spec.rules:
        if not rule.has_mutate():
            continue

        mutation = copy.copy(rule.mutation)
        if mutation.overlay is not None:
            mutation.overlay = substitute_all_force_mutate(ctx, mutation.overlay)
        if mutation.patch_strategic_merge is not None:
            mutation.patch_strategic_merge = substitute_all_force_mutate(
                ctx, mutation.patch_strategic_merge
            )
        if mutation.patches:
            mutation.patches = substitute_all_force_mutate(ctx, mutation.patches)
        if mutation.patches_json6902:
            mutation.patches_json6902 = substitute_all_force_mutate(
                ctx, mutation.patches_json6902
            )

        if mutation.overlay is not None:
            result = process_strategic_merge(mutation.overlay, resource)
            if result.status is not RuleStatus.PASS:
                raise ForceMutateError(
                    f"failed to mutate resource with overlay rule {rule.name}: {result.message}"
                )
            resource = result.patched_resource

        if mutation.patches:
            result = process_raw_patches(mutation.patches, resource)
            if result.status is not RuleStatus.PASS:
                raise ForceMutateError(result.message)
            resource = result.patched_resource

        if mutation.patch_strategic_merge is not None:
            result = process_strategic_merge(mutation.patch_strategic_merge, resource)
            if result.status is not RuleStatus.PASS:
                raise ForceMutateError(result.message)
            resource = result.patched_resource

        if mutation.patches_json6902:
            result = process_patches_json6902(mutation.patches_json6902, resource)
            if result.status is not RuleStatus.PASS:
                raise ForceMutateError(result.message)
            resource = result.patched_resource

        if mutation.foreach:
            for fe in mutation.foreach:
                if fe.patch_strategic_merge is not None:
                    psm = substitute_all_force_mutate(ctx, fe.patch_strategic_merge)
                    result = process_strategic_merge(psm, resource)
                    if result.status is not RuleStatus.PASS:
                        raise ForceMutateError(result.message)
                    resource = result.patched_resource
    return resource
