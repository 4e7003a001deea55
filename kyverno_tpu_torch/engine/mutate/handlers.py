"""Mutate handler dispatch (mirrors kyverno/pkg/engine/mutate/mutation.go).

Order matters and matches CreateMutateHandler: patchStrategicMerge,
patchesJson6902, overlay (rewritten to strategic merge), raw patches,
foreach."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..response import RuleStatus
from .json_patch import (
    JsonPatchError,
    apply_patch_ops,
    generate_patches,
    get_by_pointer,
)
from .strategic_merge import strategic_merge_patch


@dataclass
class MutateResult:
    status: RuleStatus = RuleStatus.PASS
    message: str = ""
    patches: list = field(default_factory=list)
    patched_resource: dict | None = None


def apply_mutation(mutation, resource: dict, foreach_index: int = 0) -> MutateResult:
    """CreateMutateHandler + Handle."""
    if mutation.patch_strategic_merge is not None:
        return process_strategic_merge(mutation.patch_strategic_merge, resource)
    if mutation.patches_json6902:
        return process_patches_json6902(mutation.patches_json6902, resource)
    if mutation.overlay is not None:
        # deprecated overlay is a strategic merge patch (mutation.go:25-30)
        return process_strategic_merge(mutation.overlay, resource)
    if mutation.patches:
        return process_raw_patches(mutation.patches, resource)
    if mutation.foreach:
        fe = mutation.foreach[foreach_index]
        if fe.patch_strategic_merge is None:
            return MutateResult(
                status=RuleStatus.FAIL,
                message="foreach mutation entry has no patchStrategicMerge",
                patched_resource=resource,
            )
        return process_strategic_merge(fe.patch_strategic_merge, resource)
    return MutateResult(patched_resource=resource, patches=[])


def process_strategic_merge(overlay, resource: dict) -> MutateResult:
    """strategicMergePatch.go:19 ProcessStrategicMergePatch."""
    if overlay is None:
        return MutateResult(
            status=RuleStatus.FAIL,
            message="empty patchStrategicMerge",
            patched_resource=resource,
        )
    try:
        patched = strategic_merge_patch(resource, overlay)
    except Exception as e:
        return MutateResult(
            status=RuleStatus.FAIL,
            message=f"failed to apply patchStrategicMerge: {e}",
            patched_resource=resource,
        )
    patches = generate_patches(resource, patched)
    return MutateResult(
        status=RuleStatus.PASS,
        message="successfully processed strategic merge patch",
        patches=patches,
        patched_resource=patched,
    )


def process_patches_json6902(patches_str: str, resource: dict) -> MutateResult:
    """patchJson6902.go:16 ProcessPatchJSON6902 (+ convertPatchesToJSON:
    the patch arrives as a YAML or JSON string). PyYAML is imported here,
    where a string is parsed, so the mutate path loads without it."""
    import yaml

    try:
        ops = yaml.safe_load(patches_str)
    except yaml.YAMLError as e:
        return MutateResult(
            status=RuleStatus.FAIL,
            message=f"failed to convert patchesJson6902 to JSON: {e}",
            patched_resource=resource,
        )
    if not isinstance(ops, list):
        return MutateResult(
            status=RuleStatus.FAIL,
            message="patchesJson6902 must be a list of RFC6902 operations",
            patched_resource=resource,
        )
    try:
        patched = apply_patch_ops(resource, ops)
    except JsonPatchError as e:
        return MutateResult(
            status=RuleStatus.FAIL,
            message=f"unable to apply RFC 6902 patches: {e}",
            patched_resource=resource,
        )
    patches = generate_patches(resource, patched)
    return MutateResult(
        status=RuleStatus.PASS,
        message="successfully process JSON6902 patches",
        patches=patches,
        patched_resource=patched,
    )


def process_raw_patches(raw_patches: list[dict], resource: dict) -> MutateResult:
    """patches.go:23 ProcessPatches: apply one-by-one; a failing 'remove'
    is skipped, any other failure fails the rule."""
    patched = resource
    applied: list[dict] = []
    errors: list[str] = []
    for patch in raw_patches:
        try:
            if patch.get("op") == "remove":
                # apply_patch_ops tolerates missing removes; the reference
                # (patches.go:55) skips them without recording the patch
                get_by_pointer(patched, patch.get("path", ""))
            patched = apply_patch_ops(patched, [patch])
        except JsonPatchError as e:
            if patch.get("op") == "remove":
                continue
            errors.append(str(e))
            continue
        applied.append(patch)
    if errors:
        return MutateResult(
            status=RuleStatus.FAIL,
            message=f"failed to process JSON patches: {';'.join(errors)}",
            patched_resource=resource,
        )
    return MutateResult(
        status=RuleStatus.PASS,
        message="successfully process JSON patches",
        patches=applied,
        patched_resource=patched,
    )
