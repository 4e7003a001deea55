"""Mutation handlers: strategic-merge patch, RFC6902 patches, overlay.

Mirrors kyverno/pkg/engine/mutate/. The deprecated ``overlay`` form
is rewritten to patchStrategicMerge exactly as the reference does
(mutate/mutation.go:25-30).
"""

from .json_patch import apply_patch_ops, create_patch, generate_patches
from .strategic_merge import (
    ConditionError,
    GlobalConditionError,
    strategic_merge_patch,
)

__all__ = [
    "apply_patch_ops",
    "create_patch",
    "generate_patches",
    "ConditionError",
    "GlobalConditionError",
    "strategic_merge_patch",
]
