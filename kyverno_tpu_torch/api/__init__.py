from .types import (
    ClusterPolicy,
    ContextEntry,
    Generation,
    ImageVerification,
    MatchResources,
    Mutation,
    ResourceDescription,
    ResourceFilter,
    Rule,
    Spec,
    UserInfo,
    Validation,
)
from .load import load_policy, load_policies_from_path, load_resources

__all__ = [
    "ClusterPolicy",
    "ContextEntry",
    "Generation",
    "ImageVerification",
    "MatchResources",
    "Mutation",
    "ResourceDescription",
    "ResourceFilter",
    "Rule",
    "Spec",
    "UserInfo",
    "Validation",
    "load_policy",
    "load_policies_from_path",
    "load_resources",
]
