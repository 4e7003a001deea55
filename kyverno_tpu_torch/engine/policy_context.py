"""PolicyContext — the single input struct to every engine entry point.

Mirrors kyverno/pkg/engine/policyContext.go:12-60. ``client`` is any
object exposing ``get_resource(api_version, kind, namespace, name)`` /
``list_resource(api_version, kind, namespace)`` / ``get_configmap(namespace,
name)`` — a live cluster client, a snapshot store, or None for offline runs.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..api.types import ClusterPolicy
from .context import Context
from .match import RequestInfo


@dataclass
class PolicyContext:
    policy: ClusterPolicy = field(default_factory=ClusterPolicy)
    new_resource: dict = field(default_factory=dict)
    old_resource: dict = field(default_factory=dict)
    element: Optional[dict] = None                     # foreach loop element
    admission_info: RequestInfo = field(default_factory=RequestInfo)
    exclude_group_role: list[str] = field(default_factory=list)
    exclude_resource_func: Optional[Callable[[str, str, str], bool]] = None
    client: Any = None
    resource_cache: Any = None  # pkg/resourcecache seam: cached listers for
    # ConfigMap context entries; falls back to ``client`` when absent
    json_context: Context = field(default_factory=Context)
    namespace_labels: dict[str, str] = field(default_factory=dict)

    def copy(self) -> "PolicyContext":
        """policyContext.go Copy: shallow copy sharing the JSON context, so
        foreach iterations see checkpoint/restore effects (validation.go:236)."""
        c = copy.copy(self)
        return c

    def excluded_by_func(self, kind: str, namespace: str, name: str) -> bool:
        if self.exclude_resource_func is None:
            return False
        return self.exclude_resource_func(kind, namespace, name)
