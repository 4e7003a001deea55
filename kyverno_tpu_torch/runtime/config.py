"""Dynamic configuration (hot-reloaded ConfigMap).

Mirrors kyverno/pkg/config/dynamicconfig.go: ``resourceFilters``
([kind,namespace,name] tuples skipped at admission), ``excludeGroupRole``,
``excludeUsername``, ``webhooks`` narrowing, ``generateSuccessEvents`` —
parsed from the kyverno ConfigMap's data and swapped atomically; observers
get change notifications (the reconcile channels of cmd/kyverno/main.go:260).
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass

from ..utils.wildcard import wildcard_match

# dynamicconfig.go:24-30 defaults
DEFAULT_EXCLUDE_GROUP_ROLE = ["system:serviceaccounts:kube-system", "system:nodes", "system:kube-scheduler"]

_FILTER_RE = re.compile(r"\[([^\[\]]*)\]")


@dataclass(frozen=True)
class ResourceFilter:
    """config.go k8Resource: [Kind,namespace,name] with wildcards."""

    kind: str = "*"
    namespace: str = "*"
    name: str = "*"


def parse_kinds(raw: str) -> list[ResourceFilter]:
    """dynamicconfig.go:372 parseKinds: "[Kind,ns,name][Kind2,...]"."""
    out = []
    for m in _FILTER_RE.finditer(raw or ""):
        parts = [p.strip() for p in m.group(1).split(",")]
        parts += ["*"] * (3 - len(parts))
        out.append(ResourceFilter(*(p or "*" for p in parts[:3])))
    return out


def parse_rbac(raw: str) -> list[str]:
    """dynamicconfig.go:392 parseRbac: comma-separated role list."""
    return [p.strip() for p in (raw or "").split(",") if p.strip()]


@dataclass
class WebhookConfig:
    namespace_selector: dict | None = None
    object_selector: dict | None = None


class ConfigData:
    """dynamicconfig.go:32 ConfigData."""

    def __init__(self, configmap_data: dict | None = None):
        self._lock = threading.RLock()
        self._filters: list[ResourceFilter] = []
        self._exclude_group_role: list[str] = list(DEFAULT_EXCLUDE_GROUP_ROLE)
        self._exclude_username: list[str] = []
        self._webhooks: list[WebhookConfig] = []
        self._generate_success_events: bool = False
        self._observers: list = []
        if configmap_data is not None:
            self.load(configmap_data)

    # ------------------------------------------------------------ reads

    def to_filter(self, kind: str, namespace: str, name: str) -> bool:
        """dynamicconfig.go:49 ToFilter: True => skip this resource."""
        with self._lock:
            for f in self._filters:
                if (
                    wildcard_match(f.kind, kind)
                    and wildcard_match(f.namespace, namespace)
                    and wildcard_match(f.name, name)
                ):
                    return True
            # kyverno's own namespace is always filtered (config.go)
            if namespace == "kyverno":
                return True
        return False

    def get_exclude_group_role(self) -> list[str]:
        with self._lock:
            return list(self._exclude_group_role)

    def get_exclude_username(self) -> list[str]:
        with self._lock:
            return list(self._exclude_username)

    def get_webhooks(self) -> list[WebhookConfig]:
        with self._lock:
            return list(self._webhooks)

    def generate_success_events(self) -> bool:
        with self._lock:
            return self._generate_success_events

    # ------------------------------------------------------------ writes

    def load(self, data: dict) -> None:
        """dynamicconfig.go:233 load: swap config from ConfigMap data."""
        import json

        with self._lock:
            self._filters = parse_kinds(data.get("resourceFilters", ""))
            if "excludeGroupRole" in data:
                self._exclude_group_role = (
                    parse_rbac(data["excludeGroupRole"]) + DEFAULT_EXCLUDE_GROUP_ROLE
                )
            else:
                self._exclude_group_role = list(DEFAULT_EXCLUDE_GROUP_ROLE)
            self._exclude_username = parse_rbac(data.get("excludeUsername", ""))
            self._generate_success_events = (
                str(data.get("generateSuccessEvents", "false")).lower() == "true"
            )
            webhooks = []
            raw = data.get("webhooks", "")
            if raw:
                try:
                    for entry in json.loads(raw):
                        webhooks.append(WebhookConfig(
                            namespace_selector=entry.get("namespaceSelector"),
                            object_selector=entry.get("objectSelector"),
                        ))
                except (ValueError, AttributeError):
                    pass
            self._webhooks = webhooks
            observers = list(self._observers)
        for notify in observers:
            notify()

    def on_change(self, callback) -> None:
        with self._lock:
            self._observers.append(callback)
