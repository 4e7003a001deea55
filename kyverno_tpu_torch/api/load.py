"""Policy / resource loaders.

``load_policy`` takes a dict and needs nothing else; the path loaders
import PyYAML when called, so a machine without it can still build
policies from dicts."""

from __future__ import annotations

import os
from typing import Iterable

from .types import ClusterPolicy

_POLICY_KINDS = {"ClusterPolicy", "Policy"}


def load_policy(doc: dict) -> ClusterPolicy:
    return ClusterPolicy.from_dict(doc)


def _iter_yaml_docs(path: str) -> Iterable[dict]:
    import yaml

    with open(path) as f:
        for doc in yaml.safe_load_all(f):
            if isinstance(doc, dict):
                yield doc


def load_policies_from_path(path: str) -> list[ClusterPolicy]:
    """Load policies from a YAML file or a directory of YAML files."""
    policies: list[ClusterPolicy] = []
    files: list[str] = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith((".yaml", ".yml")):
                files.append(os.path.join(path, name))
    else:
        files.append(path)
    for fp in files:
        for doc in _iter_yaml_docs(fp):
            if doc.get("kind") in _POLICY_KINDS:
                policies.append(load_policy(doc))
    return policies


def load_resources(path: str) -> list[dict]:
    """Load non-policy Kubernetes resources from a YAML file or directory."""
    resources: list[dict] = []
    files: list[str] = []
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith((".yaml", ".yml")):
                files.append(os.path.join(path, name))
    else:
        files.append(path)
    for fp in files:
        for doc in _iter_yaml_docs(fp):
            if doc.get("kind") and doc.get("kind") not in _POLICY_KINDS:
                resources.append(doc)
    return resources
