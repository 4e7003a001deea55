"""Accessors over untyped Kubernetes resource JSON (unstructured twin)."""

from __future__ import annotations


def get_kind(resource: dict) -> str:
    return resource.get("kind", "") or ""


def get_api_version(resource: dict) -> str:
    return resource.get("apiVersion", "") or ""


def get_name(resource: dict) -> str:
    return (resource.get("metadata") or {}).get("name", "") or ""


def get_namespace(resource: dict) -> str:
    return (resource.get("metadata") or {}).get("namespace", "") or ""


def get_labels(resource: dict) -> dict:
    return (resource.get("metadata") or {}).get("labels") or {}


def get_annotations(resource: dict) -> dict:
    return (resource.get("metadata") or {}).get("annotations") or {}


def get_uid(resource: dict) -> str:
    return (resource.get("metadata") or {}).get("uid", "") or ""


def gvk(resource: dict) -> tuple[str, str, str]:
    """(group, version, kind) from apiVersion + kind."""
    api_version = get_api_version(resource)
    if "/" in api_version:
        group, version = api_version.split("/", 1)
    else:
        group, version = "", api_version
    return group, version, get_kind(resource)


def title_first(s: str) -> str:
    """Go strings.Title on a single word: uppercase first rune, keep rest."""
    return (s[:1].upper() + s[1:]) if s else s
