"""Kubernetes API URL-path parser for APICall context entries.

Mirrors kyverno/pkg/engine/apiPath.go (NewAPIPath). Paths follow
https://kubernetes.io/docs/reference/using-api/api-concepts/:

  /api/v1/RESOURCE[/NAME]                     core group, cluster scope
  /api/v1/namespaces/NS/RESOURCE[/NAME]       core group, namespaced
  /apis/GROUP/VERSION/RESOURCE[/NAME]
  /apis/GROUP/VERSION/namespaces/NS/RESOURCE[/NAME]
"""

from __future__ import annotations

from dataclasses import dataclass


class APIPathError(ValueError):
    pass


@dataclass
class APIPath:
    root: str = ""
    group: str = ""
    version: str = ""
    resource_type: str = ""
    name: str = ""
    namespace: str = ""

    @property
    def api_version(self) -> str:
        """group/version string as used by dynamic clients ("v1" for core)."""
        if self.root == "api":
            return self.group  # core group: the segment after /api is the version
        return f"{self.group}/{self.version}"

    def __str__(self) -> str:
        parts = [self.root]
        if self.root == "api":
            parts.append(self.group)
        else:
            parts.extend([self.group, self.version])
        if self.namespace:
            parts.extend(["namespaces", self.namespace])
        parts.append(self.resource_type)
        if self.name:
            parts.append(self.name)
        return "/" + "/".join(parts)


def parse_api_path(path: str) -> APIPath:
    """apiPath.go:19 NewAPIPath."""
    trimmed = path.strip().strip("/")
    paths = trimmed.split("/")

    if len(paths) < 3 or len(paths) > 7:
        raise APIPathError(f"invalid path length {path}")
    if paths[0] not in ("api", "apis"):
        raise APIPathError("urlPath must start with /api or /apis")
    if paths[0] == "api" and paths[1] != "v1":
        raise APIPathError("expected urlPath to start with /api/v1/")

    if paths[0] == "api":
        if len(paths) == 3:
            return APIPath(root=paths[0], group=paths[1], resource_type=paths[2])
        if len(paths) == 4:
            return APIPath(
                root=paths[0], group=paths[1], resource_type=paths[2], name=paths[3]
            )
        if len(paths) == 5:
            return APIPath(
                root=paths[0], group=paths[1], namespace=paths[3], resource_type=paths[4]
            )
        if len(paths) == 6:
            return APIPath(
                root=paths[0],
                group=paths[1],
                namespace=paths[3],
                resource_type=paths[4],
                name=paths[5],
            )
        raise APIPathError(f"invalid API v1 path {path}")

    if len(paths) == 4:
        return APIPath(
            root=paths[0], group=paths[1], version=paths[2], resource_type=paths[3]
        )
    if len(paths) == 5:
        return APIPath(
            root=paths[0],
            group=paths[1],
            version=paths[2],
            resource_type=paths[3],
            name=paths[4],
        )
    if len(paths) == 6:
        return APIPath(
            root=paths[0],
            group=paths[1],
            version=paths[2],
            namespace=paths[4],
            resource_type=paths[5],
        )
    if len(paths) == 7:
        return APIPath(
            root=paths[0],
            group=paths[1],
            version=paths[2],
            namespace=paths[4],
            resource_type=paths[5],
            name=paths[6],
        )
    raise APIPathError(f"invalid API path {path}")
