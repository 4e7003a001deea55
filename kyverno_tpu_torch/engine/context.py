"""JSON context: the single mutable variable store for rule evaluation.

Mirrors kyverno/pkg/engine/context/context.go: one JSON document
holding ``request.*``, ``images.*`` and named context entries, merged via
RFC7386 merge-patch (null deletes), with a checkpoint/restore stack for
per-rule rollback, queried through the JMESPath dialect.
"""

from __future__ import annotations

from ..utils.jsoncopy import json_copy
import json
from dataclasses import asdict

from .jmespath import JMESPathError, search
from . import resource as res


class InvalidVariableError(Exception):
    """Raised for structurally invalid queries (empty, bad syntax)."""


def merge_patch(target, patch):
    """RFC7386 JSON merge-patch: dict keys merge recursively, null deletes,
    everything else replaces."""
    if not isinstance(patch, dict):
        return json_copy(patch)
    if not isinstance(target, dict):
        target = {}
    else:
        target = dict(target)
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        else:
            target[k] = merge_patch(target.get(k), v)
    return target


SA_PREFIX = "system:serviceaccount:"


class Context:
    """context.go:54. The device path snapshots this into immutable per-lane
    dictionaries at compile time; this mutable form drives the CPU oracle."""

    def __init__(self):
        self._data: dict = {}
        self._checkpoints: list[dict] = []
        self.images: dict | None = None

    # ------------------------------------------------------------- merging

    def add_json(self, data: dict) -> None:
        self._data = merge_patch(self._data, data)

    def add_request(self, request: dict) -> None:
        """Admission request document at ``request.*`` (context.go:99)."""
        self.add_json({"request": request})

    def add_resource(self, resource: dict) -> None:
        """Resource at ``request.object`` (context.go:116)."""
        self.add_json({"request": {"object": json_copy(resource)}})

    def add_old_resource(self, resource: dict) -> None:
        self.add_json({"request": {"oldObject": json_copy(resource)}})

    def add_user_info(self, request_info) -> None:
        """RequestInfo at ``request.{roles,clusterRoles,userInfo}``."""
        if hasattr(request_info, "__dataclass_fields__"):
            info = asdict(request_info)
            payload = {
                "roles": info.get("roles") or [],
                "clusterRoles": info.get("cluster_roles") or [],
                "userInfo": {
                    "username": info["admission_user_info"].get("username", ""),
                    "uid": info["admission_user_info"].get("uid", ""),
                    "groups": info["admission_user_info"].get("groups") or [],
                },
            }
        else:
            payload = dict(request_info)
        self.add_json({"request": payload})

    def add_service_account(self, username: str) -> None:
        """serviceAccountName/-Namespace from the SA username
        (context.go:204)."""
        sa = username[len(SA_PREFIX):] if len(username) > len(SA_PREFIX) else ""
        name, namespace = "", ""
        groups = sa.split(":")
        if len(groups) >= 2:
            namespace, name = groups[0], groups[1]
        self.add_json({"serviceAccountName": name})
        self.add_json({"serviceAccountNamespace": namespace})

    def add_namespace(self, namespace: str) -> None:
        self.add_json({"request": {"namespace": namespace}})

    def add_element(self, element, index: int) -> None:
        """foreach iteration variable: element / elementIndex."""
        self.add_json({"element": json_copy(element), "elementIndex": index})

    def add_image_info(self, resource: dict) -> None:
        images = extract_image_info(resource)
        if images is None:
            return
        self.images = images
        self.add_json({"images": images})

    # ------------------------------------------------------------ queries

    def query(self, query: str):
        """context/evaluate.go:15. Missing map keys and malformed queries
        raise InvalidVariableError (fork semantics, see interpreter._field)."""
        query = (query or "").strip()
        if not query:
            raise InvalidVariableError("invalid query (empty)")
        try:
            return search(query, self._data)
        except JMESPathError as e:
            raise InvalidVariableError(f"incorrect query {query!r}: {e}") from e

    def has_changed(self, jmespath_expr: str) -> bool:
        """context/evaluate.go:52. Missing keys raise from query(); a path
        resolving to null (e.g. through a null parent) raises here, as the
        reference treats nil results as 'not found'."""
        obj = self.query(f"request.object.{jmespath_expr}")
        if obj is None:
            raise InvalidVariableError(f"request.object.{jmespath_expr} not found")
        old = self.query(f"request.oldObject.{jmespath_expr}")
        if old is None:
            raise InvalidVariableError(f"request.oldObject.{jmespath_expr} not found")
        return obj != old

    def snapshot(self) -> dict:
        return json_copy(self._data)

    # -------------------------------------------------------- checkpoints

    def checkpoint(self) -> None:
        self._checkpoints.append(json_copy(self._data))

    def restore(self) -> None:
        """Pop to the last checkpoint (context.go:322)."""
        if self._checkpoints:
            self._data = self._checkpoints.pop()

    def reset(self) -> None:
        """Return to the last checkpoint, keeping it (context.go:327)."""
        if self._checkpoints:
            self._data = json_copy(self._checkpoints[-1])


# ----------------------------------------------------------- image parsing


def parse_image(image: str, json_pointer: str = "") -> dict | None:
    """Parse a container image reference into its components
    (imageutils.go:152 newImageInfo + addDefaultDomain)."""
    slash = image.find("/")
    head = image[:slash] if slash != -1 else ""
    if slash == -1 or (
        "." not in head and ":" not in head and head != "localhost" and head.lower() == head
    ):
        image = "docker.io/" + image

    rest = image
    digest = ""
    if "@" in rest:
        rest, digest = rest.split("@", 1)
        if not digest.startswith("sha256:"):
            return None
    registry, _, path = rest.partition("/")
    tag = ""
    last = path.rsplit("/", 1)[-1]
    if ":" in last:
        path, _, tag = path.rpartition(":")
    if not path or not registry:
        return None
    name = path.rsplit("/", 1)[-1]
    if not tag:
        tag = "latest"
    info = {
        "registry": registry,
        "name": name,
        "path": path,
        "tag": tag,
        "jsonPath": json_pointer,
    }
    if digest:
        info["digest"] = digest
    return info


def image_string(info: dict) -> str:
    s = f"{info['registry']}/{info['path']}:{info['tag']}"
    if info.get("digest"):
        s += "@" + info["digest"]
    return s


_POD_SPEC_PATHS = {
    "Pod": ["spec"],
    "CronJob": ["spec", "jobTemplate", "spec", "template", "spec"],
}


def extract_image_info(resource: dict) -> dict | None:
    """images.{initContainers,containers}.{name} -> ImageInfo
    (imageutils.go:72 extractImageInfo)."""
    kind = res.get_kind(resource)
    spec_path = _POD_SPEC_PATHS.get(kind, ["spec", "template", "spec"])
    node = resource
    for seg in spec_path:
        node = node.get(seg) if isinstance(node, dict) else None
        if node is None:
            return None
    pointer_base = "/" + "/".join(spec_path)

    out: dict = {}
    for tag in ("initContainers", "containers"):
        containers = node.get(tag)
        if not isinstance(containers, list):
            continue
        bucket = {}
        for i, ctr in enumerate(containers):
            if not isinstance(ctr, dict):
                continue
            name, image = ctr.get("name"), ctr.get("image")
            if not isinstance(name, str) or not isinstance(image, str):
                continue
            info = parse_image(image, f"{pointer_base}/{tag}/{i}/image")
            if info is not None:
                bucket[name] = info
        if bucket:
            out[tag] = bucket
    if not out:
        return None
    out.setdefault("containers", {})
    return out


def mutate_resource_with_image_info(resource: dict, ctx: Context) -> tuple[dict, list]:
    """Canonicalize image fields (docker.io/ prefix, :latest default) via
    JSON patches (imageutils.go:203). Returns (patched resource, patches)."""
    if ctx.images is None:
        return resource, []
    patches = []
    patched = json_copy(resource)
    for bucket in ("containers", "initContainers"):
        for info in (ctx.images.get(bucket) or {}).values():
            pointer = info.get("jsonPath", "")
            value = image_string(info)
            patches.append({"op": "replace", "path": pointer, "value": value})
            _apply_pointer_replace(patched, pointer, value)
    return patched, patches


def _apply_pointer_replace(doc, pointer: str, value) -> None:
    parts = [p for p in pointer.split("/") if p != ""]
    node = doc
    for p in parts[:-1]:
        if isinstance(node, list):
            node = node[int(p)]
        else:
            node = node.get(p)
        if node is None:
            return
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    elif isinstance(node, dict):
        node[last] = value


def context_to_json(ctx: Context) -> str:
    return json.dumps(ctx.snapshot(), separators=(",", ":"))
