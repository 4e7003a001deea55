"""RFC 6902 JSON Patch: apply, diff, and admission-response filtering.

The pip ``jsonpatch`` package is not available in the image, so this is a
from-scratch implementation of the pieces the engine needs:

- :func:`apply_patch_ops` mirrors evanphx/json-patch ApplyWithOptions with
  the reference's options (mutate/patchJson6902.go:76): negative indices,
  missing path on remove allowed, parent paths created on add.
- :func:`create_patch` mirrors mattbaird/jsonpatch CreatePatch (the
  before/after diff used at mutate/patchesUtils.go:12).
- :func:`generate_patches` adds the reference's filter + removal-reorder
  (mutate/patchesUtils.go:37 filterAndSortPatches).
"""

from __future__ import annotations

from ...utils.jsoncopy import json_copy
import re
from fnmatch import fnmatchcase


class JsonPatchError(Exception):
    pass


# ------------------------------------------------------------------ pointers


def _unescape(token: str) -> str:
    return token.replace("~1", "/").replace("~0", "~")


def escape_token(token: str) -> str:
    return token.replace("~", "~0").replace("/", "~1")


def _split_pointer(pointer: str) -> list[str]:
    if pointer == "":
        return []
    if not pointer.startswith("/"):
        raise JsonPatchError(f"invalid JSON pointer: {pointer!r}")
    return [_unescape(t) for t in pointer[1:].split("/")]


def _resolve_parent(doc, tokens: list[str], ensure: bool = False):
    """Walk to the parent container of the last token. With ``ensure``,
    missing intermediate objects are created (EnsurePathExistsOnAdd)."""
    node = doc
    for i, token in enumerate(tokens[:-1]):
        nxt = tokens[i + 1]
        if isinstance(node, dict):
            if token not in node:
                if not ensure:
                    raise JsonPatchError(f"path not found: /{'/'.join(tokens[:i + 1])}")
                node[token] = [] if nxt == "-" or _INT_RE.match(nxt) else {}
            node = node[token]
        elif isinstance(node, list):
            idx = _array_index(token, len(node), for_add=ensure)
            if idx == len(node):
                # EnsurePathExistsOnAdd appends a fresh container so the
                # remaining tokens have somewhere to land
                node.append([] if nxt == "-" or _INT_RE.match(nxt) else {})
            node = node[idx]
        else:
            raise JsonPatchError(f"cannot traverse scalar at /{'/'.join(tokens[:i + 1])}")
    return node


_INT_RE = re.compile(r"^-?\d+$")


def _array_index(token: str, length: int, for_add: bool) -> int:
    if token == "-":
        if not for_add:
            raise JsonPatchError("'-' only valid for add")
        return length
    if not _INT_RE.match(token):
        raise JsonPatchError(f"invalid array index {token!r}")
    idx = int(token)
    if idx < 0:  # SupportNegativeIndices
        idx += length
    limit = length + 1 if for_add else length
    if not 0 <= idx < limit:
        raise JsonPatchError(f"array index {token} out of bounds (len {length})")
    return idx


def get_by_pointer(doc, pointer: str):
    tokens = _split_pointer(pointer)
    node = doc
    for i, token in enumerate(tokens):
        if isinstance(node, dict):
            if token not in node:
                raise JsonPatchError(f"path not found: {pointer}")
            node = node[token]
        elif isinstance(node, list):
            node = node[_array_index(token, len(node), for_add=False)]
        else:
            raise JsonPatchError(f"cannot traverse scalar at {pointer}")
    return node


# ------------------------------------------------------------------ apply


def apply_patch_ops(doc, ops: list[dict]):
    """Apply an RFC6902 op list to a deep copy of ``doc``; returns the new
    document. Options match the reference (patchJson6902.go:76). Malformed
    ops surface as JsonPatchError (a failed rule), never as a crash."""
    result = json_copy(doc)
    for op in ops:
        try:
            result = _apply_one(result, op)
        except JsonPatchError:
            raise
        except (AttributeError, IndexError, KeyError, TypeError) as e:
            raise JsonPatchError(f"malformed patch op {op!r}: {e}") from e
    return result


def _apply_one(doc, op: dict):
    operation = op.get("op") or op.get("operation")
    path = op.get("path")
    if operation is None or path is None:
        raise JsonPatchError(f"invalid patch op: {op}")
    tokens = _split_pointer(path)

    if operation == "test":
        if get_by_pointer(doc, path) != op.get("value"):
            raise JsonPatchError(f"test failed at {path}")
        return doc
    if operation == "add":
        if not tokens:
            return json_copy(op.get("value"))
        parent = _resolve_parent(doc, tokens, ensure=True)
        _add(parent, tokens[-1], json_copy(op.get("value")))
        return doc
    if operation == "replace":
        if not tokens:
            return json_copy(op.get("value"))
        parent = _resolve_parent(doc, tokens)
        _replace(parent, tokens[-1], json_copy(op.get("value")))
        return doc
    if operation == "remove":
        try:
            parent = _resolve_parent(doc, tokens)
            _remove(parent, tokens[-1])
        except JsonPatchError:
            pass  # AllowMissingPathOnRemove
        return doc
    if operation == "move":
        value = get_by_pointer(doc, op["from"])
        from_tokens = _split_pointer(op["from"])
        _remove(_resolve_parent(doc, from_tokens), from_tokens[-1])
        parent = _resolve_parent(doc, tokens, ensure=True)
        _add(parent, tokens[-1], value)
        return doc
    if operation == "copy":
        value = json_copy(get_by_pointer(doc, op["from"]))
        parent = _resolve_parent(doc, tokens, ensure=True)
        _add(parent, tokens[-1], value)
        return doc
    raise JsonPatchError(f"unknown op {operation!r}")


def _add(parent, token: str, value) -> None:
    if isinstance(parent, dict):
        parent[token] = value
    elif isinstance(parent, list):
        parent.insert(_array_index(token, len(parent), for_add=True), value)
    else:
        raise JsonPatchError("add target is a scalar")


def _replace(parent, token: str, value) -> None:
    if isinstance(parent, dict):
        if token not in parent:
            raise JsonPatchError(f"replace path missing key {token!r}")
        parent[token] = value
    elif isinstance(parent, list):
        parent[_array_index(token, len(parent), for_add=False)] = value
    else:
        raise JsonPatchError("replace target is a scalar")


def _remove(parent, token: str) -> None:
    if isinstance(parent, dict):
        if token not in parent:
            raise JsonPatchError(f"remove path missing key {token!r}")
        del parent[token]
    elif isinstance(parent, list):
        del parent[_array_index(token, len(parent), for_add=False)]
    else:
        raise JsonPatchError("remove target is a scalar")


# ------------------------------------------------------------------ diff


def create_patch(src, dst) -> list[dict]:
    """mattbaird/jsonpatch CreatePatch: ops transforming src into dst."""
    ops: list[dict] = []
    _diff(src, dst, "", ops)
    return ops


def _strict_eq(a, b) -> bool:
    """Deep equality that — unlike Python's == — distinguishes bool from
    int/float (JSON true != 1) at any depth."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_strict_eq(v, b[k]) for k, v in a.items())
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_strict_eq(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _diff(src, dst, path: str, ops: list[dict]) -> None:
    if _strict_eq(src, dst):
        return
    if isinstance(src, dict) and isinstance(dst, dict):
        for key in src:
            p = f"{path}/{escape_token(key)}"
            if key not in dst:
                ops.append({"op": "remove", "path": p})
            else:
                _diff(src[key], dst[key], p, ops)
        for key in dst:
            if key not in src:
                ops.append(
                    {"op": "add", "path": f"{path}/{escape_token(key)}", "value": dst[key]}
                )
        return
    if isinstance(src, list) and isinstance(dst, list):
        common = min(len(src), len(dst))
        for i in range(common):
            _diff(src[i], dst[i], f"{path}/{i}", ops)
        for i in range(common, len(dst)):  # additions
            ops.append({"op": "add", "path": f"{path}/{i}", "value": dst[i]})
        for i in range(len(src) - 1, common - 1, -1):  # removals, tail first
            ops.append({"op": "remove", "path": f"{path}/{i}"})
        return
    ops.append({"op": "replace", "path": path or "", "value": dst})


# ------------------------------------------------------------------ filters


def generate_patches(src, dst) -> list[dict]:
    """patchesUtils.go:12 generatePatches: diff then filter + sort."""
    return filter_and_sort_patches(create_patch(src, dst))


def filter_and_sort_patches(patches: list[dict]) -> list[dict]:
    """patchesUtils.go:37: drop ignored paths, then order runs of
    same-array index removals descending so they replay correctly.

    (The reference blindly reverses because its diff library emits
    ascending removals; create_patch above already emits descending, so
    only ascending runs are reversed here.)"""
    patches = [p for p in patches if not _ignore_patch(p["path"])]
    intervals = _get_remove_intervals(patches)
    if not intervals:
        return patches
    result = list(patches)
    for start, end in intervals:
        run = result[start : end + 1]
        indices = [int(p["path"].rsplit("/", 1)[1]) for p in run]
        if indices != sorted(indices, reverse=True):
            result[start : end + 1] = sorted(
                run, key=lambda p: int(p["path"].rsplit("/", 1)[1]), reverse=True
            )
    return result


_INDEX_SUFFIX = re.compile(r"/\d+$")


def _get_remove_intervals(patches: list[dict]) -> list[tuple[int, int]]:
    remove_paths = [
        p["path"] if p["op"] == "remove" and _INDEX_SUFFIX.search(p["path"]) else ""
        for p in patches
    ]
    res = []
    i = 0
    while i < len(remove_paths):
        if remove_paths[i]:
            base = remove_paths[i].rsplit("/", 1)[0]
            j = i + 1
            while j < len(remove_paths) and remove_paths[j] and (
                remove_paths[j].rsplit("/", 1)[0] == base
            ):
                j += 1
            if j - 1 != i:
                res.append((i, j - 1))
            i = j
        else:
            i += 1
    return res


def _ignore_patch(path: str) -> bool:
    """patchesUtils.go:129 ignorePatch: /status and non-allowlisted
    /metadata subtrees are dropped from the admission response."""
    if "/status" in path:
        return True
    if fnmatchcase(path, "*/metadata"):
        return False
    if "/metadata" in path:
        if (
            "/metadata/name" not in path
            and "/metadata/namespace" not in path
            and "/metadata/annotations" not in path
            and "/metadata/labels" not in path
        ):
            return True
    return False
