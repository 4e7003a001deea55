"""Generic JSON traversal applying an action at leaves and map keys,
tracking the element path (mirrors kyverno/pkg/engine/jsonutils).

As in the reference (traverse.go:62-78), the action's RESULT is traversed
further: a leaf that substitutes into a container has its own leaves
processed too. A map key that substitutes to a non-string is an error
(traverse.go:100)."""

from __future__ import annotations

from typing import Callable

# action(element, path, document) -> new element; raise to abort
Action = Callable[[object, str, object], object]


class NonStringKeyError(ValueError):
    def __init__(self, path: str):
        super().__init__(
            f"expected string after substituting variables in key at path {path}"
        )


def traverse_leaves_and_keys(document, action: Action):
    """Rebuilds the document, applying ``action`` to every scalar leaf and
    every map key (a changed key renames the entry)."""

    def walk(element, path):
        if not isinstance(element, (dict, list)):
            element = action(element, path, document)
        if isinstance(element, dict):
            out = {}
            for k, v in element.items():
                new_key = action(k, path, document)
                if not isinstance(new_key, str):
                    raise NonStringKeyError(path)
                out[new_key] = walk(v, f"{path}/{k}")
            return out
        if isinstance(element, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(element)]
        return element

    return walk(document, "")
