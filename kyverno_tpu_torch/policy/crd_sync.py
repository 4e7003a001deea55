"""CRD / cluster-document schema sync for the OpenAPI controller.

Mirrors kyverno/pkg/openapi/crdSync.go: a controller that keeps
the schema store (`policy.openapi`) in step with the live cluster —
CustomResourceDefinitions feed per-kind structural schemas (crdSync.go:87
updateSchema parsing spec.versions[].schema.openAPIV3Schema) and the
apiserver's ``/openapi/v2`` swagger document feeds schemas for every
built-in kind (crdSync.go:57 useOpenApiDocument). The reference re-syncs
on a ticker; here CRDs arrive through the watch transport when the client
offers one (runtime/watch.py) with a ticker fallback, so a freshly
installed CRD's kind is schema-checked at policy admission instead of
skipping validation forever.
"""

from __future__ import annotations

import threading

from .openapi import register_schema, unregister_schema

# x-kubernetes extensions that shape conversion
_PRESERVE = "x-kubernetes-preserve-unknown-fields"
_INT_OR_STRING = "x-kubernetes-int-or-string"
_GVK_EXT = "x-kubernetes-group-version-kind"


def convert_openapi_schema(schema: dict, definitions: dict | None = None,
                           _depth: int = 0) -> dict:
    """OpenAPI (v2/v3) schema -> the internal structural DSL of
    policy.openapi. Unknown or unbounded shapes degrade to permissive
    ("any"/open object) — schema sync must only ever tighten validation
    where it has real information, never invent failures."""
    if not isinstance(schema, dict) or _depth > 50:
        return {"type": "any"}
    definitions = definitions or {}

    ref = schema.get("$ref")
    if ref:
        target = definitions.get(ref.rsplit("/", 1)[-1])
        if target is None:
            return {"type": "any"}
        # depth bound doubles as the cycle guard for self-referential
        # definitions (e.g. JSONSchemaProps)
        return convert_openapi_schema(target, definitions, _depth + 1)

    if schema.get(_INT_OR_STRING):
        return {"type": "intstr"}
    if schema.get(_PRESERVE) and "properties" not in schema:
        return {"type": "any"}

    t = schema.get("type")
    if t == "object" or (t is None and ("properties" in schema
                                        or "additionalProperties" in schema)):
        props = schema.get("properties")
        addl = schema.get("additionalProperties")
        if props:
            fields = {
                k: convert_openapi_schema(v, definitions, _depth + 1)
                for k, v in props.items()
            }
            open_ = bool(addl) or bool(schema.get(_PRESERVE))
            return {"type": "object", "fields": fields, "open": open_}
        if isinstance(addl, dict):
            return {"type": "map",
                    "values": convert_openapi_schema(addl, definitions,
                                                     _depth + 1)}
        return {"type": "object", "fields": {}, "open": True}
    if t == "array":
        return {"type": "array",
                "items": convert_openapi_schema(schema.get("items") or {},
                                                definitions, _depth + 1)}
    if t == "string":
        # quantities arrive as strings with a format marker in the
        # cluster document
        if schema.get("format") == "quantity":
            return {"type": "quantity"}
        return {"type": "string"}
    if t == "integer":
        return {"type": "integer"}
    if t == "number":
        return {"type": "number"}
    if t == "boolean":
        return {"type": "boolean"}
    return {"type": "any"}


def schemas_from_crd(crd: dict) -> dict[str, dict]:
    """kind -> converted schema for every served version carrying a
    structural schema (crdSync.go:87 pattern: last served version wins)."""
    spec = crd.get("spec") or {}
    kind = ((spec.get("names") or {}).get("kind")) or ""
    if not kind:
        return {}
    out: dict[str, dict] = {}
    for version in spec.get("versions") or []:
        if not version.get("served", True):
            continue
        v3 = ((version.get("schema") or {}).get("openAPIV3Schema"))
        if v3:
            out[kind] = convert_openapi_schema(v3)
    # legacy single-schema layout (apiextensions v1beta1)
    if not out:
        v3 = ((spec.get("validation") or {}).get("openAPIV3Schema"))
        if v3:
            out[kind] = convert_openapi_schema(v3)
    return out


def schemas_from_openapi_v2(document: dict) -> dict[str, dict]:
    """kind -> schema from a cluster ``/openapi/v2`` swagger document
    (crdSync.go:57 useOpenApiDocument: definitions carrying a
    group-version-kind extension)."""
    defs = (document or {}).get("definitions") or {}
    out: dict[str, dict] = {}
    for body in defs.values():
        for gvk in body.get(_GVK_EXT) or []:
            kind = gvk.get("kind")
            if kind:
                out[kind] = convert_openapi_schema(body, defs)
    return out


class CrdSync:
    """The crdSync controller: event-driven via the watch transport when
    available, ticker-driven otherwise; either way `sync_once()` is a
    full reconcile usable standalone (CLI, tests)."""

    CRD_API = "apiextensions.k8s.io/v1"
    CRD_KIND = "CustomResourceDefinition"

    def __init__(self, client, resync_interval_s: float = 300.0):
        self.client = client
        self.resync_interval_s = resync_interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._registered: set[str] = set()
        self._lock = threading.Lock()
        self.syncs = 0

    # ----------------------------------------------------------- reconcile

    def sync_once(self) -> int:
        """Full reconcile: cluster openapi-v2 document (when the client
        serves one) + every CRD, pruning kinds this controller registered
        that no longer exist. Returns the number of kinds registered."""
        fresh: dict[str, dict] = {}
        doc = self._fetch_openapi_document()
        if doc:
            fresh.update(schemas_from_openapi_v2(doc))
        for crd in self._list_crds():
            fresh.update(schemas_from_crd(crd))
        self._replace_all(fresh)
        self.syncs += 1
        return len(fresh)

    def _replace_all(self, fresh: dict[str, dict]) -> None:
        with self._lock:
            stale = self._registered - set(fresh)
            self._registered = set(fresh)
        for kind in stale:
            unregister_schema(kind)
        for kind, schema in fresh.items():
            register_schema(kind, schema)

    def _register(self, kind: str, schema: dict) -> None:
        register_schema(kind, schema)
        with self._lock:
            self._registered.add(kind)

    def _unregister(self, kind: str) -> None:
        with self._lock:
            self._registered.discard(kind)
        unregister_schema(kind)

    def _on_crd_event(self, ev_type: str, crd: dict) -> None:
        if self._stop.is_set():
            return
        kinds = schemas_from_crd(crd)
        declared = (((crd.get("spec") or {}).get("names") or {})
                    .get("kind")) or ""
        if ev_type == "DELETED":
            for kind in set(kinds) | ({declared} if declared else set()):
                self._unregister(kind)
            return
        # a MODIFIED CRD that stopped serving a schema (served: false,
        # schema removed) must drop its kind, not keep the old schema
        if declared and declared not in kinds:
            self._unregister(declared)
        for kind, schema in kinds.items():
            self._register(kind, schema)

    def _on_crd_sync(self, items: list[dict]) -> None:
        """Full (re-)list from the reflector: reconcile, pruning kinds
        whose CRD vanished during a watch outage. The openapi-document
        kinds re-merge so a CRD re-list cannot orphan them."""
        if self._stop.is_set():
            return
        fresh: dict[str, dict] = {}
        doc = self._fetch_openapi_document()
        if doc:
            fresh.update(schemas_from_openapi_v2(doc))
        for crd in items:
            fresh.update(schemas_from_crd(crd))
        self._replace_all(fresh)

    # ------------------------------------------------------------- plumbing

    def _list_crds(self) -> list[dict]:
        try:
            return self.client.list_resource(self.CRD_API, self.CRD_KIND)
        except Exception:
            return []

    def _fetch_openapi_document(self) -> dict | None:
        getter = getattr(self.client, "get_openapi_v2", None)
        if getter is None:
            return None
        try:
            return getter()
        except Exception:
            return None

    def run(self) -> None:
        """Start the sync: one reconcile now, then CRD watch events (or a
        ticker when the client has no watch transport). ``stop()`` makes
        the callbacks inert — watch seams have no detach, so a stopped
        controller must stop mutating the process-global schema store."""
        self.sync_once()
        if hasattr(self.client, "ensure_informer"):
            self.client.ensure_informer(
                self.CRD_API, self.CRD_KIND,
                on_event=self._on_crd_event, on_sync=self._on_crd_sync)
            return
        if hasattr(self.client, "watch"):
            def cb(ev_type, resource):
                if resource.get("kind") == self.CRD_KIND:
                    self._on_crd_event(ev_type, resource)
            self.client.watch(cb)
            return

        def loop():
            while not self._stop.wait(self.resync_interval_s):
                try:
                    self.sync_once()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, name="crd-sync",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
