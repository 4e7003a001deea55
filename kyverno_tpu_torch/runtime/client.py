"""Cluster access: the dclient equivalent.

Mirrors kyverno/pkg/dclient/client.go's surface (Get/List/Create/
Update/Delete of unstructured resources + ConfigMap lookups) behind one
interface with two implementations:

- :class:`FakeCluster` — in-memory store for tests, the CLI, and snapshot
  replays (the resourcecache analogue for offline runs)
- :class:`RestClient` — a minimal stdlib-urllib client against a real API
  server (bearer-token kubeconfig), for in-cluster deployment
"""

from __future__ import annotations

import copy
import json
import threading
import urllib.error
import urllib.request
from dataclasses import dataclass


class ConflictError(Exception):
    """Optimistic-concurrency failure: stale resourceVersion on update
    (HTTP 409) or create of an existing object (AlreadyExists)."""


class Client:
    """The engine-facing surface (PolicyContext.client)."""

    def get_resource(self, api_version: str, kind: str, namespace: str, name: str) -> dict | None:
        raise NotImplementedError

    def list_resource(self, api_version: str, kind: str, namespace: str = "") -> list[dict]:
        raise NotImplementedError

    def create_resource(self, resource: dict) -> dict:
        raise NotImplementedError

    def update_resource(self, resource: dict) -> dict:
        raise NotImplementedError

    def delete_resource(self, api_version: str, kind: str, namespace: str, name: str) -> None:
        raise NotImplementedError

    def get_configmap(self, namespace: str, name: str) -> dict | None:
        return self.get_resource("v1", "ConfigMap", namespace, name)


def _meta(resource: dict) -> dict:
    return resource.setdefault("metadata", {})


class FakeCluster(Client):
    """In-memory cluster: (kind, namespace, name) -> resource. Watch
    callbacks fire on every write (the informer analogue)."""

    def __init__(self, resources: list[dict] | None = None):
        self._lock = threading.RLock()
        self._store: dict[tuple[str, str, str], dict] = {}
        # the store's keys by kind: a list reads its kind's objects only
        # (a controller's cluster holds every report, change request and
        # event beside the resources, and a request lists its bindings)
        self._kinds: dict[str, set[tuple[str, str, str]]] = {}
        self._watchers: list = []
        self._rv = 0
        #: optional /openapi/v2 swagger document served to CrdSync
        self.openapi_document: dict | None = None
        # RBAC for SelfSubjectAccessReview: (verb, resource) pairs the
        # controller is NOT allowed; default allow-all
        self.deny_access: set[tuple[str, str]] = set()
        for r in resources or []:
            self.create_resource(r)

    def _key(self, resource: dict) -> tuple[str, str, str]:
        meta = resource.get("metadata") or {}
        return (resource.get("kind", ""), meta.get("namespace", ""), meta.get("name", ""))

    def get_resource(self, api_version, kind, namespace, name):
        kind = _normalize_kind(kind)
        with self._lock:
            r = self._store.get((kind, namespace or "", name))
            return copy.deepcopy(r) if r is not None else None

    def list_resource(self, api_version, kind, namespace=""):
        kind = _normalize_kind(kind)
        with self._lock:
            return [
                copy.deepcopy(self._store[key])
                for key in sorted(self._kinds.get(kind, ()))
                if not namespace or key[1] == namespace
            ]

    def create_resource(self, resource):
        if resource.get("kind") == "SelfSubjectAccessReview":
            # the API server answers these inline, nothing is stored
            attrs = ((resource.get("spec") or {})
                     .get("resourceAttributes") or {})
            allowed = (attrs.get("verb", ""),
                       attrs.get("resource", "")) not in self.deny_access
            out = copy.deepcopy(resource)
            out["status"] = {"allowed": allowed}
            return out
        with self._lock:
            key = self._key(resource)
            if key in self._store:
                raise ConflictError(f"AlreadyExists: {key}")
            resource = copy.deepcopy(resource)
            self._rv += 1
            _meta(resource)["resourceVersion"] = str(self._rv)
            self._store[key] = resource
            self._kinds.setdefault(key[0], set()).add(key)
            self._notify("ADDED", resource)
            return copy.deepcopy(resource)

    def update_resource(self, resource):
        """Resource-version-guarded update, like the real API server: a PUT
        carrying a stale metadata.resourceVersion returns 409 Conflict."""
        with self._lock:
            key = self._key(resource)
            stored = self._store.get(key)
            sent_rv = (resource.get("metadata") or {}).get("resourceVersion")
            if stored is not None and sent_rv is not None:
                if stored["metadata"].get("resourceVersion") != sent_rv:
                    raise ConflictError(f"Conflict: {key} rv={sent_rv}")
            resource = copy.deepcopy(resource)
            self._rv += 1
            _meta(resource)["resourceVersion"] = str(self._rv)
            self._store[key] = resource
            self._kinds.setdefault(key[0], set()).add(key)
            self._notify("MODIFIED", resource)
            return copy.deepcopy(resource)

    def delete_resource(self, api_version, kind, namespace, name):
        kind = _normalize_kind(kind)
        with self._lock:
            key = (kind, namespace or "", name)
            r = self._store.pop(key, None)
            if r is not None:
                self._kinds[kind].discard(key)
                self._notify("DELETED", r)

    def get_openapi_v2(self) -> dict | None:
        return self.openapi_document

    # informer-style change notification
    def watch(self, callback) -> None:
        with self._lock:
            self._watchers.append(callback)

    def _notify(self, event: str, resource: dict) -> None:
        for cb in list(self._watchers):
            try:
                cb(event, copy.deepcopy(resource))
            except Exception:
                pass


def _normalize_kind(kind: str) -> str:
    # accept plural lowercase resource names from APICall urlPaths
    if kind and kind[0].islower():
        singular = kind[:-1] if kind.endswith("s") else kind
        return singular[:1].upper() + singular[1:]
    return kind


# plural resource name -> Kind exceptions for the REST paths
_PLURAL_EXCEPTIONS = {
    "endpoints": "Endpoints",
    "networkpolicies": "NetworkPolicy",
    "ingresses": "Ingress",
}


@dataclass
class RestConfig:
    server: str = "https://kubernetes.default.svc"
    token: str = ""
    ca_file: str = ""
    insecure: bool = False

    @classmethod
    def in_cluster(cls) -> "RestConfig":
        token = ""
        try:
            with open("/var/run/secrets/kubernetes.io/serviceaccount/token") as f:
                token = f.read().strip()
        except OSError:
            pass
        return cls(
            token=token,
            ca_file="/var/run/secrets/kubernetes.io/serviceaccount/ca.crt",
        )


class RestClient(Client):
    """Dynamic client over the K8s REST API (urllib; no kubectl): CRUD
    with bounded retry, plus the streaming-watch transport that drives
    informers (runtime/watch.py) — the dclient + client-go reflector pair
    (kyverno/pkg/dclient/client.go, pkg/resourcecache)."""

    #: transient statuses worth one bounded retry round (client-go's
    #: default retry set: throttled, server overloaded, gateway errors)
    RETRYABLE = (429, 500, 502, 503, 504)

    def __init__(self, config: RestConfig, resource_map: dict[str, str] | None = None,
                 retries: int = 2, retry_backoff_s: float = 0.25):
        self.config = config
        # Kind -> plural resource name
        self.resource_map = resource_map or {}
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self._hub = None
        self._hub_lock = threading.Lock()

    def _plural(self, kind: str) -> str:
        if kind in self.resource_map:
            return self.resource_map[kind]
        lower = kind.lower()
        if lower.endswith("y"):
            return lower[:-1] + "ies"
        if lower.endswith("s"):
            return lower + "es"
        return lower + "s"

    def _url(self, api_version: str, kind: str, namespace: str, name: str = "") -> str:
        if "/" in api_version:
            base = f"{self.config.server}/apis/{api_version}"
        else:
            base = f"{self.config.server}/api/{api_version or 'v1'}"
        parts = [base]
        if namespace:
            parts.append(f"namespaces/{namespace}")
        parts.append(self._plural(kind))
        if name:
            parts.append(name)
        return "/".join(parts)

    def _ssl_context(self):
        import ssl

        if not self.config.server.startswith("https"):
            return None
        ctx = ssl.create_default_context(cafile=self.config.ca_file or None)
        if self.config.insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    def _open(self, method: str, url: str, body: dict | None = None,
              timeout: float = 15):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        return urllib.request.urlopen(
            req, context=self._ssl_context(), timeout=timeout)

    def _request(self, method: str, url: str, body: dict | None = None):
        import time

        idempotent = method in ("GET", "DELETE")
        last = None
        for attempt in range(self.retries + 1):
            try:
                with self._open(method, url, body) as resp:
                    return json.loads(resp.read() or b"null")
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    raise ConflictError(str(e)) from e
                # mutating verbs retry only on 429 (rejected before
                # processing); a 502/504 gives no guarantee the write
                # didn't land, and a re-POST would double-apply
                retryable = (e.code in self.RETRYABLE if idempotent
                             else e.code == 429)
                if not retryable or attempt == self.retries:
                    raise
                last = e
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                # connection-level failure: same asymmetry (a POST might
                # have landed before the connection died)
                if not idempotent or attempt == self.retries:
                    raise
                last = e
            time.sleep(self.retry_backoff_s * (2 ** attempt))
        raise last  # pragma: no cover - loop always returns or raises

    def get_resource(self, api_version, kind, namespace, name):
        try:
            return self._request("GET", self._url(api_version, kind, namespace, name))
        except Exception:
            return None

    def list_resource(self, api_version, kind, namespace=""):
        try:
            doc = self._request("GET", self._url(api_version, kind, namespace))
            return list((doc or {}).get("items") or [])
        except Exception:
            return []

    def create_resource(self, resource):
        meta = resource.get("metadata") or {}
        return self._request(
            "POST",
            self._url(resource.get("apiVersion", "v1"), resource.get("kind", ""),
                      meta.get("namespace", "")),
            resource,
        )

    def update_resource(self, resource):
        meta = resource.get("metadata") or {}
        return self._request(
            "PUT",
            self._url(resource.get("apiVersion", "v1"), resource.get("kind", ""),
                      meta.get("namespace", ""), meta.get("name", "")),
            resource,
        )

    def delete_resource(self, api_version, kind, namespace, name):
        try:
            self._request("DELETE", self._url(api_version, kind, namespace, name))
        except Exception:
            pass

    def get_openapi_v2(self) -> dict | None:
        """The cluster's /openapi/v2 swagger document (crdSync.go:57)."""
        try:
            return self._request("GET", f"{self.config.server}/openapi/v2")
        except Exception:
            return None

    # ------------------------------------------------------- watch / informers

    def list_response(self, api_version: str, kind: str,
                      namespace: str = "") -> dict:
        """Full list document (items + metadata.resourceVersion) — the
        reflector needs the list's rv to anchor its watch."""
        return self._request(
            "GET", self._url(api_version, kind, namespace)) or {}

    def watch_stream(self, api_version: str, kind: str, namespace: str = "",
                     resource_version: str | None = None,
                     timeout_s: float = 300.0, stop=None):
        """Yield (type, object) from a chunked ``?watch=true`` stream —
        the k8s watch protocol: one JSON frame per line, resumable via
        resourceVersion, with server bookmarks requested so the resume
        point advances even on quiet kinds. Returns (ends the generator)
        when the server closes the connection or ``stop`` is set; raises
        on connection errors so the reflector can back off."""
        from .watch import decode_watch_line

        url = (self._url(api_version, kind, namespace)
               + "?watch=true&allowWatchBookmarks=true"
               + f"&timeoutSeconds={int(timeout_s)}")
        if resource_version:
            url += f"&resourceVersion={resource_version}"
        resp = self._open("GET", url, timeout=timeout_s + 15)
        try:
            for line in resp:
                if stop is not None and stop.is_set():
                    return
                frame = decode_watch_line(line)
                if frame is None:
                    continue
                ev_type, obj = frame
                if ev_type == "ERROR":
                    # surface the Status code (410 Gone -> re-list)
                    yield "ERROR", {"code": (obj or {}).get("code")}
                    return
                yield ev_type, obj
        finally:
            resp.close()

    def ensure_informer(self, api_version: str, kind: str,
                        namespace: str = "", on_event=None, on_sync=None):
        """Idempotent per-GVK informer (list+watch reflector); callbacks
        observe the full object stream. The ResourceCache calls this the
        first time a kind is cached (resourcecache.go CreateGVKInformer)."""
        from .watch import WatchHub

        with self._hub_lock:
            if self._hub is None:
                self._hub = WatchHub(self)
        return self._hub.ensure(api_version, kind, namespace,
                                on_event=on_event, on_sync=on_sync)

    def stop_informers(self) -> None:
        with self._hub_lock:
            if self._hub is not None:
                self._hub.stop()
                self._hub = None
