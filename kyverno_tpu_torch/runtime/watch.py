"""Streaming watch: the client-go reflector/informer analogue.

Mirrors kyverno/pkg/resourcecache/resourcecache.go:42
(CreateGVKInformer) and the client-go Reflector it delegates to: per-GVK
``list`` to prime state, then a chunked ``?watch=true`` stream resumed
from the last seen resourceVersion, with bookmark handling, exponential
backoff on transport errors, and a full re-list on 410 Gone (the
apiserver's "your resourceVersion is too old"). Consumers register
callbacks; steady state does zero polling GETs.
"""

from __future__ import annotations

import json
import random
import threading


class Reflector:
    """List+watch loop for one (apiVersion, kind, namespace) — the
    client-go reflector. ``on_sync(items)`` fires after every full list
    (initial sync and 410-triggered re-lists); ``on_event(type, obj)``
    fires per watch event (ADDED/MODIFIED/DELETED)."""

    def __init__(self, client, api_version: str, kind: str,
                 namespace: str = "", on_event=None, on_sync=None,
                 backoff_base_s: float = 0.2, backoff_cap_s: float = 30.0,
                 max_watch_failures: int = 5):
        self.client = client
        self.api_version = api_version
        self.kind = kind
        self.namespace = namespace
        self.on_event = on_event or (lambda t, o: None)
        self.on_sync = on_sync or (lambda items: None)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.max_watch_failures = max_watch_failures
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_resource_version: str | None = None
        self.syncs = 0
        self.reconnects = 0
        self._synced = threading.Event()

    # ------------------------------------------------------------ control

    def start(self) -> "Reflector":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"reflector-{self.kind}/{self.namespace or '*'}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def wait_synced(self, timeout_s: float = 10.0) -> bool:
        return self._synced.wait(timeout_s)

    # ------------------------------------------------------------- loop

    def _run(self) -> None:
        failures = 0
        while not self._stop.is_set():
            try:
                self._list_then_watch()
                failures = 0            # clean stop
            except _Relist:
                failures = 0            # 410: re-list promptly
            except Exception:
                failures += 1           # LIST failed (or watch gave up)
            if self._stop.is_set():
                return
            delay = min(self.backoff_cap_s,
                        self.backoff_base_s * (2 ** min(failures, 8)))
            self._stop.wait(delay * (0.5 + random.random() / 2))

    def _list_then_watch(self) -> None:
        doc = self.client.list_response(
            self.api_version, self.kind, self.namespace)
        items = list((doc or {}).get("items") or [])
        # list items omit kind/apiVersion; restore them (client-go does
        # the same via the list's GVK minus the "List" suffix)
        for it in items:
            it.setdefault("kind", self.kind)
            it.setdefault("apiVersion", self.api_version)
        rv = ((doc or {}).get("metadata") or {}).get("resourceVersion")
        self.last_resource_version = rv
        self.syncs += 1
        self.on_sync(items)
        self._synced.set()

        # watch loop: transport errors resume from the last seen rv (the
        # client-go behavior — a network blip must not re-list the world);
        # only 410 Gone or persistent watch failure escalates to a re-list
        watch_failures = 0
        while not self._stop.is_set():
            try:
                gone = self._watch_once()
                watch_failures = 0
            except Exception:
                watch_failures += 1
                self.reconnects += 1
                if watch_failures > self.max_watch_failures:
                    raise _Relist() from None
                self._stop.wait(
                    min(5.0, self.backoff_base_s * (2 ** watch_failures))
                    * (0.5 + random.random() / 2))
                continue
            if self._stop.is_set():
                return
            self.reconnects += 1
            if gone:
                raise _Relist()
            # clean server close: reconnect from the last rv

    def _watch_once(self) -> bool:
        """One watch connection; returns True on 410 Gone."""
        for ev_type, obj in self.client.watch_stream(
                self.api_version, self.kind, self.namespace,
                resource_version=self.last_resource_version,
                stop=self._stop):
            if ev_type == "ERROR":
                if (obj or {}).get("code") == 410:
                    return True
                # a non-410 Status (e.g. a 500) is a server-side failure,
                # not a clean close: surface it as a watch failure so the
                # outer loop backs off and eventually escalates to a
                # re-list, instead of hot-looping zero-delay reconnects
                raise _WatchError(
                    f"watch ERROR frame: {json.dumps(obj)[:200]}")
            rv = ((obj or {}).get("metadata") or {}).get("resourceVersion")
            if rv:
                self.last_resource_version = rv
            if ev_type == "BOOKMARK":
                continue          # rv checkpoint only, no state change
            obj.setdefault("kind", self.kind)
            obj.setdefault("apiVersion", self.api_version)
            self.on_event(ev_type, obj)
        return False


class _Relist(Exception):
    """410 Gone: restart from a fresh list."""


class _WatchError(Exception):
    """Server-sent non-410 ERROR frame: retry the watch with backoff."""


class WatchHub:
    """Per-GVK reflector registry — the ResourceCache's informer factory
    (resourcecache.go CreateGVKInformer). ensure() is idempotent; all
    callbacks for a GVK share one reflector/stream."""

    def __init__(self, client):
        self.client = client
        self._lock = threading.Lock()
        self._reflectors: dict[tuple, Reflector] = {}
        self._callbacks: dict[tuple, list] = {}
        # watch-maintained object map per key ((ns, name) -> obj), kept
        # current by _fan_event — a late subscriber's replay must reflect
        # every event since the last list, not the stale list itself
        self._state: dict[tuple, dict] = {}
        # serializes state mutation + callback delivery with the replay in
        # ensure(): without it a replay captured at state vN could be
        # delivered AFTER event N+1 reached the same subscriber, and a
        # wholesale-replacing on_sync would clobber the newer event.
        # RLock so an (ill-advised) ensure() from inside a callback
        # degrades to a stale-replay, not a deadlock.
        self._deliver_lock = threading.RLock()

    @staticmethod
    def _obj_key(obj: dict) -> tuple:
        meta = obj.get("metadata") or {}
        return (meta.get("namespace", ""), meta.get("name", ""))

    def ensure(self, api_version: str, kind: str, namespace: str = "",
               on_event=None, on_sync=None) -> Reflector:
        key = (api_version, kind, namespace or "")
        with self._lock:
            cbs = self._callbacks.setdefault(key, [])
            if on_event or on_sync:
                cbs.append((on_event, on_sync))
            refl = self._reflectors.get(key)
            started = refl is not None
            if refl is None:
                refl = Reflector(
                    self.client, api_version, kind, namespace,
                    on_event=lambda t, o, k=key: self._fan_event(k, t, o),
                    on_sync=lambda items, k=key: self._fan_sync(k, items),
                )
                self._reflectors[key] = refl
        if started and on_sync is not None:
            # joining an already-running reflector: replay the CURRENT
            # watch-maintained state (list + every event since) so
            # "missing key = confirmed absence" consumers start complete;
            # the delivery lock orders the replay before any later event
            with self._deliver_lock:
                state = self._state.get(key)
                if state is not None:
                    try:
                        on_sync(list(state.values()))
                    except Exception:
                        pass
        if not started:
            refl.start()
        return refl

    def _fan_event(self, key, ev_type, obj) -> None:
        with self._deliver_lock:
            state = self._state.get(key)
            if state is not None and ev_type in (
                    "ADDED", "MODIFIED", "DELETED"):
                if ev_type == "DELETED":
                    state.pop(self._obj_key(obj), None)
                else:
                    state[self._obj_key(obj)] = obj
            for on_event, _ in list(self._callbacks.get(key, [])):
                if on_event is not None:
                    try:
                        on_event(ev_type, obj)
                    except Exception:
                        pass

    def _fan_sync(self, key, items) -> None:
        with self._deliver_lock:
            self._state[key] = {self._obj_key(o): o for o in items}
            for _, on_sync in list(self._callbacks.get(key, [])):
                if on_sync is not None:
                    try:
                        on_sync(items)
                    except Exception:
                        pass

    def stop(self) -> None:
        with self._lock:
            for refl in self._reflectors.values():
                refl.stop()
            self._reflectors.clear()
            self._callbacks.clear()
            self._state.clear()


def decode_watch_line(line: bytes):
    """One newline-delimited watch frame -> (type, object) or None.

    ERROR frames carry a Status object; its code surfaces so the
    reflector can distinguish 410 Gone from other failures."""
    line = line.strip()
    if not line:
        return None
    try:
        frame = json.loads(line)
    except ValueError:
        return None
    ev_type = frame.get("type", "")
    obj = frame.get("object") or {}
    return ev_type, obj
