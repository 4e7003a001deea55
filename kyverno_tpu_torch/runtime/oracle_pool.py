"""Multiprocess CPU-oracle lane: multicore scaling for admission bursts.

CPython's GIL serializes the oracle, so a 16-way burst on an 8-core host
still evaluates one policy at a time (threads only add switching: the
host lane's fan-out runs slower than its serial loop). This pool runs
the per-request enforce loop in *spawned* worker processes (spawn, never
fork: the parent holds CUDA state that must not leak into children;
workers import only the torch-free modules ``api`` and ``engine``).

Scope is deliberately narrow and safe:

- engages only when the host has enough cores to win
  (``os.cpu_count() >= MIN_CORES``); below that it stays dormant and
  the inline path is untouched;
- only *cluster-independent* policies are eligible (:func:`pool_safe`:
  no ``context:`` entries, no API calls): workers have no cluster
  client, so anything needing one stays inline. Namespace labels and
  RBAC roles resolve in the parent and travel as plain data;
- workers never reach the card: their launcher sets
  ``CUDA_VISIBLE_DEVICES`` to empty;
- any pool failure — pickling, worker crash, timeout — returns None and
  the caller resolves that request with the inline oracle. Wrong-way
  cost is latency only.

Policy sets ship to workers once per generation via the pool
initializer; a policy-cache change rebuilds the pool in the background
(admission keeps the old pool until the new one is warm).
"""

from __future__ import annotations

import multiprocessing.context
import multiprocessing.spawn
import os
import threading
from concurrent.futures import ProcessPoolExecutor

MIN_CORES = 4
# a pool call's wait is taken in slices this long (s), and a slice that
# took longer (the calling process stalled: a garbage collection, the
# interpreter lock) counts as this long: the call's timeout measures the
# pool, not a stall of its caller, during which no answer can be read.
# The wait's wall time is still capped at WAIT_WALL_CAP times the timeout.
WAIT_SLICE_S = 0.25
WAIT_WALL_CAP = 2.0

# worker-side state (one policy set per generation)
_worker_policies: list = []


def _worker_init(policy_raws: list[dict]) -> None:
    global _worker_policies
    from ..api.load import load_policy

    _worker_policies = [load_policy(raw) for raw in policy_raws]


# what a worker's launcher sets before it runs the interpreter: no CUDA
# device is visible to it. The launcher does it, not the parent's
# os.environ, which other threads may read meanwhile.
_WORKER_ENV = (("CUDA_VISIBLE_DEVICES", ""),)


def _make_worker_launcher() -> str:
    """Write a launcher that sets the worker environment and execs the
    real interpreter; the pool's workers start through it (see
    :class:`_WorkerProcess`). It lives in the temporary directory and
    goes at :meth:`OraclePool.stop`."""
    import stat
    import sys
    import tempfile

    lines = ["#!/bin/sh"]
    lines += [f'export {key}="{value}"' for key, value in _WORKER_ENV]
    lines.append(f'exec "{sys.executable}" "$@"')
    fd, path = tempfile.mkstemp(prefix="ktpu-oracle-worker-", suffix=".sh")
    with os.fdopen(fd, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


# multiprocessing keeps one executable for every spawn of the process; a
# worker's start sets it to the launcher and puts back what was there,
# under this lock, so that no other spawn starts through the launcher
_SPAWN_LOCK = threading.Lock()


class _WorkerProcess(multiprocessing.context.SpawnProcess):
    """A spawned process that starts through its ``launcher``."""

    launcher: str | None = None

    @staticmethod
    def _Popen(process_obj):
        with _SPAWN_LOCK:
            previous = multiprocessing.spawn.get_executable()
            multiprocessing.spawn.set_executable(process_obj.launcher)
            try:
                return multiprocessing.context.SpawnProcess._Popen(
                    process_obj)
            finally:
                multiprocessing.spawn.set_executable(previous)


class _WorkerContext(multiprocessing.context.SpawnContext):
    """The spawn context of one pool: its processes are
    :class:`_WorkerProcess` over the pool's launcher."""

    def __init__(self, launcher: str):
        super().__init__()
        self.launcher = launcher

    def Process(self, *args, **kwargs):
        process = _WorkerProcess(*args, **kwargs)
        process.launcher = self.launcher
        return process


def _worker_evaluate(names: list[str], resource: dict, request: dict,
                     ns_labels: dict, roles: list, cluster_roles: list,
                     exclude_group_role: list):
    """Run the enforce oracle for the named policies in this worker.
    Returns [(policy_name, [(rule_name, status_value, message), ...])]."""
    from ..engine.context import Context
    from ..engine.match import AdmissionUserInfo, RequestInfo
    from ..engine.policy_context import PolicyContext
    from ..engine.validation import validate as oracle_validate

    ctx = Context()
    ctx.add_request(request)
    if resource:
        ctx.add_resource(resource)
    if request.get("oldObject"):
        ctx.add_old_resource(request["oldObject"])
    user_info = request.get("userInfo") or {}
    ctx.add_user_info({"roles": roles, "clusterRoles": cluster_roles,
                       "userInfo": user_info})
    username = user_info.get("username", "")
    if username:
        ctx.add_service_account(username)
    try:
        ctx.add_image_info(resource)
    except Exception:
        pass

    wanted = set(names)
    pctx = PolicyContext(
        new_resource=resource,
        old_resource=request.get("oldObject") or {},
        json_context=ctx, namespace_labels=ns_labels,
        exclude_group_role=exclude_group_role,
        admission_info=RequestInfo(
            roles=roles, cluster_roles=cluster_roles,
            admission_user_info=AdmissionUserInfo(
                username=username, uid=user_info.get("uid", ""),
                groups=user_info.get("groups") or [])),
    )
    out = []
    for policy in _worker_policies:
        if policy.name not in wanted:
            continue
        pctx.policy = policy
        resp = oracle_validate(pctx)
        out.append((policy.name,
                    [(r.name, r.status.value, r.message)
                     for r in resp.policy_response.rules]))
    return out


def pool_safe(policy) -> bool:
    """True when every rule of the policy evaluates without a cluster
    client: no context entries (ConfigMap/APICall loads) at the rule
    level OR inside foreach entries — validate foreach carries its own
    ``context:`` list loaded per-iteration (ForEach.context), and a
    worker has no client/resource_cache to serve it."""
    for rule in policy.spec.rules:
        if rule.context:
            return False
        for fe in list(rule.validation.foreach) + list(rule.mutation.foreach):
            if fe.context:
                return False
    return True


class OraclePool:
    """Process pool over the current enforce policy set."""

    def __init__(self, workers: int | None = None,
                 min_cores: int = MIN_CORES,
                 miss_threshold: int = 3, miss_cooldown_s: float = 30.0):
        cores = os.cpu_count() or 1
        self.enabled = cores >= min_cores
        self.workers = workers or max(2, min(8, cores - 1))
        self._pool: ProcessPoolExecutor | None = None
        self._generation = -1
        self._building: int | None = None
        self._lock = threading.Lock()
        self._launcher: str | None = None
        self._build_thread: threading.Thread | None = None
        self._stopped = False
        self.hits = 0
        self.misses = 0
        # lane breaker: consecutive timeouts/errors take the lane out for
        # a cooldown instead of adding a flat timeout to every admission
        self.miss_threshold = miss_threshold
        self.miss_cooldown_s = miss_cooldown_s
        self._consecutive_misses = 0
        self._disabled_until = 0.0
        # backlog guard: abandoned (timed-out) tasks keep running in the
        # workers; don't queue more than the pool can plausibly drain
        self._inflight = 0

    # ------------------------------------------------------------ lifecycle

    def ensure(self, generation: int, policies: list) -> bool:
        """Make sure workers hold ``policies`` (by generation). Returns
        True when the pool is ready for that generation; a miss kicks a
        BACKGROUND rebuild and returns False — spawning workers costs
        seconds and must never block an admission request."""
        if not self.enabled:
            return False
        with self._lock:
            if self._pool is not None and self._generation == generation:
                return True
            if self._building is not None or self._stopped:
                return False
            self._building = generation
            raws = [p.raw for p in policies]

        def build():
            try:
                # workers spawn through the launcher, so no child sees the
                # card and the parent's environment is never touched
                if self._launcher is None:
                    self._launcher = _make_worker_launcher()
                pool = ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=_WorkerContext(self._launcher),
                    initializer=_worker_init, initargs=(raws,))
                import concurrent.futures as cf

                warm = [pool.submit(_worker_ready)
                        for _ in range(self.workers)]
                cf.wait(warm, timeout=120)
            except Exception:
                with self._lock:
                    self._building = None
                return
            with self._lock:
                stopped = self._stopped
                if not stopped:
                    old, self._pool = self._pool, pool
                    self._generation = generation
                self._building = None
            if stopped:
                pool.shutdown(wait=True, cancel_futures=True)
            elif old is not None:
                old.shutdown(wait=False, cancel_futures=True)

        self._build_thread = threading.Thread(
            target=build, name="oracle-pool-build", daemon=True)
        self._build_thread.start()
        return False

    def ready(self, generation: int) -> bool:
        with self._lock:
            return self._pool is not None and self._generation == generation

    def evaluate(self, names: list[str], resource: dict, request: dict,
                 ns_labels: dict, roles: list, cluster_roles: list,
                 exclude_group_role: list, timeout_s: float = 3.0):
        """Submit one admission's enforce loop; returns the serialized
        results or None (caller falls back inline). Consecutive misses
        open a cooldown breaker; a broken executor (worker OOM-kill)
        drops the pool so ensure() rebuilds it. The timeout counts the
        pool's time, not a stall of this process (:func:`_result_within`)."""
        import time

        with self._lock:
            pool = self._pool
            if (pool is None
                    or time.monotonic() < self._disabled_until
                    or self._inflight >= 2 * self.workers):
                return None
            self._inflight += 1
        broken = False
        try:
            fut = pool.submit(_worker_evaluate, names, resource, request,
                              ns_labels, roles, cluster_roles,
                              exclude_group_role)
            out = _result_within(fut, timeout_s)
            with self._lock:
                self.hits += 1
                self._consecutive_misses = 0
            return out
        except Exception as e:
            fut = locals().get("fut")
            if fut is not None:
                fut.cancel()        # a queued (not yet running) task dies
            from concurrent.futures.process import BrokenProcessPool

            broken = isinstance(e, BrokenProcessPool)
            with self._lock:
                self.misses += 1
                self._consecutive_misses += 1
                if self._consecutive_misses >= self.miss_threshold:
                    self._disabled_until = (time.monotonic()
                                            + self.miss_cooldown_s)
                    self._consecutive_misses = 0
                if broken and self._pool is pool:
                    # executor is dead; next ensure() rebuilds
                    self._pool = None
                    self._generation = -1
            if broken:
                pool.shutdown(wait=False, cancel_futures=True)
            return None
        finally:
            with self._lock:
                self._inflight -= 1

    def evaluate_payload(self, names: list[str], resource: dict,
                         payload: dict | None, timeout_s: float = 3.0):
        """Host-lane entry (runtime/hostlane._pool_resolve): unpack an
        admission context payload — the
        models/engine._request_policy_context shape ``{"request",
        "namespace_labels", "roles", "cluster_roles",
        "exclude_group_role"}`` — into the worker call. Same
        None-on-miss contract as :meth:`evaluate`."""
        payload = payload or {}
        return self.evaluate(
            names, resource, payload.get("request") or {},
            payload.get("namespace_labels") or {},
            payload.get("roles") or [],
            payload.get("cluster_roles") or [],
            payload.get("exclude_group_role") or [],
            timeout_s=timeout_s)

    def stop(self) -> None:
        """Shut the workers down (waiting for them, so that no process
        of the pool outlives it) and remove the launcher."""
        with self._lock:
            pool, self._pool = self._pool, None
            self._stopped = True
        build_thread = self._build_thread
        if build_thread is not None:
            build_thread.join(timeout=130)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if self._launcher is not None:
            try:
                os.unlink(self._launcher)
            except OSError:
                pass
            self._launcher = None


def _result_within(fut, timeout_s: float):
    """``fut.result()`` within ``timeout_s`` of waiting, counted slice by
    slice (:data:`WAIT_SLICE_S`), each slice at most its own length: a
    stall of this process past a slice does not use up the timeout. The
    wait also gives up after ``WAIT_WALL_CAP * timeout_s`` of wall time.
    Either way, when the slice that ran out was a stall (it overran its
    length by more than a slice), one more slice is waited, so an answer
    the pool gave during the stall is read once the process runs again.
    Raises ``TimeoutError`` as ``fut.result`` does."""
    import time
    from concurrent.futures import TimeoutError as FuturesTimeout

    waited = 0.0
    give_up = time.monotonic() + WAIT_WALL_CAP * timeout_s
    last = False
    while True:
        t0 = time.monotonic()
        step = (WAIT_SLICE_S if last else
                min(WAIT_SLICE_S, max(0.0, timeout_s - waited),
                    max(0.0, give_up - t0)))
        try:
            return fut.result(timeout=step)
        except FuturesTimeout:
            t1 = time.monotonic()
            waited += min(t1 - t0, step)
            if last:
                raise
            if waited >= timeout_s or t1 >= give_up:
                if t1 - t0 <= step + WAIT_SLICE_S:
                    raise
                last = True         # the slice was a stall: one more


def _worker_ready() -> dict:
    """Warm-up no-op: forces worker spawn + module import + policy load.
    Returns what the worker can reach, for test assertions: its policies,
    its CUDA_VISIBLE_DEVICES, and whether torch or jax got loaded."""
    import sys

    return {
        "policies": len(_worker_policies),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "torch_loaded": "torch" in sys.modules,
        "jax_loaded": "jax" in sys.modules,
    }
