"""Overlapped host-lane resolution: the escape hatch, pipelined.

Every evaluation path ends in ``resolve_host_cells``: the cells the card
reports HOST go to the CPU oracle. Run serially, one resource at a time
in the caller's thread after the device verdicts arrive, that tail is
most of ``evaluate()``. This module shortens it with three composable
mechanisms, each behind its own kill switch:

1. **Predictive prefetch** (``KTPU_HOST_PREFETCH``) — HOST-ness is
   statically known per rule (``PolicyTensors.rule_host_only``), so
   callers can start oracle-resolving the host-only (rule, resource)
   cells *concurrently with* device dispatch and join at scatter time.
   The join only scatters into cells the device actually reported HOST,
   so a prefetch that over-computes (match failed on device) wastes
   work but can never change a verdict; cells the device unexpectedly
   escalates still resolve in the ordinary post-pass.
2. **Verdict memoization** (``KTPU_HOST_MEMO``) — a content-addressed
   cache (runtime/resourcecache.HostVerdictCache) keyed by (policy
   content digest, rule name, body digest), so repeated bodies — the
   admission coalescing case and background re-scans — never re-run
   the oracle. Context-dependent rules carry a short TTL.
3. **Fan-out** (``KTPU_HOST_FANOUT``) — multi-resource resolution
   batches fan out over a small thread pool. The oracle holds the GIL,
   so the threads overlap its work with the caller's own (the device
   dispatch, the next chunk's flatten) more than with each other. Under
   the same switch, request-faithful, pool-safe resolutions route
   through an attached ``OraclePool`` (spawned worker processes, which
   do run in parallel) when it is warm for the current policy
   generation; a pool miss resolves inline, with equal verdicts.

The executor threads run the oracle only: none of them launches a
kernel or copies a tensor.

With all three switches off, :func:`HostLaneResolver.resolve_rows`
degenerates to exactly the serial per-resource loop — same iteration
order, same oracle calls — so the kill switches restore the serial
dataflow bit for bit. One difference is kept from the JAX package on
purpose: under fan-out, an oracle exception for one resource leaves that
resource's cells HOST, where the serial loop lets it out.
"""

from __future__ import annotations

import os
import threading
import time

from ..models.engine import _STATUS_TO_VERDICT, Verdict
from . import featureplane, tracing
from .resourcecache import HostVerdictCache


def prefetch_enabled() -> bool:
    return featureplane.enabled("KTPU_HOST_PREFETCH")


def memo_enabled() -> bool:
    return featureplane.enabled("KTPU_HOST_MEMO")


def fanout_enabled() -> bool:
    return featureplane.enabled("KTPU_HOST_FANOUT")


# a pool resolution's timeout: the JAX package's default, the one its
# host lane passes with the SLO actions plane off
POOL_TIMEOUT_S = 3.0


_cache: HostVerdictCache | None = None
_cache_lock = threading.Lock()


def host_cache() -> HostVerdictCache:
    """Process-wide host-verdict memo (one content-addressed key space
    serves every CompiledPolicySet — the policy digest partitions it)."""
    global _cache
    if _cache is None:
        with _cache_lock:
            if _cache is None:
                _cache = HostVerdictCache()
    return _cache


class HostPrefetch:
    """Handle on in-flight host-cell resolutions started at dispatch
    time. :meth:`apply` is the join: it blocks on the per-resource
    futures and scatters their verdicts into cells that are HOST in the
    materialized device matrix (and only those — see the module
    docstring's parity argument). ``oracle_s`` is the total oracle time
    the futures burned, ``wait_s`` how long apply actually blocked; the
    difference is work hidden inside the device flight."""

    __slots__ = ("_futs", "submitted_cells", "applied_cells",
                 "oracle_s", "wait_s")

    def __init__(self, futs: dict, submitted_cells: int):
        self._futs = futs                  # row -> Future[(oracle, secs)]
        self.submitted_cells = submitted_cells
        self.applied_cells = 0
        self.oracle_s = 0.0
        self.wait_s = 0.0

    def apply(self, verdicts, messages_out: dict | None = None) -> int:
        t0 = time.monotonic()
        j0 = time.perf_counter()
        applied = 0
        n_rows = verdicts.shape[0]
        for b, fut in self._futs.items():
            try:
                oracle, secs = fut.result()
            except Exception:
                continue                   # leftovers go to the post-pass
            self.oracle_s += secs
            if b >= n_rows:
                continue
            for r, (v, msg) in oracle.items():
                if verdicts[b, r] == Verdict.HOST:
                    verdicts[b, r] = v
                    if messages_out is not None:
                        messages_out[(b, r)] = msg
                    applied += 1
        self._futs = {}
        self.wait_s = time.monotonic() - t0
        self.applied_cells = applied
        tracing.recorder().add_span(
            tracing.current(), "host_join", j0, time.perf_counter(),
            applied=applied, submitted=self.submitted_cells,
            overlap_us=int(self.overlap_s() * 1e6), lane="prefetch")
        return applied

    def overlap_s(self) -> float:
        """Oracle seconds that ran in the device flight's shadow instead
        of on the post-device critical path."""
        return max(0.0, self.oracle_s - self.wait_s)


class HostLaneResolver:
    """Singleton engine behind resolve_host_cells: owns the fan-out
    executor, the optional OraclePool attachment, and the memoized
    per-resource oracle core."""

    def __init__(self, max_workers: int | None = None):
        self._lock = threading.Lock()
        self._executor = None
        self._max_workers = max_workers or max(
            2, min(8, (os.cpu_count() or 1)))
        self._pool = None                  # OraclePool
        self._pool_cache = None            # PolicyCache (generation source)
        self._gen_ids: tuple = (None, frozenset())
        self.stats = {"prefetch_submitted": 0, "prefetch_applied": 0,
                      "fanout_batches": 0, "pool_cells": 0}

    # ------------------------------------------------------------ wiring

    def executor(self):
        if self._executor is None:
            with self._lock:
                if self._executor is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._executor = ThreadPoolExecutor(
                        max_workers=self._max_workers,
                        thread_name_prefix="ktpu-hostlane")
        return self._executor

    def attach_pool(self, pool, policy_cache) -> None:
        """Give the resolver an OraclePool plus the PolicyCache whose
        generation counter vouches for the pool's worker policy sets.
        Routing stays generation-safe: a batch only goes to the pool
        when the pool is warm for the cache's *current* generation and
        every policy in the batch is an object of that generation —
        verdicts from one generation's workers can never scatter into
        another generation's matrix."""
        with self._lock:
            self._pool = pool
            self._pool_cache = policy_cache
            self._gen_ids = (None, frozenset())

    def _generation_ids(self):
        """(generation, frozenset of live policy ids) snapshot, cached
        per generation (PolicyCache.snapshot copies under its lock)."""
        cache = self._pool_cache
        if cache is None:
            return None, frozenset()
        gen = cache.generation
        with self._lock:
            if self._gen_ids[0] == gen:
                return self._gen_ids
        gen2, policies = cache.snapshot()
        ids = frozenset(id(p) for p in policies)
        with self._lock:
            self._gen_ids = (gen2, ids)
        return gen2, ids

    # ------------------------------------------------- static candidates

    @staticmethod
    def _candidate_table(cps) -> list:
        """[(rule_index, bare-kind set or None-for-wildcard)] for the
        statically host-only rules, cached on the compiled set (host-ness
        and kinds are compile-time facts)."""
        table = getattr(cps, "_ktpu_host_candidates", None)
        if table is None:
            import numpy as np

            live = cps.tensors.n_rules_live
            host = np.asarray(cps.tensors.rule_host_only[:live])
            table = []
            for r in np.nonzero(host)[0]:
                r = int(r)
                kinds = {k.split("/")[-1]
                         for k in cps.rule_irs[r].kinds} - {""}
                table.append((r, None if (not kinds or "*" in kinds)
                              else kinds))
            cps._ktpu_host_candidates = table
        return table

    def candidate_rows(self, cps, resources: list[dict],
                       rule_filter=None) -> dict[int, list[int]]:
        """{row: [host-only rule indices applicable to the row's kind]}
        — the statically predicted HOST cells prefetch resolves."""
        table = self._candidate_table(cps)
        if not table:
            return {}
        out: dict[int, list[int]] = {}
        for b, resource in enumerate(resources):
            kind = (resource or {}).get("kind", "")
            rows = [r for r, kinds in table
                    if (kinds is None or kind in kinds)
                    and (rule_filter is None or r in rule_filter)]
            if rows:
                out[b] = rows
        return out

    # --------------------------------------------------------- prefetch

    def prefetch(self, cps, resources: list[dict],
                 contexts: list | None = None,
                 rule_filter=None,
                 context_for=None) -> HostPrefetch | None:
        """Start resolving the statically-known HOST cells on the
        executor; returns a join handle (or None when disabled / no
        candidates). Call at device-dispatch time; ``apply`` at scatter
        time. ``context_for(row)`` lazily builds the admission payload
        for rows that actually have candidates (the batcher's ctx_cb)."""
        if not prefetch_enabled():
            return None
        candidates = self.candidate_rows(cps, resources, rule_filter)
        if not candidates:
            return None

        # the trace active on the dispatching thread — prefetch rows run
        # on executor threads, so attribution is explicit
        parent = tracing.current()
        rec = tracing.recorder()

        def run(resource, rows, context):
            t0 = time.monotonic()
            p0 = time.perf_counter()
            oracle = self.resolve_resource(cps, resource, rows, context,
                                           trace=parent)
            rec.add_span(parent, "host_prefetch", p0, time.perf_counter(),
                         cells=len(rows))
            return oracle, time.monotonic() - t0

        ex = self.executor()
        futs = {}
        cells = 0
        for b, rows in candidates.items():
            context = contexts[b] if contexts is not None else None
            if context is None and context_for is not None:
                try:
                    context = context_for(b)
                except Exception:
                    context = None
            futs[b] = ex.submit(run, resources[b], rows, context)
            cells += len(rows)
        with self._lock:
            self.stats["prefetch_submitted"] += cells
        return HostPrefetch(futs, cells)

    def note_applied(self, cells: int) -> None:
        with self._lock:
            self.stats["prefetch_applied"] += cells

    # -------------------------------------------------------- resolution

    def resolve_rows(self, cps, resources: list[dict],
                     by_resource: dict[int, list[int]], verdicts,
                     contexts: list | None,
                     messages_out: dict | None) -> int:
        """Resolve the post-device HOST cells grouped per resource —
        the engine's serial loop, with memoization inside
        resolve_resource and multi-resource fan-out over the executor.
        Scatter happens on the calling thread in submission order, so
        results are identical to the serial loop."""
        items = list(by_resource.items())

        def ctx(b):
            return contexts[b] if contexts is not None else None

        resolved = 0
        parent = tracing.current()
        if fanout_enabled() and len(items) > 1:
            ex = self.executor()
            with self._lock:
                self.stats["fanout_batches"] += 1
            futs = [(b, ex.submit(self.resolve_resource, cps,
                                  resources[b], rows, ctx(b), parent))
                    for b, rows in items]
            for b, fut in futs:
                try:
                    oracle = fut.result()
                except Exception:
                    continue
                resolved += _scatter(verdicts, b, oracle, messages_out)
        else:
            for b, rows in items:
                oracle = self.resolve_resource(cps, resources[b], rows,
                                               ctx(b))
                resolved += _scatter(verdicts, b, oracle, messages_out)
        return resolved

    def resolve_resource(self, cps, resource: dict, rule_rows: list[int],
                         context: dict | None, trace=None) -> dict:
        """{rule_index: (Verdict, message)} for one resource's HOST
        cells — memo lookups first, then one oracle pass for the misses
        (pool workers when eligible, inline otherwise).
        ``trace`` carries the caller's trace onto executor threads
        (defaults to the thread-local current trace)."""
        if trace is None:
            trace = tracing.current()
        r0 = time.perf_counter()
        lane = "memo"
        memo = host_cache() if memo_enabled() else None
        out: dict[int, tuple] = {}
        misses = list(rule_rows)
        body_digest = None
        if memo is not None:
            body_digest = HostVerdictCache.body_digest(resource, context)
        keys: dict[int, tuple] = {}
        if memo is not None and body_digest is not None:
            still: list[int] = []
            for r in misses:
                ref = cps.rule_refs[r]
                pdig = HostVerdictCache.policy_digest(ref.policy)
                if pdig is None:
                    still.append(r)
                    continue
                key = (pdig, ref.rule.name, body_digest)
                keys[r] = key
                hit = memo.get(key)
                if hit is None:
                    still.append(r)
                else:
                    out[r] = hit
            misses = still
        n_memo_hits = len(rule_rows) - len(misses)
        if misses:
            fresh, lane = self._oracle_misses(cps, resource, misses,
                                              context)
            if memo is not None:
                for r, cell in fresh.items():
                    key = keys.get(r)
                    if key is None:
                        continue
                    ttl = (memo.pure_ttl_s
                           if _policy_pure(cps.rule_refs[r].policy)
                           else memo.context_ttl_s)
                    memo.put(key, cell[0], cell[1], ttl)
            out.update(fresh)
        tracing.recorder().add_span(
            trace, "host_resolve_row", r0, time.perf_counter(),
            cells=len(rule_rows), memo_hits=n_memo_hits,
            misses=len(misses), lane=lane)
        return out

    def _oracle_misses(self, cps, resource: dict, rule_rows: list[int],
                       context: dict | None) -> tuple[dict, str]:
        """Returns (verdicts, lane) — lane names which oracle served the
        misses ("pool" workers vs the "inline" engine)."""
        if fanout_enabled() and self._pool is not None:
            routed = self._pool_resolve(cps, resource, rule_rows, context)
            if routed is not None:
                return routed, "pool"
        return cps._oracle_verdicts(resource, rule_rows,
                                    context=context), "inline"

    def _pool_resolve(self, cps, resource: dict, rule_rows: list[int],
                      context: dict | None):
        """Route one resource's miss batch through OraclePool workers,
        or None to resolve inline. Only request-faithful resolutions
        (context carries a real admission request — the worker recipe
        mirrors _request_policy_context exactly for those) of pool-safe
        policies belonging to the pool's current generation qualify."""
        pool = self._pool
        if pool is None or not getattr(pool, "enabled", False):
            return None
        if not context or not context.get("request"):
            return None
        gen, live_ids = self._generation_ids()
        if gen is None or not pool.ready(gen):
            return None
        policies = {}
        for r in rule_rows:
            policy = cps.rule_refs[r].policy
            if id(policy) not in live_ids or not _policy_pure(policy):
                return None
            policies[policy.name] = policy
        results = pool.evaluate_payload(list(policies), resource, context,
                                        timeout_s=POOL_TIMEOUT_S)
        if results is None:
            return None
        rows = {(pname, rname): (status, msg)
                for pname, rules in results
                for rname, status, msg in rules}
        from ..engine.response import RuleStatus

        out: dict[int, tuple] = {}
        for r in rule_rows:
            ref = cps.rule_refs[r]
            cell = rows.get((ref.policy.name, ref.rule.name))
            if cell is None:
                out[r] = (Verdict.NOT_APPLICABLE, "")
            else:
                out[r] = (_STATUS_TO_VERDICT[RuleStatus(cell[0])], cell[1])
        with self._lock:
            self.stats["pool_cells"] += len(rule_rows)
        return out


def _scatter(verdicts, b: int, oracle: dict,
             messages_out: dict | None) -> int:
    for r, (v, msg) in oracle.items():
        verdicts[b, r] = v
        if messages_out is not None:
            messages_out[(b, r)] = msg
    return len(oracle)


def _policy_pure(policy) -> bool:
    """Pure = verdict is a function of (policy, body) alone — the
    oracle_pool.pool_safe predicate (no cluster-state context entries),
    cached on the policy object. Pure rules memoize with the long TTL
    and may go to pool workers; context-dependent ones stay inline with
    the short TTL."""
    ok = getattr(policy, "_ktpu_pool_safe", None)
    if ok is None:
        from .oracle_pool import pool_safe

        try:
            ok = pool_safe(policy)
        except Exception:
            ok = False
        try:
            policy._ktpu_pool_safe = ok
        except Exception:
            pass
    return ok


_resolver: HostLaneResolver | None = None
_resolver_lock = threading.Lock()


def resolver() -> HostLaneResolver:
    global _resolver
    if _resolver is None:
        with _resolver_lock:
            if _resolver is None:
                _resolver = HostLaneResolver()
    return _resolver
