"""Policy cache: O(1) kind -> policy-type -> policies admission lookup.

A bitmask of policy types indexed per kind; namespaced Policy objects
store as "namespace/name". The cache also owns the compiled policy set
of each (kind, type, namespace) population, rebuilt lazily on change and
incrementally by default (one ``IncrementalCompiler`` per population):
the admission batcher's compiled sets, each on the cache's device.

Every policy entering the cache runs through the warn-only admission
lint (``LINT_ON_ADMISSION``, the analysis plane); the compile
bookkeeping (``compile_stats``, ``compile_totals``) and its churn
metrics are here.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from enum import IntFlag

from ..api.types import ClusterPolicy

logger = logging.getLogger(__name__)

# Warn-only admission lint: every policy entering the cache runs through
# the static analyzer (kyverno_tpu_torch/analysis). Diagnostics are logged
# and kept on the cache for inspection — a broken policy is still admitted
# (Kyverno semantics: the API server accepted it; refusing here would
# silently drop enforcement). Disable via env for perf-sensitive tests.
LINT_ON_ADMISSION = os.environ.get(
    "KYVERNO_TPU_LINT_ON_ADMISSION", "1") not in ("0", "false", "")


class PolicyType(IntFlag):
    MUTATE = 1
    VALIDATE_ENFORCE = 2
    VALIDATE_AUDIT = 4
    GENERATE = 8
    VERIFY_IMAGES = 16


def _title(kind: str) -> str:
    return kind[:1].upper() + kind[1:] if kind else kind


def _kind_from_gvk(gvk: str) -> str:
    """'apps/v1/Deployment' or 'Deployment' -> 'Deployment'."""
    return gvk.split("/")[-1]


class PolicyCache:
    """Policies by kind and type, with their compiled sets. ``device``
    is where every compiled set's plan lives: ``cuda`` unless the caller
    passes ``device="cpu"`` (resolved at the first compile)."""

    def __init__(self, device=None):
        self.device = device
        self._lock = threading.RLock()
        # kind -> PolicyType -> [policy keys]
        self._kind_map: dict[str, dict[PolicyType, list[str]]] = {}
        self._policies: dict[str, ClusterPolicy] = {}
        self._compiled = {}
        self._generation = 0
        self._listeners: list = []
        # policy key -> AnalysisReport from the warn-only admission lint
        self.lint_reports: dict[str, object] = {}
        # (ptype, kind, namespace) -> IncrementalCompiler: per-population
        # segment caches + append-only dictionaries (KTPU_INCREMENTAL=1)
        self._incremental: dict[tuple, object] = {}
        # last compile + cumulative compile accounting
        self.compile_stats: dict = {}
        self.compile_totals = {"full_n": 0, "full_s": 0.0,
                               "incremental_n": 0, "incremental_s": 0.0,
                               "segments_spliced": 0,
                               "segments_recompiled": 0}

    def add_listener(self, fn) -> None:
        """fn(event, policy) fires after add/update ("SET") and remove
        ("DELETE")."""
        with self._lock:
            self._listeners.append(fn)

    def _fire(self, event: str, policy: ClusterPolicy) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(event, policy)

    @staticmethod
    def _key(policy: ClusterPolicy) -> str:
        return f"{policy.namespace}/{policy.name}" if policy.namespace else policy.name

    # ------------------------------------------------------------ writes

    def add(self, policy: ClusterPolicy) -> None:
        with self._lock:
            key = self._key(policy)
            if key in self._policies:
                self._remove_locked(key)
            self._policies[key] = policy
            enforce = policy.spec.validation_failure_action == "enforce"
            seen: set[tuple[str, PolicyType]] = set()
            for rule in policy.spec.rules:
                filters = rule.match.any or rule.match.all or [None]
                for rf in filters:
                    kinds = (
                        rf.resources.kinds if rf is not None
                        else rule.match.resources.kinds
                    )
                    for gvk in kinds:
                        kind = _title(_kind_from_gvk(gvk))
                        ptype = self._rule_type(rule, enforce)
                        if ptype is None or (kind, ptype) in seen:
                            continue
                        seen.add((kind, ptype))
                        self._kind_map.setdefault(kind, {}).setdefault(
                            ptype, []
                        ).append(key)
            self._generation += 1
            self._compiled.clear()
        if LINT_ON_ADMISSION:
            self._lint_admitted(key, policy)
        self._fire("SET", policy)

    def _lint_admitted(self, key: str, policy: ClusterPolicy) -> None:
        """Warn-only static analysis of a just-admitted policy. Never
        blocks or raises: the cache must keep serving lookups even if the
        analyzer trips on an exotic policy."""
        try:
            from ..analysis import Severity, analyze_policies
            from ..models.ir import EscalationReason
            from .metrics import (record_device_decidability,
                                  record_host_rule_info, registry)

            report = analyze_policies([policy], include_tensors=False)
            self.lint_reports[key] = report
            for d in report.diagnostics:
                if d.severity >= Severity.WARNING:
                    logger.warning("policy lint: %s", d.format())
                if d.code == "KT101":
                    record_host_rule_info(
                        registry(), d.policy, d.rule,
                        d.reason or EscalationReason.UNSUPPORTED_CONSTRUCT.value)
            score = report.device_decidability.get(policy.name)
            if score is not None:
                record_device_decidability(registry(), policy.name, score)
        except Exception:
            logger.exception("policy lint failed for %s (policy admitted)",
                             key)

    def remove(self, policy: ClusterPolicy) -> None:
        with self._lock:
            self._remove_locked(self._key(policy))
            self._generation += 1
            self._compiled.clear()
        self._fire("DELETE", policy)

    def update(self, policy: ClusterPolicy) -> None:
        self.add(policy)

    def _remove_locked(self, key: str) -> None:
        self._policies.pop(key, None)
        self.lint_reports.pop(key, None)
        for type_map in self._kind_map.values():
            for ptype in list(type_map):
                type_map[ptype] = [k for k in type_map[ptype] if k != key]

    @staticmethod
    def _rule_type(rule, enforce: bool) -> PolicyType | None:
        if rule.has_mutate():
            return PolicyType.MUTATE
        if rule.has_validate():
            return PolicyType.VALIDATE_ENFORCE if enforce else PolicyType.VALIDATE_AUDIT
        if rule.has_generate():
            return PolicyType.GENERATE
        if rule.has_verify_images():
            return PolicyType.VERIFY_IMAGES
        return None

    # ------------------------------------------------------------ reads

    def get_policies(self, ptype: PolicyType, kind: str, namespace: str = "") -> list[ClusterPolicy]:
        """Cluster policies + (if namespace given) policies of that
        namespace; wildcard-kind policies always apply."""
        with self._lock:
            keys = list(self._get_keys(ptype, _title(kind)))
            keys += [k for k in self._get_keys(ptype, "*") if k not in keys]
            out = []
            for key in keys:
                policy = self._policies.get(key)
                if policy is None:
                    continue
                if policy.namespace and policy.namespace != namespace:
                    continue
                out.append(policy)
            return out

    def _get_keys(self, ptype: PolicyType, kind: str) -> list[str]:
        type_map = self._kind_map.get(kind, {})
        out: list[str] = []
        for t, keys in type_map.items():
            if t & ptype:
                out.extend(k for k in keys if k not in out)
        return out

    def all_policies(self) -> list[ClusterPolicy]:
        with self._lock:
            return list(self._policies.values())

    def snapshot(self) -> tuple[int, list[ClusterPolicy]]:
        """(generation, policies) read atomically — consumers that key
        caches by generation (the oracle pool) must never pair one
        generation's number with another generation's policy content."""
        with self._lock:
            return self._generation, list(self._policies.values())

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    # ------------------------------------------------------------ tensors

    def compiled(self, ptype: PolicyType, kind: str, namespace: str = ""):
        """The compiled set of an admission population; cached until the
        policy set changes. With KTPU_INCREMENTAL on (default) a change
        recompiles only the touched policy's segment and splices it into
        the population's existing tensors (per-population
        IncrementalCompiler); KTPU_INCREMENTAL=0 compiles the population
        from scratch."""
        from ..models import CompiledPolicySet
        from ..models.compiler import incremental_enabled

        with self._lock:
            cache_key = (int(ptype), _title(kind), namespace, self._generation)
            cps = self._compiled.get(cache_key)
            if cps is None:
                policies = self.get_policies(ptype, kind, namespace)
                t0 = time.perf_counter()
                if incremental_enabled():
                    from ..models.engine import IncrementalCompiler

                    pop = cache_key[:3]
                    inc = self._incremental.get(pop)
                    if inc is None:
                        inc = self._incremental[pop] = IncrementalCompiler(
                            device=self.device)
                    cps = inc.refresh(policies)
                    self._note_compile("incremental",
                                       time.perf_counter() - t0, pop, cps,
                                       inc.last_refresh)
                else:
                    cps = CompiledPolicySet(policies, device=self.device)
                    self._note_compile("full", time.perf_counter() - t0,
                                       cache_key[:3], cps, None)
                self._compiled = {cache_key: cps, **{
                    k: v for k, v in self._compiled.items()
                    if k[3] == self._generation
                }}
            return cps

    def _note_compile(self, mode: str, seconds: float, pop: tuple,
                      cps, refresh: dict | None) -> None:
        """Compile accounting: cache-local stats for bench/tests plus the
        churn metrics (never raises — observability must not take down
        admission)."""
        refresh = refresh or {}
        reused = int(refresh.get("reused", 0))
        recompiled = int(refresh.get("recompiled", 0))
        self.compile_stats = {
            "mode": mode, "seconds": seconds,
            "population": pop,
            "n_policies": len(cps.policies),
            "segments_reused": reused,
            "segments_recompiled": recompiled,
            "dict_epoch": cps.tensors.dict_epoch,
        }
        self.compile_totals[f"{mode}_n"] += 1
        self.compile_totals[f"{mode}_s"] += seconds
        self.compile_totals["segments_spliced"] += reused
        self.compile_totals["segments_recompiled"] += recompiled
        try:
            from .metrics import (record_dict_epoch, record_policy_compile,
                                  record_segments_spliced, registry)

            reg = registry()
            record_policy_compile(reg, seconds, mode)
            if mode == "incremental":
                record_segments_spliced(reg, reused)
                record_dict_epoch(reg, "/".join(str(p) for p in pop),
                                  cps.tensors.dict_epoch)
        except Exception:
            logger.exception("compile metrics recording failed")
