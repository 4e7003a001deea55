"""Rollout dry-run: blast radius of a candidate policy, zero live impact.

A candidate ClusterPolicy doc compiles as an *isolated* segment
(:meth:`IncrementalCompiler.compile_candidate` — same append-only
dictionary, so flatten memos splice, but the live segment cache and the
compiled full set are untouched) and evaluates against the persisted
scan corpus. The baseline comes from the scanner's verdict-matrix
columns for the same policy name — absent (a brand-new policy) every
candidate FAIL is newly failing. Host-lane cells resolve into a private
copy (``resolve_host_cells(copy=True)``); nothing writes to the
decision cache, the result cache, or the verdict matrix, which the
quiescent probes of chip_smoke.py's ``[workload]`` phase assert
fingerprint-for-fingerprint.

Report schema (``DRYRUN_SCHEMA_VERSION``)::

    {schema_version, policy, rules, resources_evaluated,
     baseline_present, newly_failing, newly_passing, still_failing,
     per_namespace: {ns: {newly_failing, newly_passing}},
     samples: [{namespace, kind, name, rule, message}],
     device_decidability: {rules, host_only, device_fraction},
     duration_s}

Gated on KTPU_DRYRUN; exposed at POST /debug/dryrun (runtime/obs_http)
and ``kyverno-tpu dryrun``. The candidate runs where the scan corpus
does: on the scanner's device, or with no scanner on ``cuda`` unless the
caller passes ``device="cpu"`` (with no card it raises).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..runtime import featureplane
from ..runtime import metrics as metrics_mod

DRYRUN_SCHEMA_VERSION = 1


class DryRunDisabled(RuntimeError):
    """KTPU_DRYRUN=0: the dry-run service must not evaluate anything."""


# The serving process registers its scanner here so the HTTP handler
# (obs_http, which must not hold runtime object references) can reach
# the live scan corpus.
_lock = threading.Lock()
_scan_source = None


def set_scan_source(scanner) -> None:
    global _scan_source
    with _lock:
        _scan_source = scanner


def scan_source():
    with _lock:
        return _scan_source


def _baseline_fail_rows(scanner, policy_name: str):
    """Row keys the live verdict matrix already marks FAIL for
    ``policy_name`` (None when the scanner has no matrix or the policy
    has no columns — a new policy)."""
    from ..models import Verdict

    if scanner is None:
        return None
    matrix = scanner.verdict_matrix()
    if matrix is None:
        return None
    keys, ckeys, mat = matrix
    cols = [i for i, ck in enumerate(ckeys) if ck[0] == policy_name]
    if not cols:
        return None
    failing = set()
    for i, key in enumerate(keys):
        if any(mat[i, c] == int(Verdict.FAIL) for c in cols):
            failing.add(key)
    return failing


def dry_run(candidate_doc: dict, scanner=None,
            resources: list | None = None, sample_limit: int = 5,
            device=None) -> dict:
    """Evaluate ``candidate_doc`` against the scan corpus and report its
    blast radius. ``scanner`` defaults to the registered scan source;
    ``resources`` overrides the corpus (offline CLI use). ``device``
    defaults to the scanner's, and with no scanner to ``cuda``."""
    if not featureplane.enabled("KTPU_DRYRUN"):
        raise DryRunDisabled("KTPU_DRYRUN=0: dry-run service disabled")
    t0 = time.perf_counter()
    reg = metrics_mod.registry()

    from ..api.load import load_policy
    from ..models import CompiledPolicySet, Verdict
    from ..models.engine import resolve_device

    policy = load_policy(candidate_doc)

    if scanner is None:
        scanner = scan_source()
    if resources is None:
        if scanner is None or scanner._state is None:
            raise ValueError("no scan corpus: pass resources or seed a "
                             "scanner (background scan) first")
        state = scanner._state
        keys = list(state["keys"])
        resources = [state["resources"][k] for k in keys]

    inc = getattr(scanner, "_inc", None) if scanner is not None else None
    if inc is not None:
        cps = inc.compile_candidate(policy)
        compile_lane = "incremental_isolated"
    else:
        if device is None and scanner is not None:
            device = scanner.device
        cps = CompiledPolicySet([policy], device=resolve_device(device))
        compile_lane = "one_shot"

    messages: dict = {}
    if resources:
        verdicts = np.asarray(cps.evaluate_device(
            cps.flatten_packed(resources)))
        if (verdicts == int(Verdict.HOST)).any():
            # private copy: the input rows may be memoized scan state
            verdicts = cps.resolve_host_cells(resources, verdicts,
                                              messages_out=messages,
                                              copy=True)
    else:
        verdicts = np.zeros((0, cps.tensors.n_rules), dtype=np.int8)

    def res_key(r: dict) -> tuple:
        meta = r.get("metadata") or {}
        return (r.get("kind", ""), meta.get("namespace", ""),
                meta.get("name", ""))

    live = cps.tensors.n_rules_live
    fail_rows = {}
    for b, r in enumerate(resources):
        rules = [ref for ref in cps.rule_refs
                 if verdicts[b, ref.rule_index] == int(Verdict.FAIL)]
        if rules:
            fail_rows[res_key(r)] = (b, rules)

    baseline = _baseline_fail_rows(scanner, policy.name)
    baseline_present = baseline is not None
    baseline = baseline or set()

    newly_failing = sorted(k for k in fail_rows if k not in baseline)
    still_failing = sorted(k for k in fail_rows if k in baseline)
    corpus_keys = {res_key(r) for r in resources}
    newly_passing = sorted(k for k in baseline
                           if k in corpus_keys and k not in fail_rows)

    per_namespace: dict[str, dict] = {}
    for k in newly_failing:
        ns = per_namespace.setdefault(k[1], {"newly_failing": 0,
                                             "newly_passing": 0})
        ns["newly_failing"] += 1
    for k in newly_passing:
        ns = per_namespace.setdefault(k[1], {"newly_failing": 0,
                                             "newly_passing": 0})
        ns["newly_passing"] += 1

    samples = []
    for k in newly_failing[:max(0, sample_limit)]:
        b, rules = fail_rows[k]
        ref = rules[0]
        samples.append({
            "kind": k[0], "namespace": k[1], "name": k[2],
            "rule": ref.rule.name,
            "message": messages.get((b, ref.rule_index))
            or ref.rule.validation.message or "",
        })

    host_only = int(np.asarray(
        cps.tensors.rule_host_only[:live]).sum())
    report = {
        "schema_version": DRYRUN_SCHEMA_VERSION,
        "policy": policy.name,
        "rules": live,
        "compile_lane": compile_lane,
        "resources_evaluated": len(resources),
        "baseline_present": baseline_present,
        "newly_failing": len(newly_failing),
        "newly_failing_resources": ["/".join(k) for k in newly_failing],
        "newly_passing": len(newly_passing),
        "newly_passing_resources": ["/".join(k) for k in newly_passing],
        "still_failing": len(still_failing),
        "per_namespace": per_namespace,
        "samples": samples,
        "device_decidability": cps.tensors.decidability_summary(),
        "duration_s": round(time.perf_counter() - t0, 4),
    }
    metrics_mod.record_dryrun_request(
        reg, status="ok", seconds=time.perf_counter() - t0)
    metrics_mod.record_dryrun_blast_radius(
        reg, policy=policy.name, newly_failing=len(newly_failing),
        newly_passing=len(newly_passing))
    return report
