"""Background scan: validate existing resources against the policy set.

Mirrors the reference's pkg/policy (processExistingResources,
existing.go:20): instead of its serial per-resource loop on 2 workers,
the whole snapshot is flattened once and scored as a policy x resource
matrix on the card (CompiledPolicySet), with the CPU oracle lane for
host-only rules, or over a device mesh (parallel/mesh.sharded_scan, K7).
Results feed the report pipeline.

Lanes of :meth:`BackgroundScanner.scan`: ``mesh`` (a mesh passed in, or
``KTPU_MESH_SHAPE``; 1D or 2D), ``incremental`` (KTPU_INCREMENTAL, the
default: chunked, and it keeps the state the delta pass needs), and with
KTPU_INCREMENTAL=0 ``single`` (one evaluate), ``pipelined``
(evaluate_pipelined) or ``serial_chunks`` (KTPU_FLATTEN_PIPELINE=0) above
one chunk. The scanner runs on ``cuda`` unless the caller passes
``device="cpu"`` or a mesh of CPU devices. ``serve_observability``
starts the /metrics /healthz /debug/traces listener and registers the
scanner as the dry-run corpus (workload/dryrun.py). With a fleet fabric
attached, a policy refresh that recompiles or drops segments purges the
shared tiers fleet-wide (fleet/fabric.py).

Delta scanning (KTPU_INCREMENTAL, default on): the scanner persists the
verdict matrix between passes, keyed by (resource key) x (policy, rule).
A policy change re-evaluates only the changed segments' rule *columns*
against the memoized flatten rows (assembled as a sub-set over the same
append-only dictionary, so the rows splice unchanged); a resource watch
event re-evaluates only that dirty *row* against the full set. Everything
else is spliced from the persisted matrix, and only the affected
responses re-enter the report pipeline (ReportGenerator's freshest-wins
store merges them). ``KTPU_INCREMENTAL=0`` restores the full-rescan path
exactly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..engine.response import (
    EngineResponse,
    PolicyResponse,
    PolicySpecSummary,
    ResourceSpec,
    RuleResponse,
    RuleStatus,
    RuleType,
)
from ..models import CompiledPolicySet, Verdict
from ..models.engine import resolve_device
from . import tracing
from .reports import ReportGenerator

_VERDICT_TO_STATUS = {
    Verdict.PASS: RuleStatus.PASS,
    Verdict.FAIL: RuleStatus.FAIL,
    Verdict.SKIP: RuleStatus.SKIP,
    Verdict.ERROR: RuleStatus.ERROR,
}


@dataclass
class ScanResult:
    resources_scanned: int = 0
    rules_evaluated: int = 0
    violations: int = 0
    duration_s: float = 0.0
    responses: list[EngineResponse] = field(default_factory=list)
    # delta-pass accounting: what the incremental path actually evaluated
    # (a full pass leaves these at the trivial values)
    delta: bool = False
    cols_evaluated: int = 0
    rows_evaluated: int = 0


class ResourceManager:
    """existing.go:125 ResourceManager: TTL'd dedup of scanned resources."""

    def __init__(self, ttl_s: float = 3600.0):
        self.ttl_s = ttl_s
        self._seen: dict[str, float] = {}

    def process_resource(self, policy: str, kind: str, namespace: str,
                         name: str, rv: str) -> bool:
        key = f"{policy}/{kind}/{namespace}/{name}/{rv}"
        now = time.monotonic()
        stamp = self._seen.get(key)
        if stamp is not None and now - stamp < self.ttl_s:
            return False
        self._seen[key] = now
        return True

    def drop(self) -> None:
        self._seen.clear()


class BackgroundScanner:
    """PolicyController's scan half (policy_controller.go:119 + existing.go)."""

    def __init__(self, policies: list, client=None,
                 report_gen: ReportGenerator | None = None, mesh=None,
                 device=None):
        self.client = client
        self.report_gen = report_gen
        if mesh is None:
            # mesh selection plumbing: KTPU_MESH_SHAPE picks the scan
            # geometry for callers that don't pass a mesh explicitly;
            # unset (the default) keeps the single-device path. The mesh
            # spans every card, or the one CPU device asked for.
            from . import featureplane

            if featureplane.raw("KTPU_MESH_SHAPE").strip():
                from ..parallel.mesh import mesh_from_env

                mesh = mesh_from_env(
                    None if device is None else [device])
        self.mesh = mesh
        # every compiled set lives on the mesh's first device, or on
        # ``device``
        self.device = resolve_device(
            mesh.devices.reshape(-1)[0] if mesh is not None else device)
        self.resource_manager = ResourceManager()
        from ..models.compiler import incremental_enabled
        self._inc = None
        if incremental_enabled():
            from ..models.engine import IncrementalCompiler

            self._inc = IncrementalCompiler(device=self.device)
        # 2D (policy, data) mesh: the policy-axis decomposition lives
        # here and refreshes with the population (models/engine)
        self._sharded = None
        # persisted scan state between passes (delta scanning): row keys
        # in scan order, resource bodies, flatten-row memos, and the
        # verdict matrix as per-(policy, rule) columns — column keying
        # survives rule-axis relayout across policy churn
        self._state: dict | None = None
        self._events: list[tuple[str, dict]] = []
        self.delta_stats = {"full_scans": 0, "delta_scans": 0,
                            "cols_evaluated": 0, "rows_evaluated": 0}
        self._obs = None
        # fleet fabric client (fleet/fabric.attach_stack); a policy
        # refresh that recompiles or drops segments purges the shared
        # tiers fleet-wide
        self._fabric = None
        self._apply_policies(policies)

    def serve_observability(self, host: str = "127.0.0.1",
                            port: int = 9464):
        """Start the standalone /metrics /healthz /debug/traces
        listener (runtime/obs_http.ObservabilityServer) — scanner-only
        processes have no webhook port to scrape. Port 0 picks a free
        port (read it back from the returned server's ``server_port``).
        Idempotent per scanner."""
        if self._obs is None:
            from .obs_http import ObservabilityServer
            from ..workload.dryrun import set_scan_source

            # a scanner exposing an obs port is the natural dry-run
            # corpus: POST /debug/dryrun evaluates against its state
            set_scan_source(self)
            self._obs = ObservabilityServer(host=host, port=port)
            self._obs.start()
        return self._obs

    def stop_observability(self) -> None:
        if self._obs is not None:
            self._obs.stop()
            self._obs = None

    # -------------------------------------------------------- policy feed

    def _apply_policies(self, policies: list) -> dict:
        self.policies = [p for p in policies if p.spec.background]
        if self._mesh_is_2d():
            from ..models.engine import ShardedPolicySet
            from ..parallel.mesh import policy_axis_size

            if self._sharded is None:
                # reuse the scanner's IncrementalCompiler so the full
                # set and the shard slices share one segment cache
                self._sharded = ShardedPolicySet(
                    policy_axis_size(self.mesh), compiler=self._inc,
                    device=self.device)
            self._sharded.refresh(self.policies)
            self.cps = self._sharded.full
            info = dict(self._sharded.compiler.last_refresh)
            info["shards"] = dict(self._sharded.last_refresh)
            return info
        if self._inc is not None:
            self.cps = self._inc.refresh(self.policies)
            return self._inc.last_refresh
        self.cps = CompiledPolicySet(self.policies, device=self.device)
        return {}

    def _mesh_is_2d(self) -> bool:
        if self.mesh is None:
            return False
        from ..parallel.mesh import is_2d

        return is_2d(self.mesh)

    def update_policies(self, policies: list) -> dict:
        """Replace the scanned policy set. With incremental compilation
        only segments whose policy object changed recompile; the refresh
        summary (recompiled/dropped keys) seeds the next delta pass —
        and, with a fabric attached, drives fleet-wide invalidation of
        the shared tiers (a pure-reuse refresh purges nothing)."""
        refresh = self._apply_policies(policies)
        if self._fabric is not None:
            from ..fleet import fabric as fabric_mod

            fabric_mod.publish_refresh(self._fabric, refresh)
        return refresh

    def note_resource(self, event: str, resource: dict) -> None:
        """Resource watch feed: the row goes dirty for the next delta
        pass (DELETED rows are dropped from the matrix)."""
        self._events.append((event, resource))

    @staticmethod
    def _res_key(resource: dict) -> tuple:
        meta = resource.get("metadata") or {}
        return (resource.get("kind", ""), meta.get("namespace", ""),
                meta.get("name", ""))

    def kinds(self) -> list[str]:
        out: list[str] = []
        for ir in self.cps.rule_irs:
            for kind in ir.kinds:
                bare = kind.split("/")[-1]
                if bare not in out:
                    out.append(bare)
        return out

    def snapshot(self) -> list[dict]:
        """getResourcesPerNamespace via the client (existing.go:214)."""
        if self.client is None:
            return []
        resources = []
        for kind in self.kinds():
            if kind == "*":
                continue
            resources.extend(self.client.list_resource("", kind))
        return resources

    # --------------------------------------------------------- full scan

    def scan(self, resources: list[dict] | None = None) -> ScanResult:
        rec = tracing.recorder()
        tr = rec.start("scan")
        tok = tracing.bind(tr) if tr is not None else None
        try:
            return self._scan(resources, rec, tr)
        finally:
            if tok is not None:
                tracing.unbind(tok)
            rec.finish(tr)

    def _scan(self, resources, rec, tr) -> ScanResult:
        start = time.monotonic()
        resources = resources if resources is not None else self.snapshot()
        if tr is not None:
            tr.labels["resources"] = len(resources)
        result = ScanResult(resources_scanned=len(resources))
        self.delta_stats["full_scans"] += 1
        # a full pass supersedes any pending row dirt
        self._events.clear()
        if not resources:
            if self._inc is not None and self.mesh is None:
                self._state = {"keys": [], "resources": {}, "memos": {},
                               "cols": {}}
            return result

        memos = None
        e0 = time.perf_counter()
        if self.mesh is not None:
            from ..parallel.mesh import sharded_scan

            # a 2D mesh scans the policy-axis decomposition (per-shard
            # tensors); the 1D mesh keeps the replicated full set
            src = self._sharded if self._sharded is not None else self.cps
            verdicts, _, _ = sharded_scan(src, resources, self.mesh)
            scan_lane = "mesh"
        elif self._inc is not None:
            # flatten chunk-wise and keep the split rows: the same single
            # flatten both scores this pass and seeds the delta state
            verdicts, memos = self._scan_rows(resources)
            scan_lane = "incremental"
        else:
            from ..models.flatten import pipeline_enabled
            from ..parallel import mesh as mesh_mod

            chunk = mesh_mod.DEFAULT_CHUNK
            if len(resources) <= chunk:
                verdicts = self.cps.evaluate(resources)
                scan_lane = "single"
            elif pipeline_enabled():
                # scan-chunk prefetch: flatten chunk k+1 while the device
                # scores chunk k (KTPU_FLATTEN_PIPELINE=0 falls back to
                # the serial chunk loop below)
                verdicts = self.cps.evaluate_pipelined(resources, chunk=chunk)
                scan_lane = "pipelined"
            else:
                # chunk huge snapshots so flatten memory stays bounded
                verdicts = np.concatenate([
                    self.cps.evaluate(resources[i:i + chunk])
                    for i in range(0, len(resources), chunk)])
                scan_lane = "serial_chunks"
        rec.add_span(tr, "scan_evaluate", e0, time.perf_counter(),
                     lane=scan_lane, rows=len(resources))

        r0 = time.perf_counter()
        for b, resource in enumerate(resources):
            per_policy = self._row_responses(
                resource, lambda ref, b=b: verdicts[b, ref.rule_index],
                self.cps.rule_refs, result)
            result.responses.extend(per_policy.values())
        rec.add_span(tr, "scan_responses", r0, time.perf_counter(),
                     violations=result.violations)

        if memos is not None:
            keys = [self._res_key(r) for r in resources]
            self._state = {
                "keys": keys,
                "resources": dict(zip(keys, resources)),
                "memos": memos,
                "cols": {(ref.policy.name, ref.rule.name):
                         np.asarray(verdicts)[:, ref.rule_index].astype(
                             np.int8)
                         for ref in self.cps.rule_refs},
            }

        if self.report_gen is not None:
            self.report_gen.add(*result.responses)
        result.duration_s = time.monotonic() - start
        return result

    def _scan_rows(self, resources: list[dict]):
        """Chunked flatten + device eval that also returns the split
        flatten rows as epoch-stamped memos (one flatten serves both).

        Host-lane cells resolve per chunk — prefetch dispatched before
        the blocking device eval, memoized post-pass after — so the
        incremental scan reports precondition/variable rules exactly
        like the full-scan paths instead of dropping them, and repeat
        scans of unchanged bodies answer from the host-verdict memo."""
        from ..models.flatten import MemoRow, split_packed_rows
        from ..parallel import mesh as mesh_mod
        from .hostlane import resolver

        tensors = self.cps.tensors
        has_host = bool(np.asarray(
            tensors.rule_host_only[:tensors.n_rules_live]).any())
        chunks = []
        memos: dict[tuple, object] = {}
        step = mesh_mod.DEFAULT_CHUNK
        for i in range(0, len(resources), step):
            chunk = resources[i:i + step]
            batch = self.cps.flatten_packed(chunk)
            pf = resolver().prefetch(self.cps, chunk) if has_host else None
            v = np.asarray(self.cps.evaluate_device(batch))
            if pf is not None or (v == int(Verdict.HOST)).any():
                v = self.cps.resolve_host_cells(chunk, v, prefetch=pf)
            chunks.append(v)
            for r, row in zip(chunk, split_packed_rows(batch)):
                memos[self._res_key(r)] = MemoRow(
                    row=row, n_paths=tensors.n_paths,
                    epoch=tensors.dict_epoch)
        return np.concatenate(chunks), memos

    def _row_responses(self, resource: dict, verdict_of, rule_refs,
                       result: ScanResult,
                       policy_filter: set | None = None) -> dict:
        """One resource's per-policy EngineResponses (the response shape
        both the full and the delta pass emit, so report rows merge)."""
        meta = resource.get("metadata") or {}
        per_policy: dict[str, EngineResponse] = {}
        for ref in rule_refs:
            if policy_filter is not None and \
                    ref.policy.name not in policy_filter:
                continue
            verdict = Verdict(verdict_of(ref))
            if verdict is Verdict.NOT_APPLICABLE:
                continue
            status = _VERDICT_TO_STATUS.get(verdict)
            if status is None:
                continue
            result.rules_evaluated += 1
            if status is RuleStatus.FAIL:
                result.violations += 1
            resp = per_policy.get(ref.policy.name)
            if resp is None:
                resp = EngineResponse(policy_response=PolicyResponse(
                    policy=PolicySpecSummary(name=ref.policy.name),
                    resource=ResourceSpec(
                        kind=resource.get("kind", ""),
                        api_version=resource.get("apiVersion", ""),
                        namespace=meta.get("namespace", ""),
                        name=meta.get("name", ""),
                    ),
                ))
                per_policy[ref.policy.name] = resp
            resp.policy_response.rules.append(RuleResponse(
                name=ref.rule.name, type=RuleType.VALIDATION, status=status,
                message=f"validation rule '{ref.rule.name}' "
                        f"{'passed' if status is RuleStatus.PASS else status.value}",
            ))
        return per_policy

    # -------------------------------------------------------- delta scan

    def delta_scan(self, policies: list | None = None) -> ScanResult:
        """Incremental pass: apply any policy update, then re-evaluate
        only (a) the changed/added policies' rule columns against the
        memoized flatten rows and (b) the rows dirtied by resource watch
        events against the full set, splicing both into the persisted
        verdict matrix. Emits responses only for the affected
        (resource, policy) pairs. Falls back to :meth:`scan` when
        incremental compilation is off, under a mesh, or before any full
        pass has seeded the state."""
        refresh = self.update_policies(policies) if policies is not None \
            else {}
        if self._inc is None or self._state is None or \
                self.mesh is not None:
            return self.scan()
        rec = tracing.recorder()
        tr = rec.start("delta_scan")
        tok = tracing.bind(tr) if tr is not None else None
        try:
            result = self._delta_scan_seeded(refresh, rec, tr)
            if tr is not None:
                tr.labels.update(cols=result.cols_evaluated,
                                 rows=result.rows_evaluated)
            return result
        finally:
            if tok is not None:
                tracing.unbind(tok)
            rec.finish(tr)

    def _delta_scan_seeded(self, refresh: dict, rec, tr) -> ScanResult:
        start = time.monotonic()
        state = self._state
        result = ScanResult(delta=True)
        self.delta_stats["delta_scans"] += 1

        current_names = {p.name for p in self.policies}
        new_cols = {(ref.policy.name, ref.rule.name)
                    for ref in self.cps.rule_refs}

        # ---- policy-side dirt: recompiled segments + columns the matrix
        # has never seen (fresh policies, first delta after fallback)
        changed_keys = set(refresh.get("recompiled_keys", []))
        changed_policies = []
        for p in self.policies:
            key = self._inc._policy_key(p)
            missing = any(ck not in state["cols"] for ck in new_cols
                          if ck[0] == p.name)
            if key in changed_keys or missing:
                changed_policies.append(p)
        changed_names = {p.name for p in changed_policies}

        # ---- resource-side dirt: consume watch events
        events, self._events = self._events, []
        dirty: list[tuple] = []
        for event, resource in events:
            key = self._res_key(resource)
            if event == "DELETED":
                if key in state["resources"]:
                    idx = state["keys"].index(key)
                    state["keys"].pop(idx)
                    state["resources"].pop(key, None)
                    state["memos"].pop(key, None)
                    for ck in state["cols"]:
                        state["cols"][ck] = np.delete(state["cols"][ck],
                                                      idx)
                    if self.report_gen is not None:
                        self.report_gen.prune_resource(key[0], key[1],
                                                       key[2])
                if key in dirty:
                    dirty.remove(key)
                continue
            if key not in state["resources"]:
                state["keys"].append(key)
                for ck in state["cols"]:
                    state["cols"][ck] = np.append(
                        state["cols"][ck],
                        np.int8(Verdict.NOT_APPLICABLE))
            state["resources"][key] = resource
            # content changed: the memo row is for the old body
            state["memos"].pop(key, None)
            if key not in dirty:
                dirty.append(key)

        # ---- column pass: changed policies x all memoized rows, over a
        # sub-set assembled from the same dictionary (rows splice as-is)
        if changed_policies and state["keys"]:
            from ..models.flatten import (MemoRow, flatten_one_row,
                                          refresh_packed_row,
                                          splice_packed_rows)

            c0 = time.perf_counter()
            sub = self._inc.subset(changed_policies)
            rows = []
            for key in state["keys"]:
                resource = state["resources"][key]
                memo = state["memos"].get(key)
                refreshed = None
                if memo is not None:
                    refreshed, _ = refresh_packed_row(memo, resource,
                                                      sub.tensors)
                if refreshed is None:
                    refreshed = MemoRow(
                        row=flatten_one_row(resource, sub.tensors),
                        n_paths=sub.tensors.n_paths,
                        epoch=sub.tensors.dict_epoch)
                state["memos"][key] = refreshed
                rows.append(refreshed.row)
            v = np.asarray(sub.evaluate_device(splice_packed_rows(rows)))
            if (v == int(Verdict.HOST)).any():
                # column-pass host cells: resolved (memoized) before the
                # verdicts persist, so the delta matrix stays comparable
                # with the full-scan matrix bit for bit
                bodies = [state["resources"][k] for k in state["keys"]]
                v = sub.resolve_host_cells(bodies, v)
            for ref in sub.rule_refs:
                state["cols"][(ref.policy.name, ref.rule.name)] = \
                    v[:, ref.rule_index].astype(np.int8)
                result.cols_evaluated += 1
            rec.add_span(tr, "column_pass", c0, time.perf_counter(),
                         cols=result.cols_evaluated,
                         policies=len(changed_policies))

        # ---- drop columns of removed policies / removed rules
        for ck in list(state["cols"]):
            if ck in new_cols:
                continue
            if ck[0] not in current_names or ck[0] in changed_names:
                del state["cols"][ck]
        for key in refresh.get("dropped_keys", []):
            if self.report_gen is not None:
                self.report_gen.prune_policy(key.split("/")[-1])

        # ---- row pass: dirty resources x the full set
        dirty = [k for k in dirty if k in state["resources"]]
        if dirty:
            from ..models.flatten import MemoRow, split_packed_rows

            w0 = time.perf_counter()
            tensors = self.cps.tensors
            bodies = [state["resources"][k] for k in dirty]
            batch = self.cps.flatten_packed(bodies)
            v = np.asarray(self.cps.evaluate_device(batch))
            if (v == int(Verdict.HOST)).any():
                v = self.cps.resolve_host_cells(bodies, v)
            split = split_packed_rows(batch)
            for j, key in enumerate(dirty):
                idx = state["keys"].index(key)
                for ref in self.cps.rule_refs:
                    state["cols"][(ref.policy.name, ref.rule.name)][idx] = \
                        np.int8(v[j, ref.rule_index])
                state["memos"][key] = MemoRow(
                    row=split[j], n_paths=tensors.n_paths,
                    epoch=tensors.dict_epoch)
                result.rows_evaluated += 1
            rec.add_span(tr, "row_pass", w0, time.perf_counter(),
                         rows=result.rows_evaluated)

        # ---- emit only the affected (resource, policy) responses; the
        # report store's freshest-wins merge keeps everything else
        dirty_set = set(dirty)
        refs = self.cps.rule_refs
        for key in state["keys"]:
            names = (current_names if key in dirty_set
                     else changed_names)
            if not names:
                continue
            idx = state["keys"].index(key)
            per_policy = self._row_responses(
                state["resources"][key],
                lambda ref, idx=idx: state["cols"][
                    (ref.policy.name, ref.rule.name)][idx],
                refs, result, policy_filter=names)
            result.responses.extend(per_policy.values())

        result.resources_scanned = len(state["keys"])
        self.delta_stats["cols_evaluated"] += result.cols_evaluated
        self.delta_stats["rows_evaluated"] += result.rows_evaluated
        if self.report_gen is not None:
            self.report_gen.add(*result.responses)
        result.duration_s = time.monotonic() - start
        return result

    def state_fingerprint(self) -> str:
        """Digest of the persisted scan state: row keys in order, body
        digests, every verdict column byte-for-byte, pending events and
        the segment-cache keys of the incremental compiler. A dry-run
        (isolated candidate compile + copy-resolved evaluation) must
        leave this identical — the quiescent probe in replay_smoke
        asserts exactly that."""
        import hashlib
        import json as _json

        h = hashlib.sha256()
        if self._state is not None:
            state = self._state
            for key in state["keys"]:
                h.update(repr(key).encode())
                body = state["resources"].get(key)
                h.update(hashlib.sha256(
                    _json.dumps(body, sort_keys=True,
                                default=str).encode()).digest())
            for ck in sorted(state["cols"]):
                h.update(repr(ck).encode())
                h.update(np.ascontiguousarray(state["cols"][ck]).tobytes())
        h.update(str(len(self._events)).encode())
        if self._inc is not None:
            h.update(repr(sorted(self._inc._segments)).encode())
        return h.hexdigest()[:16]

    def verdict_matrix(self):
        """(row keys, column keys, matrix) snapshot of the persisted scan
        state — the parity surface the delta-vs-full property tests
        compare bit-for-bit. None before any full pass."""
        if self._state is None:
            return None
        state = self._state
        ckeys = sorted(state["cols"])
        n = len(state["keys"])
        if ckeys:
            mat = np.stack([state["cols"][c] for c in ckeys], axis=1)
        else:
            mat = np.zeros((n, 0), dtype=np.int8)
        return list(state["keys"]), ckeys, mat
