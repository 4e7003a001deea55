"""Workload plane: audit-trace replay harness + rollout dry-run.

Three parts:

``trace``
    Compact JSONL audit-trace schema (op/timestamp/namespace/body-digest
    with a body store deduplicating repeated bodies), a parameterized
    churn synthesizer (storms, Zipf namespace skew, repeated-body
    distributions, interleaved policy churn), and an importer that
    converts the flight-ring's recorded admission traffic into the same
    format.
``replay``
    Arrival-time-faithful / max-speed player feeding a trace through
    the webhook, stream (JSON/ROW/BLOCK) and background-scan legs with
    per-leg verdict/latency/queue-depth capture and a persisted run
    manifest for A/B diffing across changes. Gated on KTPU_REPLAY.
``dryrun``
    Rollout dry-run service: compiles a candidate policy as an isolated
    segment, evaluates it against the persisted scan corpus without
    touching live decisions, and reports the blast radius. Gated on
    KTPU_DRYRUN; served at POST /debug/dryrun and ``kyverno-tpu dryrun``.
"""

from .trace import (TRACE_SCHEMA_VERSION, TraceEvent, WorkloadTrace,
                    body_digest, import_flight_ring, synthesize)
from .replay import (MANIFEST_SCHEMA_VERSION, ReplayDisabled, ReplayDriver,
                     build_stack, diff_manifests, run_manifest)
from .dryrun import (DRYRUN_SCHEMA_VERSION, DryRunDisabled, dry_run,
                     scan_source, set_scan_source)

__all__ = [
    "TRACE_SCHEMA_VERSION", "TraceEvent", "WorkloadTrace", "body_digest",
    "import_flight_ring", "synthesize",
    "MANIFEST_SCHEMA_VERSION", "ReplayDisabled", "ReplayDriver",
    "build_stack", "diff_manifests", "run_manifest",
    "DRYRUN_SCHEMA_VERSION", "DryRunDisabled", "dry_run", "scan_source",
    "set_scan_source",
]
