"""Feature-lane registry: the single source of truth for KTPU_* switches.

Every runtime kill switch / tuning knob the engine reads from the
environment is declared here with an owning module and a named parity
gate (the test battery that proves both positions of the switch produce
identical verdicts). The names and defaults are the JAX package's; this
registry holds the switches the port reads so far.

Reads stay *dynamic* (per call, not cached): flipping a switch
mid-process takes effect at the next use.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Switch:
    name: str       # KTPU_* environment variable
    owner: str      # module whose behavior the switch controls
    gate: str       # named parity gate proving both switch positions
    default: str    # value when the variable is unset
    doc: str        # one-line description


_S = Switch

REGISTRY: dict[str, Switch] = {s.name: s for s in (
    # -- compile plane
    _S("KTPU_INCREMENTAL", "kyverno_tpu_torch.models.compiler",
       "tests/test_torch_incremental.py", "1",
       "segment splicing, epoch-keyed memo survival, rule bucketing"),
    _S("KTPU_CERTIFY", "kyverno_tpu_torch.models.engine",
       "tests/test_torch_analysis.py", "1",
       "KT4xx cross-layer certification of spliced segments on refresh"),
    # -- flatten plane
    _S("KTPU_NATIVE", "kyverno_tpu_torch.models.native_flatten",
       "tests/test_torch_native_flatten.py", "1",
       "C++ flattener (the Python flattener when off)"),
    _S("KTPU_FLATTEN_WORKERS", "kyverno_tpu_torch.models.native_flatten",
       "tests/test_torch_native_flatten.py", "0",
       "native flatten worker threads (0 = min(4, cores))"),
    _S("KTPU_FLATTEN_PIPELINE", "kyverno_tpu_torch.models.flatten",
       "tests/test_torch_pipeline.py", "1",
       "overlapped flatten/dispatch pipeline of evaluate_pipelined"),
    # -- host lane
    _S("KTPU_HOST_PREFETCH", "kyverno_tpu_torch.runtime.hostlane",
       "tests/test_torch_hostlane.py", "1",
       "predictive host-verdict prefetch at device dispatch time"),
    _S("KTPU_HOST_MEMO", "kyverno_tpu_torch.runtime.hostlane",
       "tests/test_torch_hostlane.py", "1",
       "content-addressed host verdict memoization"),
    _S("KTPU_HOST_FANOUT", "kyverno_tpu_torch.runtime.hostlane",
       "tests/test_torch_hostlane.py", "1",
       "thread fan-out for multi-resource host resolution"),
    # -- streaming plane
    _S("KTPU_STREAM", "kyverno_tpu_torch.runtime.batch",
       "tests/test_torch_admission.py", "1",
       "continuous batching admission lane"),
    _S("KTPU_STREAM_TRANSPORT", "kyverno_tpu_torch.runtime.stream_server",
       "tests/test_torch_stream.py", "auto",
       "stream transport selection (grpc|socket|auto)"),
    _S("KTPU_DONATE", "kyverno_tpu_torch.models.engine",
       "tests/test_torch_admission.py", "1",
       "K6: pinned staging and a persistent device blob per shape bucket "
       "on the stable-shape device call"),
    # -- mesh plane (2D policy x data sharding)
    _S("KTPU_MESH_SHAPE", "kyverno_tpu_torch.parallel.mesh",
       "tests/test_torch_mesh.py", "",
       "mesh geometry: unset = 1D data mesh, 'PxD' = 2D policy x data, "
       "'auto' = factor the device count, '1d' = force 1D"),
    # -- fleet plane (multi-replica verdict fabric + partitioned scan)
    _S("KTPU_FABRIC", "kyverno_tpu_torch.fleet.fabric",
       "tests/test_torch_fleet.py", "0",
       "master switch for the fleet verdict fabric (off = attached "
       "fabric ignored; single-replica decisions bit-for-bit)"),
    _S("KTPU_FABRIC_TRANSPORT", "kyverno_tpu_torch.fleet.fabric",
       "tests/test_torch_fleet.py", "inproc",
       "fabric transport selection (inproc|socket); parity held both "
       "ways by the fleet tests and chip_smoke's [fleet]"),
    _S("KTPU_SCAN_PARTITIONS", "kyverno_tpu_torch.fleet.scanparts",
       "tests/test_torch_fleet.py", "0",
       "namespace-hash scan partition count (0 = unpartitioned scan; "
       "parity gate: merged range digests == unpartitioned digest)"),
    # -- workload plane (trace replay + rollout dry-run)
    _S("KTPU_REPLAY", "kyverno_tpu_torch.workload.replay",
       "tests/test_torch_workload.py", "1",
       "audit-trace replay injection (webhook/stream/background legs)"),
    _S("KTPU_DRYRUN", "kyverno_tpu_torch.workload.dryrun",
       "tests/test_torch_workload.py", "1",
       "policy-rollout dry-run service (POST /debug/dryrun, CLI)"),
    # -- observability plane
    _S("KTPU_TRACE", "kyverno_tpu_torch.runtime.tracing",
       "tests/test_torch_pipeline.py", "1",
       "span recorder"),
    _S("KTPU_PROPAGATE", "kyverno_tpu_torch.runtime.tracing",
       "tests/test_torch_planes.py", "1",
       "cross-process trace-context propagation"),
    _S("KTPU_ATTRIB", "kyverno_tpu_torch.runtime.tracing",
       "tests/test_torch_planes.py", "1",
       "per-policy attribution metrics"),
    _S("KTPU_ATTRIB_TOP_K", "kyverno_tpu_torch.runtime.metrics",
       "tests/test_torch_planes.py", "64",
       "distinct (policy, rule) series before attribution overflow"),
    _S("KTPU_SLO", "kyverno_tpu_torch.runtime.slo",
       "tests/test_torch_planes.py", "1",
       "SLO burn-rate watchdog (observation only)"),
    _S("KTPU_SLO_BUDGET_S", "kyverno_tpu_torch.runtime.slo",
       "tests/test_torch_planes.py", "10.0",
       "admission deadline budget in seconds"),
    _S("KTPU_SLO_WINDOW_SHORT_S", "kyverno_tpu_torch.runtime.slo",
       "tests/test_torch_planes.py", "60",
       "short burn window in seconds"),
    _S("KTPU_SLO_WINDOW_LONG_S", "kyverno_tpu_torch.runtime.slo",
       "tests/test_torch_planes.py", "600",
       "long burn window in seconds"),
    _S("KTPU_SLO_BURN_DEGRADED", "kyverno_tpu_torch.runtime.slo",
       "tests/test_torch_planes.py", "1.0",
       "burn-rate threshold for the degraded state"),
    _S("KTPU_SLO_MIN_SAMPLES", "kyverno_tpu_torch.runtime.slo",
       "tests/test_torch_planes.py", "8",
       "samples before a burn window votes"),
    _S("KTPU_PROFILE_PORT", "kyverno_tpu_torch.runtime.profiling",
       "tests/test_torch_stream.py", "0",
       "on-demand profiler listener port (0 = disabled)"),
    # -- webhook config
    _S("KTPU_WEBHOOK_TIMEOUT_S", "kyverno_tpu_torch.runtime.webhookconfig",
       "tests/test_torch_server.py", "",
       "webhook timeoutSeconds override"),
    _S("KTPU_DEFAULT_FAILURE_POLICY",
       "kyverno_tpu_torch.runtime.webhookconfig",
       "tests/test_torch_server.py", "",
       "failurePolicy when policies don't pin one"),
    # -- SLO degradation plane (closed-loop actions; annotate-only when
    #    the master switch is off)
    _S("KTPU_SLO_ACTIONS", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "0",
       "master switch for closed-loop SLO degradation actions"),
    _S("KTPU_SLO_SHED", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "1",
       "shed low-severity enforce policies while degraded"),
    _S("KTPU_SLO_SHED_MAX", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "1",
       "max policies in the shed set"),
    _S("KTPU_SLO_GEOMETRY", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "1",
       "latency-optimized batcher geometry profile while degraded"),
    _S("KTPU_SLO_WINDOW_FACTOR", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "0.25",
       "coalescing/late-join window multiplier under the geometry action"),
    _S("KTPU_SLO_PAD_FLOOR", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "8",
       "admission pad floor under the geometry action"),
    _S("KTPU_SLO_HOSTBOUND", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "1",
       "bound host-lane fan-out + guard OraclePool submissions"),
    _S("KTPU_SLO_FANOUT_MAX", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "2",
       "host-lane fan-out cap while the hostbound action is engaged"),
    _S("KTPU_SLO_POOL_TIMEOUT_S", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "0.5",
       "OraclePool submission timeout while degraded"),
    _S("KTPU_SLO_POOL_RETRIES", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "1",
       "bounded retries for a missed guarded pool submission"),
    _S("KTPU_SLO_BREAKER_THRESHOLD", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "3",
       "consecutive pool failures before the circuit opens"),
    _S("KTPU_SLO_BREAKER_COOLDOWN_S", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "5.0",
       "open-circuit cooldown before a half-open probe"),
    _S("KTPU_SLO_SCALE_HINTS", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "1",
       "emit replica scale hints on /healthz while degraded"),
    _S("KTPU_SLO_DEGRADE_AFTER_S", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "0.5",
       "sustained degraded signal before the controller degrades"),
    _S("KTPU_SLO_RECOVER_AFTER_S", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "3.0",
       "sustained healthy signal before the controller recovers"),
    _S("KTPU_SLO_MIN_DWELL_S", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "1.0",
       "minimum dwell in either state (flap suppression)"),
    _S("KTPU_SLO_TICK_S", "kyverno_tpu_torch.runtime.sloactions",
       "tests/test_torch_planes.py", "0.25",
       "controller tick period / rate limit for maybe_tick"),
)}


def raw(name: str) -> str:
    """Dynamic env read of a *declared* switch; the registry default
    applies when the variable is unset."""
    spec = REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"undeclared feature switch {name!r}; declare it "
                       "in runtime/featureplane.py")
    return os.environ.get(name, spec.default)


def is_set(name: str) -> bool:
    """Whether the switch is explicitly present in the environment."""
    if name not in REGISTRY:
        raise KeyError(f"undeclared feature switch {name!r}")
    return name in os.environ


def enabled(name: str) -> bool:
    """The kill-switch convention: anything but "0" is on."""
    return raw(name) != "0"


def enabled_strict(name: str) -> bool:
    """The stricter convention (KTPU_INCREMENTAL): "0", "false" and the
    empty string all disable."""
    return raw(name) not in ("0", "false", "")


def int_value(name: str) -> int:
    return int(raw(name))


def float_value(name: str) -> float:
    return float(raw(name))
