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
    _S("KTPU_DONATE", "kyverno_tpu_torch.models.engine",
       "tests/test_torch_admission.py", "1",
       "K6: pinned staging and a persistent device blob per shape bucket "
       "on the stable-shape device call"),
    # -- mesh plane (2D policy x data sharding)
    _S("KTPU_MESH_SHAPE", "kyverno_tpu_torch.parallel.mesh",
       "tests/test_torch_mesh.py", "",
       "mesh geometry: unset = 1D data mesh, 'PxD' = 2D policy x data, "
       "'auto' = factor the device count, '1d' = force 1D"),
    # -- observability plane
    _S("KTPU_TRACE", "kyverno_tpu_torch.runtime.tracing",
       "tests/test_torch_pipeline.py", "1",
       "span recorder"),
)}


def raw(name: str) -> str:
    """Dynamic env read of a *declared* switch; the registry default
    applies when the variable is unset."""
    spec = REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"undeclared feature switch {name!r}; declare it "
                       "in runtime/featureplane.py")
    return os.environ.get(name, spec.default)


def enabled(name: str) -> bool:
    """The kill-switch convention: anything but "0" is on."""
    return raw(name) != "0"


def enabled_strict(name: str) -> bool:
    """The stricter convention (KTPU_INCREMENTAL): "0", "false" and the
    empty string all disable."""
    return raw(name) not in ("0", "false", "")


def int_value(name: str) -> int:
    return int(raw(name))
