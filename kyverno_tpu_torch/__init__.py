"""kyverno-tpu on PyTorch and CUDA: the policy engine's device path on an
NVIDIA H100, beside the JAX package it was ported from.

Layer map:
  - ``kyverno_tpu_torch.api``     policy CRD types + loaders
  - ``kyverno_tpu_torch.engine``  anchors, leaf and condition operators,
                                  and the CPU oracle (``validation``,
                                  ``match``, ``context``, ``variables``,
                                  ``jmespath``) that resolves HOST cells;
                                  the mutate, generate (``generation``)
                                  and verifyImages engines
                                  (``image_verify``, ``registry_verify``
                                  over a registry's HTTP API,
                                  ``certchain`` for keyless chains)
  - ``kyverno_tpu_torch.policy``  what the policy webhook does to a
                                  policy: ``autogen`` (pod-controller
                                  rules), ``validation``, the OpenAPI
                                  schemas (``openapi``) and their CRD sync
                                  (``crd_sync``)
  - ``kyverno_tpu_torch.store``   mock values for rules' ``context:``
                                  entries (offline runs)
  - ``kyverno_tpu_torch.models``  policy IR, compiler, flatteners (Python,
                                  and the native one built from
                                  ``csrc/ktpu_flatten.cpp``), engine
                                  (``CompiledPolicySet.evaluate`` and
                                  ``evaluate_pipelined``: device verdicts,
                                  then the host lane)
  - ``kyverno_tpu_torch.runtime`` ``KTPU_*`` switches, span recorder, the
                                  host lane (prefetch, verdict memo,
                                  fan-out) that resolves HOST cells, the
                                  admission batcher and policy cache, the
                                  background scanner and the reports
  - ``kyverno_tpu_torch.parallel`` the device mesh and K7, the sharded
                                  scan (``sharded_scan``)
  - ``kyverno_tpu_torch.ops``     CUDA kernels (glob NFA, check evaluation,
                                  verdict reduction, scan counts, per-rule
                                  counts), each beside its plain PyTorch
                                  version
  - ``kyverno_tpu_torch.utils``   wildcards, quantities, durations and a
                                  self-contained P-256 ECDSA (``ecdsa``)
  - ``kyverno_tpu_torch.convert`` carry compiled state from numpy
"""

__version__ = "0.1.0"

# the entry points, loaded on first use: importing the package loads no
# torch (an oracle-pool worker imports it)
_EXPORTS = {
    "CompiledPolicySet": "models.engine",
    "ShardedPolicySet": "models.engine",
    "BackgroundScanner": "runtime.background",
    "ReportGenerator": "runtime.reports",
    "make_mesh": "parallel.mesh",
    "sharded_scan": "parallel.mesh",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f"{__name__}.{module}"), name)
