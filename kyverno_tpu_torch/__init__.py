"""kyverno-tpu on PyTorch and CUDA: the policy engine's device path on an
NVIDIA H100, beside the JAX package it was ported from.

Layer map:
  - ``kyverno_tpu_torch.api``     policy CRD types + loaders
  - ``kyverno_tpu_torch.engine``  anchors, leaf and condition operators,
                                  and the CPU oracle (``validation``,
                                  ``match``, ``context``, ``variables``,
                                  ``jmespath``) that resolves HOST cells
  - ``kyverno_tpu_torch.store``   mock values for rules' ``context:``
                                  entries (offline runs)
  - ``kyverno_tpu_torch.models``  policy IR, compiler, flatteners (Python,
                                  and the native one built from
                                  ``csrc/ktpu_flatten.cpp``), engine
                                  (``CompiledPolicySet.evaluate`` and
                                  ``evaluate_pipelined``: device verdicts,
                                  then the host lane)
  - ``kyverno_tpu_torch.runtime`` ``KTPU_*`` switches, span recorder, and
                                  the host lane (prefetch, verdict memo,
                                  fan-out) that resolves HOST cells
  - ``kyverno_tpu_torch.ops``     CUDA kernels (glob NFA, check evaluation,
                                  verdict reduction, scan counts), each
                                  beside its plain PyTorch version
  - ``kyverno_tpu_torch.convert`` carry compiled state from numpy
"""

__version__ = "0.1.0"
