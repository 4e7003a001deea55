"""The policy engine on the host: anchors and the leaf and condition
operators the compiler needs, and the CPU oracle, pure functions of
(policy, resource, context) -> response (``validation.validate`` over
``match``, ``context``, ``variables``, ``jmespath`` and
``validate_pattern``). The device path (``kyverno_tpu_torch.models`` +
``kyverno_tpu_torch.ops``) compiles the same semantics into CUDA kernels;
the oracle resolves the cells it reports HOST."""

from .response import EngineResponse, RuleResponse, RuleStatus, RuleType

__all__ = ["EngineResponse", "RuleResponse", "RuleStatus", "RuleType"]
