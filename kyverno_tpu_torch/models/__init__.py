"""Policy IR + compiler: policy documents -> flat pattern tensors, the
flattener that packs resources into one blob, and the engine facade that
scores blobs on the card."""

from .engine import CompiledPolicySet, Verdict

__all__ = ["CompiledPolicySet", "Verdict"]
