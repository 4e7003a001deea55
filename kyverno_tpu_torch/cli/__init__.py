"""kubectl-kyverno style CLI: apply, test, validate.

Mirrors kyverno/pkg/kyverno (cobra CLI; verbs at main.go:27-30).
Run as ``python -m kyverno_tpu_torch.cli <verb> ...``.
"""
