"""Static analysis over compiled policy IR and tensors.

Three passes (see ANALYSIS.md for the code catalog):

- escalation provenance (KT1xx): why rules leave the device lattice
- reachability/conflict (KT2xx): dead rules, shadowed anyPattern
  branches, constant deny conditions
- tensor invariants (KT3xx): PolicyTensors / FlatBatch index, dtype,
  and padding contracts
- cross-layer certification (KT4xx): the compiled tensor program vs
  the host IR walk over an abstract resource domain (certify.py),
  grounded by the differential fuzz harness (difffuzz.py)
- feature-lane lint (KT5xx): every KTPU_* switch read declared in the
  runtime/featureplane.py registry (featurelint.py)

Entry points: ``analyze_policies`` (policy objects -> AnalysisReport),
``lint_batch`` (FlatBatch invariants), ``certify_policies`` /
``certify_tensors`` (KT4xx), ``scan_tree`` (KT5xx), and the
``kyverno-tpu lint`` CLI (``--certify`` for the KT4xx pass).
"""

from .analyzer import analyze_policies, lint_batch
from .certify import CertifyResult, certify_policies, certify_tensors
from .diagnostics import (
    CODES,
    AnalysisReport,
    Diagnostic,
    Severity,
    parse_suppressions,
)
from .featurelint import scan_tree
from .invariants import (
    check_batch,
    check_padded,
    check_policy_shards,
    check_tensors,
)

__all__ = [
    "CODES",
    "AnalysisReport",
    "CertifyResult",
    "Diagnostic",
    "Severity",
    "analyze_policies",
    "certify_policies",
    "certify_tensors",
    "check_batch",
    "check_padded",
    "check_policy_shards",
    "check_tensors",
    "lint_batch",
    "parse_suppressions",
    "scan_tree",
]
