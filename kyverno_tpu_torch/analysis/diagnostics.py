"""Diagnostic model for the policy IR static analyzer.

Every finding the analyzer emits is a ``Diagnostic`` with a *stable* code
from the ``CODES`` registry. Codes are grouped by pass:

- ``KT1xx`` escalation provenance (which constructs force HOST)
- ``KT2xx`` reachability / conflict (dead rules, shadowed branches,
  constant-folded deny conditions)
- ``KT3xx`` tensor invariants (PolicyTensors / FlatBatch geometry,
  dtypes, index bounds)
- ``KT4xx`` cross-layer certification (compiled tensor semantics vs the
  host IR walk over a shared abstract resource domain)
- ``KT5xx`` feature-lane lint (every KTPU_* switch declared in the
  runtime/featureplane.py registry, no bypassing env reads)

Severities order INFO < WARNING < ERROR; the CI gate
(deploy/ci_lint.sh) fails on ERROR. Suppression: the policy annotation
``kyverno-tpu.io/lint-suppress: "KT202,KT110"`` or the CLI ``--suppress``
flag drops matching codes (documented in ANALYSIS.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum


class Severity(IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2


# code -> (default severity, short title). The code set is append-only:
# golden tests and external tooling key off these strings.
CODES: dict[str, tuple[Severity, str]] = {
    # -- escalation provenance
    "KT101": (Severity.INFO, "rule compiles host-only"),
    "KT102": (Severity.WARNING, "policy fully host-only"),
    "KT110": (Severity.INFO, "per-policy device decidability"),
    # -- reachability / conflict
    "KT201": (Severity.ERROR, "rule statically unreachable"),
    "KT202": (Severity.WARNING, "anyPattern branch shadowed"),
    "KT203": (Severity.WARNING, "deny conditions constant-true"),
    "KT204": (Severity.WARNING, "deny conditions constant-false"),
    # -- tensor invariants
    "KT301": (Severity.ERROR, "tensor dtype invariant violated"),
    "KT302": (Severity.ERROR, "tensor index out of range"),
    "KT303": (Severity.ERROR, "tensor geometry invariant violated"),
    "KT304": (Severity.ERROR, "segment splice invariant violated"),
    "KT305": (Severity.ERROR, "policy-shard partition invariant violated"),
    "KT311": (Severity.ERROR, "batch interner index out of range"),
    "KT312": (Severity.ERROR, "batch lane invariant violated"),
    "KT313": (Severity.ERROR, "padding-bucket invariant violated"),
    # -- cross-layer certification (analysis/certify.py)
    "KT401": (Severity.ERROR, "device/host verdict divergence"),
    "KT402": (Severity.WARNING, "unsound escalation (dischargeable)"),
    "KT403": (Severity.WARNING, "deny-message lane divergence"),
    "KT404": (Severity.INFO, "certification incomplete"),
    # -- feature-lane lint (analysis/featurelint.py)
    "KT501": (Severity.ERROR, "undeclared KTPU_* switch read"),
    "KT502": (Severity.ERROR, "dead featureplane declaration"),
    "KT503": (Severity.ERROR, "env read bypasses featureplane"),
}

SUPPRESS_ANNOTATION = "kyverno-tpu.io/lint-suppress"


@dataclass(frozen=True)
class Diagnostic:
    code: str
    message: str
    policy: str = ""
    rule: str = ""
    # provenance: which component of the rule/tensor the finding anchors to
    # ("match", "preconditions", "deny", "pattern", "pattern[alt=1]",
    #  "tensors.chk_path", "batch.str_id", ...)
    component: str = ""
    # EscalationReason value for KT1xx findings ("" otherwise)
    reason: str = ""

    @property
    def severity(self) -> Severity:
        return CODES[self.code][0]

    @property
    def title(self) -> str:
        return CODES[self.code][1]

    def format(self) -> str:
        where = "/".join(x for x in (self.policy, self.rule) if x)
        parts = [self.severity.name, self.code]
        if where:
            parts.append(where)
        if self.component:
            parts.append(f"[{self.component}]")
        head = " ".join(parts)
        tail = f" ({self.reason})" if self.reason else ""
        return f"{head}: {self.message}{tail}"

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity.name,
            "title": self.title,
            "message": self.message,
            "policy": self.policy,
            "rule": self.rule,
            "component": self.component,
            "reason": self.reason,
        }


def make(code: str, message: str, **kw) -> Diagnostic:
    if code not in CODES:
        raise ValueError(f"unknown diagnostic code {code!r}")
    return Diagnostic(code=code, message=message, **kw)


def parse_suppressions(spec: str) -> set[str]:
    """``"KT202, KT110"`` -> {"KT202", "KT110"}."""
    return {c.strip().upper() for c in spec.split(",") if c.strip()}


def policy_suppressions(policy) -> set[str]:
    """Codes suppressed via the policy's lint-suppress annotation."""
    try:
        spec = (policy.annotations or {}).get(SUPPRESS_ANNOTATION, "")
    except Exception:
        return set()
    return parse_suppressions(spec) if spec else set()


@dataclass
class AnalysisReport:
    diagnostics: list[Diagnostic] = field(default_factory=list)
    # policy name -> fraction of its validate rules that stay on device
    device_decidability: dict[str, float] = field(default_factory=dict)

    def by_severity(self, severity: Severity) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is severity]

    def max_severity(self) -> Severity | None:
        if not self.diagnostics:
            return None
        return Severity(max(d.severity for d in self.diagnostics))

    def categories(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def to_dict(self) -> dict:
        counts = {s.name: len(self.by_severity(s)) for s in Severity}
        return {
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "device_decidability": dict(self.device_decidability),
            "summary": {"counts": counts,
                        "categories": sorted(self.categories())},
        }
