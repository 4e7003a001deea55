"""Engine response model (mirrors kyverno/pkg/engine/response)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum


class RuleStatus(Enum):
    """response/status.go:10-27"""

    PASS = "pass"
    FAIL = "fail"
    WARN = "warn"
    ERROR = "error"
    SKIP = "skip"


class RuleType(Enum):
    MUTATION = "Mutation"
    VALIDATION = "Validation"
    GENERATION = "Generation"
    IMAGE_VERIFY = "ImageVerify"


@dataclass
class RuleResponse:
    """response/response.go:72"""

    name: str
    type: RuleType
    message: str = ""
    status: RuleStatus = RuleStatus.PASS
    patches: list = field(default_factory=list)  # RFC6902 ops (dicts)
    generated_resource: dict | None = None
    processing_time_s: float = 0.0

    @property
    def success(self) -> bool:
        return self.status in (RuleStatus.PASS, RuleStatus.SKIP, RuleStatus.WARN)


@dataclass
class PolicySpecSummary:
    name: str = ""
    category: str = ""
    validation_failure_action: str = "audit"


@dataclass
class ResourceSpec:
    kind: str = ""
    api_version: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class PolicyResponse:
    """response/response.go:19"""

    policy: PolicySpecSummary = field(default_factory=PolicySpecSummary)
    resource: ResourceSpec = field(default_factory=ResourceSpec)
    rules: list[RuleResponse] = field(default_factory=list)
    rules_applied_count: int = 0
    rules_error_count: int = 0
    processing_time_s: float = 0.0
    timestamp: float = field(default_factory=time.time)


@dataclass
class EngineResponse:
    """response/response.go:11"""

    patched_resource: dict | None = None
    policy_response: PolicyResponse = field(default_factory=PolicyResponse)

    @property
    def successful(self) -> bool:
        """response/response.go:107 IsSuccessful: no rule failed or errored."""
        return all(r.success for r in self.policy_response.rules)

    @property
    def patches(self) -> list:
        out = []
        for r in self.policy_response.rules:
            out.extend(r.patches)
        return out

    def get_failed_rules(self) -> list[str]:
        return [
            r.name
            for r in self.policy_response.rules
            if r.status in (RuleStatus.FAIL, RuleStatus.ERROR)
        ]
