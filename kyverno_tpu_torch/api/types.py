"""Policy CRD types (L0), mirroring kyverno/api/kyverno/v1/policy_types.go.

Pattern bodies (validate patterns, strategic-merge patches, generate data,
condition lists) stay as raw JSON trees — the engine and the tensor compiler
both consume them structurally, exactly as the reference keeps them as
apiextensions.JSON.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ResourceDescription:
    """policy_types.go:343"""

    kinds: list[str] = field(default_factory=list)
    name: str = ""
    names: list[str] = field(default_factory=list)
    namespaces: list[str] = field(default_factory=list)
    annotations: dict[str, str] = field(default_factory=dict)
    selector: Optional[dict] = None            # metav1.LabelSelector JSON
    namespace_selector: Optional[dict] = None

    def is_empty(self) -> bool:
        return not (
            self.kinds
            or self.name
            or self.names
            or self.namespaces
            or self.annotations
            or self.selector
            or self.namespace_selector
        )

    @classmethod
    def from_dict(cls, d: dict | None) -> "ResourceDescription":
        d = d or {}
        return cls(
            kinds=list(d.get("kinds") or []),
            name=d.get("name") or "",
            names=list(d.get("names") or []),
            namespaces=list(d.get("namespaces") or []),
            annotations=dict(d.get("annotations") or {}),
            selector=d.get("selector"),
            namespace_selector=d.get("namespaceSelector"),
        )


@dataclass
class UserInfo:
    """policy_types.go:328"""

    roles: list[str] = field(default_factory=list)
    cluster_roles: list[str] = field(default_factory=list)
    subjects: list[dict] = field(default_factory=list)  # rbacv1.Subject JSON

    def is_empty(self) -> bool:
        return not (self.roles or self.cluster_roles or self.subjects)

    @classmethod
    def from_dict(cls, d: dict | None) -> "UserInfo":
        d = d or {}
        return cls(
            roles=list(d.get("roles") or []),
            cluster_roles=list(d.get("clusterRoles") or []),
            subjects=list(d.get("subjects") or []),
        )


@dataclass
class ResourceFilter:
    """policy_types.go:318"""

    user_info: UserInfo = field(default_factory=UserInfo)
    resources: ResourceDescription = field(default_factory=ResourceDescription)

    def is_empty(self) -> bool:
        return self.user_info.is_empty() and self.resources.is_empty()

    @classmethod
    def from_dict(cls, d: dict | None) -> "ResourceFilter":
        d = d or {}
        return cls(
            user_info=UserInfo.from_dict(d),
            resources=ResourceDescription.from_dict(d.get("resources")),
        )


@dataclass
class MatchResources:
    """policy_types.go:267 (also used for exclude, :292)"""

    any: list[ResourceFilter] = field(default_factory=list)
    all: list[ResourceFilter] = field(default_factory=list)
    user_info: UserInfo = field(default_factory=UserInfo)
    resources: ResourceDescription = field(default_factory=ResourceDescription)

    def is_empty(self) -> bool:
        return (
            not self.any
            and not self.all
            and self.user_info.is_empty()
            and self.resources.is_empty()
        )

    @classmethod
    def from_dict(cls, d: dict | None) -> "MatchResources":
        d = d or {}
        return cls(
            any=[ResourceFilter.from_dict(x) for x in (d.get("any") or [])],
            all=[ResourceFilter.from_dict(x) for x in (d.get("all") or [])],
            user_info=UserInfo.from_dict(d),
            resources=ResourceDescription.from_dict(d.get("resources")),
        )


@dataclass
class ContextEntry:
    """policy_types.go:160: one of configMap / apiCall (imageRegistry arrives
    in later reference versions; modeled for forward-compat)."""

    name: str = ""
    config_map: Optional[dict] = None  # {name, namespace}
    api_call: Optional[dict] = None    # {urlPath, jmesPath}
    variable: Optional[dict] = None    # {value, jmesPath, default}

    @classmethod
    def from_dict(cls, d: dict) -> "ContextEntry":
        return cls(
            name=d.get("name") or "",
            config_map=d.get("configMap"),
            api_call=d.get("apiCall"),
            variable=d.get("variable"),
        )


@dataclass
class ForEach:
    """ForEachValidation / ForEachMutation (policy_types.go:421,503)."""

    list_expr: str = ""
    context: list[ContextEntry] = field(default_factory=list)
    preconditions: Any = None
    pattern: Any = None
    any_pattern: Any = None
    deny: Optional[dict] = None
    patch_strategic_merge: Any = None

    @classmethod
    def from_dict(cls, d: dict) -> "ForEach":
        return cls(
            list_expr=d.get("list") or "",
            context=[ContextEntry.from_dict(c) for c in (d.get("context") or [])],
            preconditions=d.get("preconditions"),
            pattern=d.get("pattern"),
            any_pattern=d.get("anyPattern"),
            deny=d.get("deny"),
            patch_strategic_merge=d.get("patchStrategicMerge"),
        )


@dataclass
class Validation:
    """policy_types.go:466"""

    message: str = ""
    pattern: Any = None
    any_pattern: Any = None
    deny: Optional[dict] = None           # {conditions: any/all-or-list}
    foreach: list[ForEach] = field(default_factory=list)

    def is_empty(self) -> bool:
        return (
            self.pattern is None
            and self.any_pattern is None
            and self.deny is None
            and not self.foreach
        )

    @classmethod
    def from_dict(cls, d: dict | None) -> "Validation":
        d = d or {}
        return cls(
            message=d.get("message") or "",
            pattern=d.get("pattern"),
            any_pattern=d.get("anyPattern"),
            deny=d.get("deny"),
            foreach=[ForEach.from_dict(f) for f in (d.get("foreach") or [])],
        )


@dataclass
class Mutation:
    """policy_types.go:387"""

    overlay: Any = None                   # deprecated; rewritten to PSM
    patches: list[dict] = field(default_factory=list)  # deprecated
    patch_strategic_merge: Any = None
    patches_json6902: str = ""
    foreach: list[ForEach] = field(default_factory=list)

    def is_empty(self) -> bool:
        return (
            self.overlay is None
            and not self.patches
            and self.patch_strategic_merge is None
            and not self.patches_json6902
            and not self.foreach
        )

    @classmethod
    def from_dict(cls, d: dict | None) -> "Mutation":
        d = d or {}
        return cls(
            overlay=d.get("overlay"),
            patches=list(d.get("patches") or []),
            patch_strategic_merge=d.get("patchStrategicMerge"),
            patches_json6902=d.get("patchesJson6902") or "",
            foreach=[ForEach.from_dict(f) for f in (d.get("foreach") or [])],
        )


@dataclass
class Generation:
    """policy_types.go:579"""

    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    synchronize: bool = False
    data: Any = None
    clone: Optional[dict] = None  # {namespace, name}

    def is_empty(self) -> bool:
        return not (self.kind or self.name or self.data or self.clone)

    @classmethod
    def from_dict(cls, d: dict | None) -> "Generation":
        d = d or {}
        return cls(
            api_version=d.get("apiVersion") or "",
            kind=d.get("kind") or "",
            namespace=d.get("namespace") or "",
            name=d.get("name") or "",
            synchronize=bool(d.get("synchronize", False)),
            data=d.get("data"),
            clone=d.get("clone"),
        )


@dataclass
class ImageVerification:
    """policy_types.go:539"""

    image: str = ""
    key: str = ""
    roots: str = ""
    subject: str = ""
    repository: str = ""
    attestations: list[dict] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "ImageVerification":
        return cls(
            image=d.get("image") or "",
            key=d.get("key") or "",
            roots=d.get("roots") or "",
            subject=d.get("subject") or "",
            repository=d.get("repository") or "",
            attestations=list(d.get("attestations") or []),
        )


@dataclass
class Rule:
    """policy_types.go:80"""

    name: str = ""
    context: list[ContextEntry] = field(default_factory=list)
    match: MatchResources = field(default_factory=MatchResources)
    exclude: MatchResources = field(default_factory=MatchResources)
    preconditions: Any = None  # any/all dict or bare list (backwards compat)
    mutation: Mutation = field(default_factory=Mutation)
    validation: Validation = field(default_factory=Validation)
    generation: Generation = field(default_factory=Generation)
    verify_images: list[ImageVerification] = field(default_factory=list)

    def has_mutate(self) -> bool:
        return not self.mutation.is_empty()

    def has_validate(self) -> bool:
        return not self.validation.is_empty()

    def has_generate(self) -> bool:
        return not self.generation.is_empty()

    def has_verify_images(self) -> bool:
        return bool(self.verify_images)

    def match_kinds(self) -> list[str]:
        """policy_types.go MatchKinds: kinds across match.resources and
        every match.any/all resource filter."""
        kinds = list(self.match.resources.kinds)
        for rf in list(self.match.any) + list(self.match.all):
            kinds.extend(rf.resources.kinds)
        return kinds

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        return cls(
            name=d.get("name") or "",
            context=[ContextEntry.from_dict(c) for c in (d.get("context") or [])],
            match=MatchResources.from_dict(d.get("match")),
            exclude=MatchResources.from_dict(d.get("exclude")),
            preconditions=d.get("preconditions"),
            mutation=Mutation.from_dict(d.get("mutate")),
            validation=Validation.from_dict(d.get("validate")),
            generation=Generation.from_dict(d.get("generate")),
            verify_images=[
                ImageVerification.from_dict(v) for v in (d.get("verifyImages") or [])
            ],
        )


@dataclass
class Spec:
    """policy_types.go:42"""

    rules: list[Rule] = field(default_factory=list)
    failure_policy: str = "Fail"
    validation_failure_action: str = "audit"
    background: bool = True
    schema_validation: bool = True
    webhook_timeout_seconds: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict | None) -> "Spec":
        d = d or {}
        return cls(
            rules=[Rule.from_dict(r) for r in (d.get("rules") or [])],
            failure_policy=d.get("failurePolicy") or "Fail",
            validation_failure_action=d.get("validationFailureAction") or "audit",
            background=bool(d.get("background", True)),
            schema_validation=bool(d.get("schemaValidation", True)),
            webhook_timeout_seconds=d.get("webhookTimeoutSeconds"),
        )


@dataclass
class ClusterPolicy:
    """ClusterPolicy / (namespaced) Policy."""

    api_version: str = "kyverno.io/v1"
    kind: str = "ClusterPolicy"
    metadata: dict = field(default_factory=dict)
    spec: Spec = field(default_factory=Spec)
    raw: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        """Namespaced Policy objects apply only within their namespace."""
        if self.kind == "Policy":
            return self.metadata.get("namespace", "") or "default"
        return ""

    @property
    def annotations(self) -> dict:
        return self.metadata.get("annotations") or {}

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterPolicy":
        return cls(
            api_version=d.get("apiVersion") or "kyverno.io/v1",
            kind=d.get("kind") or "ClusterPolicy",
            metadata=d.get("metadata") or {},
            spec=Spec.from_dict(d.get("spec")),
            raw=d,
        )
