"""Rule match/exclude filtering.

Mirrors kyverno/pkg/engine/utils.go:265 MatchesResourceDescription:
AND across attributes of a resource filter, OR inside list attributes;
``any`` = OR over filters, ``all`` = AND; exclude mirrors match with
inverted effect. UserInfo (roles/clusterRoles/subjects) matches as OR.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.types import MatchResources, ResourceDescription, ResourceFilter, Rule, UserInfo
from ..utils.wildcard import wildcard_match
from . import resource as res
from .selector import SelectorError, selector_matches
from .wildcards import replace_in_selector

SA_PREFIX = "system:serviceaccount:"


@dataclass
class AdmissionUserInfo:
    username: str = ""
    uid: str = ""
    groups: list[str] = field(default_factory=list)


@dataclass
class RequestInfo:
    """kyverno.RequestInfo: resolved RBAC roles plus raw admission userInfo."""

    roles: list[str] = field(default_factory=list)
    cluster_roles: list[str] = field(default_factory=list)
    admission_user_info: AdmissionUserInfo = field(default_factory=AdmissionUserInfo)

    def is_empty(self) -> bool:
        return not (
            self.roles
            or self.cluster_roles
            or self.admission_user_info.username
            or self.admission_user_info.uid
            or self.admission_user_info.groups
        )


def check_kind(kinds: list[str], resource: dict) -> bool:
    """utils.go:38 checkKind: "Pod", "*", "v1/Pod", "apps/v1/Deployment"."""
    group, version, kind = res.gvk(resource)
    for k in kinds:
        parts = k.split("/")
        if len(parts) == 1:
            if kind == res.title_first(k) or k == "*":
                return True
        elif len(parts) == 2:
            if kind == res.title_first(parts[1]) and version == parts[0]:
                return True
        else:
            if (
                group == parts[0]
                and kind == res.title_first(parts[2])
                and (version == parts[1] or parts[1] == "*")
            ):
                return True
    return False


def check_name(pattern: str, name: str) -> bool:
    return wildcard_match(pattern, name)


def check_namespace(namespaces: list[str], resource: dict) -> bool:
    ns = res.get_namespace(resource)
    if res.get_kind(resource) == "Namespace":
        ns = res.get_name(resource)
    return any(wildcard_match(p, ns) for p in namespaces)


def check_annotations(annotations: dict, resource_annotations: dict) -> bool:
    """Every pattern entry must match some resource annotation (utils.go:78)."""
    for k, v in annotations.items():
        if not any(
            wildcard_match(k, rk) and wildcard_match(str(v), str(rv))
            for rk, rv in resource_annotations.items()
        ):
            return False
    return True


def check_selector(selector: dict, resource_labels: dict) -> tuple[bool, str]:
    sel = dict(selector)
    if sel.get("matchLabels"):
        sel["matchLabels"] = replace_in_selector(sel["matchLabels"], resource_labels)
    try:
        return selector_matches(sel, resource_labels), ""
    except SelectorError as e:
        return False, str(e)


def match_subjects(subjects: list[dict], user: AdmissionUserInfo, dynamic_config: list[str]) -> bool:
    """utils.go:237 matchSubjects."""
    user_groups = list(user.groups) + [user.username]
    all_subjects = list(subjects) + [
        {"kind": "Group", "name": g} for g in dynamic_config
    ]
    for subject in all_subjects:
        kind = subject.get("kind", "")
        name = subject.get("name", "")
        if kind == "ServiceAccount":
            if len(user.username) <= len(SA_PREFIX):
                continue
            target = f"{subject.get('namespace', '')}:{name}"
            if user.username[len(SA_PREFIX):] == target:
                return True
        elif kind in ("User", "Group"):
            if name in user_groups:
                return True
    return False


def _check_condition_block(
    desc: ResourceDescription,
    user_info: UserInfo,
    admission_info: RequestInfo,
    resource: dict,
    dynamic_config: list[str],
    namespace_labels: dict,
) -> list[str]:
    """utils.go:124 doesResourceMatchConditionBlock: returns failure reasons."""
    errs: list[str] = []
    if desc.kinds and not check_kind(desc.kinds, resource):
        errs.append(f"kind does not match {desc.kinds}")
    if desc.name and not check_name(desc.name, res.get_name(resource)):
        errs.append("name does not match")
    if desc.names and not any(check_name(n, res.get_name(resource)) for n in desc.names):
        errs.append("none of the names match")
    if desc.namespaces and not check_namespace(desc.namespaces, resource):
        errs.append("namespace does not match")
    if desc.annotations and not check_annotations(desc.annotations, res.get_annotations(resource)):
        errs.append("annotations does not match")
    if desc.selector is not None:
        ok, err = check_selector(desc.selector, res.get_labels(resource))
        if err:
            errs.append(f"failed to parse selector: {err}")
        elif not ok:
            errs.append("selector does not match")
    if (
        desc.namespace_selector is not None
        and res.get_kind(resource) not in ("Namespace", "")
    ):
        ok, err = check_selector(desc.namespace_selector, namespace_labels)
        if err:
            errs.append(f"failed to parse namespace selector: {err}")
        elif not ok:
            errs.append("namespace selector does not match")

    # UserInfo: OR across roles / clusterRoles / subjects (utils.go:196-234)
    keys = list(admission_info.admission_user_info.groups) + [
        admission_info.admission_user_info.username
    ]
    excluded_by_config = any(k in keys for k in dynamic_config)
    user_errs: list[str] = []
    checked = 0
    if user_info.roles and not excluded_by_config:
        checked += 1
        if any(r in user_info.roles for r in admission_info.roles):
            return errs
        user_errs.append("user info does not match roles")
    if user_info.cluster_roles and not excluded_by_config:
        checked += 1
        if any(r in user_info.cluster_roles for r in admission_info.cluster_roles):
            return errs
        user_errs.append("user info does not match clusterRoles")
    if user_info.subjects:
        checked += 1
        if match_subjects(user_info.subjects, admission_info.admission_user_info, dynamic_config):
            return errs
        user_errs.append("user info does not match subjects")
    if checked != len(user_errs):
        return errs
    return errs + user_errs


def _match_helper(
    rf: ResourceFilter,
    admission_info: RequestInfo,
    resource: dict,
    dynamic_config: list[str],
    namespace_labels: dict,
) -> list[str]:
    user_info = rf.user_info
    if admission_info.is_empty():
        user_info = UserInfo()
    if rf.resources.is_empty() and user_info.is_empty():
        return ["match cannot be empty"]
    return _check_condition_block(
        rf.resources, user_info, admission_info, resource, dynamic_config, namespace_labels
    )


def _exclude_helper(
    rf: ResourceFilter,
    admission_info: RequestInfo,
    resource: dict,
    dynamic_config: list[str],
    namespace_labels: dict,
) -> list[str]:
    if rf.resources.is_empty() and rf.user_info.is_empty():
        return []
    errs = _check_condition_block(
        rf.resources, rf.user_info, admission_info, resource, dynamic_config, namespace_labels
    )
    if not errs:
        return ["resource excluded since one of the criteria excluded it"]
    return []


def matches_resource_description(
    resource: dict,
    rule: Rule,
    admission_info: RequestInfo | None = None,
    dynamic_config: list[str] | None = None,
    namespace_labels: dict | None = None,
    policy_namespace: str = "",
) -> tuple[bool, str]:
    """utils.go:265. Returns (matches, reason-if-not)."""
    admission_info = admission_info or RequestInfo()
    dynamic_config = dynamic_config or []
    namespace_labels = namespace_labels or {}
    reasons: list[str] = []

    if policy_namespace and policy_namespace != res.get_namespace(resource):
        return False, "policy and resource namespaces differ"

    match: MatchResources = rule.match
    if match.any:
        if not any(
            not _match_helper(rf, admission_info, resource, dynamic_config, namespace_labels)
            for rf in match.any
        ):
            reasons.append("no resource matched")
    elif match.all:
        for rf in match.all:
            reasons.extend(
                _match_helper(rf, admission_info, resource, dynamic_config, namespace_labels)
            )
    else:
        rf = ResourceFilter(user_info=match.user_info, resources=match.resources)
        reasons.extend(
            _match_helper(rf, admission_info, resource, dynamic_config, namespace_labels)
        )

    exclude: MatchResources = rule.exclude
    if exclude.any:
        for rf in exclude.any:
            reasons.extend(
                _exclude_helper(rf, admission_info, resource, dynamic_config, namespace_labels)
            )
    elif exclude.all:
        if all(
            _exclude_helper(rf, admission_info, resource, dynamic_config, namespace_labels)
            for rf in exclude.all
        ):
            reasons.append("resource excluded since all criteria exclude it")
    else:
        rf = ResourceFilter(user_info=exclude.user_info, resources=exclude.resources)
        reasons.extend(
            _exclude_helper(rf, admission_info, resource, dynamic_config, namespace_labels)
        )

    if reasons:
        return False, f"rule {rule.name} not matched: " + "; ".join(reasons)
    return True, ""
