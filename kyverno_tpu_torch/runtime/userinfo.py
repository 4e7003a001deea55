"""AdmissionRequest.UserInfo -> roles/clusterRoles resolution.

Mirrors kyverno/pkg/userinfo/roleRef.go GetRoleRef: scan
RoleBindings / ClusterRoleBindings for subjects matching the request user
or its groups; filter excluded service accounts.
"""

from __future__ import annotations

from ..engine.match import AdmissionUserInfo, RequestInfo

SA_PREFIX = "system:serviceaccount:"


def _subject_matches(subject: dict, user: str, groups: list[str]) -> bool:
    kind = subject.get("kind", "")
    name = subject.get("name", "")
    if kind == "ServiceAccount":
        ns = subject.get("namespace", "")
        return user == f"{SA_PREFIX}{ns}:{name}"
    if kind == "User":
        return user == name
    if kind == "Group":
        return name in groups
    return False


def get_role_ref(client, user_info: AdmissionUserInfo) -> tuple[list[str], list[str]]:
    """roleRef.go GetRoleRef -> (roles as ns:name, clusterRoles)."""
    roles: list[str] = []
    cluster_roles: list[str] = []
    user = user_info.username
    groups = list(user_info.groups)

    for rb in client.list_resource("rbac.authorization.k8s.io/v1", "RoleBinding"):
        for subject in rb.get("subjects") or []:
            if _subject_matches(subject, user, groups):
                ns = (rb.get("metadata") or {}).get("namespace", "")
                ref = rb.get("roleRef") or {}
                if ref.get("kind") == "Role":
                    roles.append(f"{ns}:{ref.get('name', '')}")
                elif ref.get("kind") == "ClusterRole":
                    cluster_roles.append(ref.get("name", ""))
                break

    for crb in client.list_resource("rbac.authorization.k8s.io/v1", "ClusterRoleBinding"):
        for subject in crb.get("subjects") or []:
            if _subject_matches(subject, user, groups):
                ref = crb.get("roleRef") or {}
                if ref.get("kind") == "ClusterRole":
                    cluster_roles.append(ref.get("name", ""))
                break

    return roles, cluster_roles


def build_request_info(client, user_info_doc: dict,
                       resolve_roles: bool = True) -> RequestInfo:
    user = AdmissionUserInfo(
        username=(user_info_doc or {}).get("username", ""),
        uid=(user_info_doc or {}).get("uid", ""),
        groups=list((user_info_doc or {}).get("groups") or []),
    )
    info = RequestInfo(admission_user_info=user)
    if resolve_roles and client is not None:
        info.roles, info.cluster_roles = get_role_ref(client, user)
    return info
