"""OpenAPI schema validation of resources and policy mutate patterns.

Mirrors kyverno/pkg/openapi/validation.go: ``validate_resource``
(:111 ValidateResource — structural check of a document against its kind's
schema) and ``validate_policy_mutation`` (:143 ValidatePolicyMutation —
apply the policy's mutate rules to an empty resource of every matched
kind via ForceMutate, then schema-check the result, so a policy that
would write schema-invalid fields is rejected at policy admission).

The reference feeds these from the live cluster's openapi-v2 document and
a CRD sync loop (pkg/openapi/crdSync.go). Without a cluster document the
schemas here are bundled structural schemas for the core workload kinds —
the same closed-object/typed-leaf checks, sourced statically. Unknown
kinds (CRDs and anything not bundled) skip validation, exactly like the
reference's "OpenApi definition not found" branch (validation.go:159).
Custom schemas can be registered at runtime (``register_schema``), the
seam crdSync fills in the reference.
"""

from __future__ import annotations

import copy
from typing import Any

# ------------------------------------------------------------- schema DSL

STRING = {"type": "string"}
INT = {"type": "integer"}
NUM = {"type": "number"}
BOOL = {"type": "boolean"}
INTSTR = {"type": "intstr"}          # IntOrString (ports, targetPort...)
QUANTITY = {"type": "quantity"}      # resource.Quantity: string or number
ANY = {"type": "any"}


def obj(fields: dict | None = None, open_: bool = False) -> dict:
    return {"type": "object", "fields": fields or {}, "open": open_}


def arr(items: dict) -> dict:
    return {"type": "array", "items": items}


def strmap() -> dict:
    return {"type": "map", "values": STRING}


OPEN = obj(open_=True)

_META = obj({
    "name": STRING, "namespace": STRING, "generateName": STRING,
    "labels": strmap(), "annotations": strmap(),
    "finalizers": arr(STRING), "ownerReferences": arr(OPEN),
    "creationTimestamp": STRING, "deletionTimestamp": STRING,
    "resourceVersion": STRING, "uid": STRING, "generation": INT,
    "managedFields": arr(OPEN), "selfLink": STRING,
})

_ENV_VAR = obj({"name": STRING, "value": STRING, "valueFrom": OPEN})

_PORT = obj({
    "name": STRING, "containerPort": INT, "hostPort": INT,
    "hostIP": STRING, "protocol": STRING,
})

_RESOURCES = obj({
    "requests": {"type": "map", "values": QUANTITY},
    "limits": {"type": "map", "values": QUANTITY},
})

_CONTAINER = obj({
    "name": STRING, "image": STRING, "imagePullPolicy": STRING,
    "command": arr(STRING), "args": arr(STRING), "workingDir": STRING,
    "env": arr(_ENV_VAR), "envFrom": arr(OPEN),
    "ports": arr(_PORT), "resources": _RESOURCES,
    "securityContext": obj({
        "privileged": BOOL, "runAsUser": INT, "runAsGroup": INT,
        "runAsNonRoot": BOOL, "readOnlyRootFilesystem": BOOL,
        "allowPrivilegeEscalation": BOOL, "capabilities": obj({
            "add": arr(STRING), "drop": arr(STRING)}),
        "seccompProfile": OPEN, "seLinuxOptions": OPEN,
        "procMount": STRING, "windowsOptions": OPEN,
    }),
    "volumeMounts": arr(obj({
        "name": STRING, "mountPath": STRING, "readOnly": BOOL,
        "subPath": STRING, "subPathExpr": STRING,
        "mountPropagation": STRING})),
    "volumeDevices": arr(OPEN),
    "livenessProbe": OPEN, "readinessProbe": OPEN, "startupProbe": OPEN,
    "lifecycle": OPEN, "terminationMessagePath": STRING,
    "terminationMessagePolicy": STRING, "stdin": BOOL, "stdinOnce": BOOL,
    "tty": BOOL,
})

_POD_SPEC = obj({
    "containers": arr(_CONTAINER), "initContainers": arr(_CONTAINER),
    "ephemeralContainers": arr(OPEN),
    "volumes": arr(obj({"name": STRING}, open_=True)),
    "restartPolicy": STRING, "terminationGracePeriodSeconds": INT,
    "activeDeadlineSeconds": INT, "dnsPolicy": STRING,
    "nodeSelector": strmap(), "serviceAccountName": STRING,
    "serviceAccount": STRING, "automountServiceAccountToken": BOOL,
    "nodeName": STRING, "hostNetwork": BOOL, "hostPID": BOOL,
    "hostIPC": BOOL, "shareProcessNamespace": BOOL,
    "securityContext": obj({
        "runAsUser": INT, "runAsGroup": INT, "runAsNonRoot": BOOL,
        "fsGroup": INT, "fsGroupChangePolicy": STRING,
        "supplementalGroups": arr(INT),
        "sysctls": arr(obj({"name": STRING, "value": STRING})),
        "seccompProfile": OPEN, "seLinuxOptions": OPEN,
        "windowsOptions": OPEN}),
    "imagePullSecrets": arr(obj({"name": STRING})),
    "hostname": STRING, "subdomain": STRING, "affinity": OPEN,
    "schedulerName": STRING, "tolerations": arr(OPEN),
    "hostAliases": arr(OPEN), "priorityClassName": STRING,
    "priority": INT, "dnsConfig": OPEN, "readinessGates": arr(OPEN),
    "runtimeClassName": STRING, "enableServiceLinks": BOOL,
    "preemptionPolicy": STRING, "overhead": OPEN,
    "topologySpreadConstraints": arr(OPEN), "setHostnameAsFQDN": BOOL,
})

_POD_TEMPLATE = obj({"metadata": _META, "spec": _POD_SPEC})

_SELECTOR = obj({"matchLabels": strmap(), "matchExpressions": arr(OPEN)})


def _workload(spec_extra: dict) -> dict:
    fields = {
        "replicas": INT, "selector": _SELECTOR, "template": _POD_TEMPLATE,
        "minReadySeconds": INT, "revisionHistoryLimit": INT, "paused": BOOL,
        "progressDeadlineSeconds": INT, "strategy": OPEN,
        "updateStrategy": OPEN, "serviceName": STRING,
        "podManagementPolicy": STRING, "volumeClaimTemplates": arr(OPEN),
    }
    fields.update(spec_extra)
    return obj({"apiVersion": STRING, "kind": STRING, "metadata": _META,
                "spec": obj(fields), "status": OPEN})


_SCHEMAS: dict[str, dict] = {
    "Pod": obj({"apiVersion": STRING, "kind": STRING, "metadata": _META,
                "spec": _POD_SPEC, "status": OPEN}),
    "Deployment": _workload({}),
    "DaemonSet": _workload({}),
    "StatefulSet": _workload({}),
    "ReplicaSet": _workload({}),
    "Job": _workload({
        "parallelism": INT, "completions": INT, "backoffLimit": INT,
        "activeDeadlineSeconds": INT, "ttlSecondsAfterFinished": INT,
        "manualSelector": BOOL, "completionMode": STRING, "suspend": BOOL}),
    "CronJob": obj({"apiVersion": STRING, "kind": STRING, "metadata": _META,
                    "spec": obj({
                        "schedule": STRING, "startingDeadlineSeconds": INT,
                        "concurrencyPolicy": STRING, "suspend": BOOL,
                        "jobTemplate": OPEN,
                        "successfulJobsHistoryLimit": INT,
                        "failedJobsHistoryLimit": INT}),
                    "status": OPEN}),
    "Service": obj({"apiVersion": STRING, "kind": STRING, "metadata": _META,
                    "spec": obj({
                        "ports": arr(obj({
                            "name": STRING, "protocol": STRING,
                            "appProtocol": STRING, "port": INT,
                            "targetPort": INTSTR, "nodePort": INT})),
                        "selector": strmap(), "clusterIP": STRING,
                        "clusterIPs": arr(STRING), "type": STRING,
                        "externalIPs": arr(STRING),
                        "sessionAffinity": STRING,
                        "loadBalancerIP": STRING,
                        "loadBalancerSourceRanges": arr(STRING),
                        "externalName": STRING,
                        "externalTrafficPolicy": STRING,
                        "healthCheckNodePort": INT,
                        "publishNotReadyAddresses": BOOL,
                        "sessionAffinityConfig": OPEN,
                        "ipFamilies": arr(STRING),
                        "ipFamilyPolicy": STRING,
                        "allocateLoadBalancerNodePorts": BOOL}),
                    "status": OPEN}),
    "Namespace": obj({"apiVersion": STRING, "kind": STRING,
                      "metadata": _META,
                      "spec": obj({"finalizers": arr(STRING)}),
                      "status": OPEN}),
    "ConfigMap": obj({"apiVersion": STRING, "kind": STRING,
                      "metadata": _META, "data": strmap(),
                      "binaryData": strmap(), "immutable": BOOL}),
    "Secret": obj({"apiVersion": STRING, "kind": STRING, "metadata": _META,
                   "data": strmap(), "stringData": strmap(),
                   "type": STRING, "immutable": BOOL}),
}


def register_schema(kind: str, schema: dict) -> None:
    """The crdSync seam: add/replace a kind schema at runtime
    (policy/crd_sync.py fills it from CRDs + the cluster document)."""
    _SCHEMAS[kind] = schema


def unregister_schema(kind: str) -> None:
    """Drop a synced schema (CRD deleted); bundled core kinds stay."""
    if kind not in _BUNDLED:
        _SCHEMAS.pop(kind, None)


_BUNDLED = frozenset(_SCHEMAS)


def has_schema(kind: str) -> bool:
    return kind in _SCHEMAS


# ------------------------------------------------------------- validation


def _check(doc: Any, schema: dict, path: str, errors: list[str]) -> None:
    t = schema["type"]
    if t == "any" or doc is None:
        return
    if t == "object":
        if not isinstance(doc, dict):
            errors.append(f"{path or '.'}: expected object, got "
                          f"{type(doc).__name__}")
            return
        fields = schema["fields"]
        for key, value in doc.items():
            sub = fields.get(key)
            if sub is None:
                if not schema["open"]:
                    errors.append(f"{path}.{key}".lstrip(".")
                                  + ": unknown field")
                continue
            _check(value, sub, f"{path}.{key}".lstrip("."), errors)
    elif t == "array":
        if not isinstance(doc, list):
            errors.append(f"{path}: expected array, got {type(doc).__name__}")
            return
        for i, item in enumerate(doc):
            _check(item, schema["items"], f"{path}[{i}]", errors)
    elif t == "map":
        if not isinstance(doc, dict):
            errors.append(f"{path}: expected object, got {type(doc).__name__}")
            return
        for key, value in doc.items():
            _check(value, schema["values"], f"{path}.{key}", errors)
    elif t == "string":
        if not isinstance(doc, str):
            errors.append(f"{path}: expected string, got {type(doc).__name__}")
    elif t == "integer":
        if isinstance(doc, bool) or not isinstance(doc, int):
            errors.append(f"{path}: expected integer, got {type(doc).__name__}")
    elif t == "number":
        if isinstance(doc, bool) or not isinstance(doc, (int, float)):
            errors.append(f"{path}: expected number, got {type(doc).__name__}")
    elif t == "boolean":
        if not isinstance(doc, bool):
            errors.append(f"{path}: expected boolean, got {type(doc).__name__}")
    elif t == "intstr":
        if isinstance(doc, bool) or not isinstance(doc, (int, str)):
            errors.append(f"{path}: expected integer-or-string, got "
                          f"{type(doc).__name__}")
    elif t == "quantity":
        if isinstance(doc, bool) or not isinstance(doc, (int, float, str)):
            errors.append(f"{path}: expected quantity, got "
                          f"{type(doc).__name__}")


def validate_resource(resource: dict, kind: str = "") -> list[str]:
    """validation.go:111 ValidateResource: [] when valid or no schema."""
    kind = kind or resource.get("kind", "")
    schema = _SCHEMAS.get(kind)
    if schema is None:
        return []  # "OpenApi definition not found" -> skip
    errors: list[str] = []
    _check(resource, schema, "", errors)
    return errors


def validate_policy_mutation(policy) -> list[str]:
    """validation.go:143 ValidatePolicyMutation: force-mutate an empty
    resource of every matched kind and schema-check the result."""
    from ..engine.force_mutate import force_mutate

    # schemaValidation: false opts the policy out (validation.go:170)
    if not policy.spec.schema_validation:
        return []

    kind_rules: dict[str, list] = {}
    for rule in policy.spec.rules:
        if not rule.has_mutate():
            continue
        for gvk in rule.match_kinds():
            kind = gvk.split("/")[-1]
            kind_rules.setdefault(kind, []).append(rule)

    errors: list[str] = []
    for kind, rules in kind_rules.items():
        if not has_schema(kind):
            continue  # validation.go:159 definition not found -> skip
        sub = copy.copy(policy)
        sub.spec = copy.copy(policy.spec)
        sub.spec.rules = rules
        base = {"kind": kind}
        try:
            mutated = force_mutate(None, sub, base)
        except Exception as e:
            errors.append(f"mutate rules for kind {kind} failed to apply: {e}")
            continue
        for err in validate_resource(mutated, kind):
            errors.append(f"mutate result for kind {kind} invalid: {err}")
    return errors
