"""Autogen: pod-controller rules generated from Pod rules.

Mirrors kyverno/pkg/policymutation (GeneratePodControllerRule
policymutation.go:353, CanAutoGen :395, generateRuleForControllers :603,
cronjob.go generateCronJobRule): every Pod rule gains an ``autogen-`` twin
matching Deployment/DaemonSet/StatefulSet/Job with patterns wrapped under
``spec.template``, plus an ``autogen-cronjob-`` twin double-wrapped under
``spec.jobTemplate``; ``request.object.spec`` variable references shift
accordingly. Plus the admission defaults (validationFailureAction,
background, failurePolicy).
"""

from __future__ import annotations

import copy
import json

from ..api.load import load_policy
from ..api.types import ClusterPolicy

POD_CONTROLLERS = "DaemonSet,Deployment,Job,StatefulSet,CronJob"
POD_CONTROLLERS_ANNOTATION = "pod-policies.kyverno.io/autogen-controllers"
_NON_CRON = "DaemonSet,Deployment,Job,StatefulSet"


def _kinds_of(block: dict) -> list[str]:
    kinds = list((block.get("resources") or {}).get("kinds") or [])
    for rf in (block.get("any") or []) + (block.get("all") or []):
        kinds.extend((rf.get("resources") or {}).get("kinds") or [])
    return kinds


def _kind_blocks(block: dict) -> list[list[str]]:
    """Each kinds list separately (CanAutoGen checks per block)."""
    out = [list((block.get("resources") or {}).get("kinds") or [])]
    for rf in (block.get("any") or []) + (block.get("all") or []):
        out.append(list((rf.get("resources") or {}).get("kinds") or []))
    return out


def _is_kind_other_than_pod(kinds: list[str]) -> bool:
    """policymutation.go:458 isKindOtherthanPod: mixed Pod + other kinds."""
    return len(kinds) > 1 and "Pod" in kinds


def _block_blocks_autogen(block: dict) -> bool:
    rd = block.get("resources") or {}
    if rd.get("name") or rd.get("selector") or rd.get("annotations"):
        return True
    for rf in (block.get("any") or []) + (block.get("all") or []):
        rfd = rf.get("resources") or {}
        if rfd.get("name") or rfd.get("selector") or rfd.get("annotations"):
            return True
        if _is_kind_other_than_pod((rfd.get("kinds") or [])):
            return True
    return False


def can_auto_gen(policy_doc: dict) -> tuple[bool, str]:
    """policymutation.go:395 CanAutoGen."""
    for rule in ((policy_doc.get("spec") or {}).get("rules") or []):
        match = rule.get("match") or {}
        exclude = rule.get("exclude") or {}
        if _block_blocks_autogen(match) or _block_blocks_autogen(exclude):
            return False, "none"
        if any(
            _is_kind_other_than_pod(kinds)
            for kinds in _kind_blocks(match) + _kind_blocks(exclude)
        ):
            return False, "none"
        mutate_block = rule.get("mutate") or {}
        validate_block = rule.get("validate") or {}
        if (
            mutate_block.get("patches")
            or mutate_block.get("patchesJson6902")
            or validate_block.get("deny") is not None
            or rule.get("generate")
        ):
            return False, "none"
    return True, POD_CONTROLLERS


def _shift_variables(doc, kind: str):
    """policymutation.go:495 updateGenRuleByte: shift request.object paths
    into the pod template."""
    raw = json.dumps(doc)
    if kind == "Pod":
        raw = raw.replace("request.object.spec", "request.object.spec.template.spec")
    elif kind == "Cronjob":
        raw = raw.replace(
            "request.object.spec", "request.object.spec.jobTemplate.spec.template.spec"
        )
    raw = raw.replace("request.object.metadata", "request.object.spec.template.metadata")
    return json.loads(raw)


def _set_kinds(block: dict, controllers: str) -> dict:
    block = copy.deepcopy(block)
    kinds = controllers.split(",")
    if block.get("any"):
        for rf in block["any"]:
            rf.setdefault("resources", {})["kinds"] = kinds
    elif block.get("all"):
        for rf in block["all"]:
            rf.setdefault("resources", {})["kinds"] = kinds
    else:
        block.setdefault("resources", {})["kinds"] = kinds
    return block


def generate_rule_for_controllers(rule: dict, controllers: str) -> dict | None:
    """policymutation.go:603 generateRuleForControllers."""
    if rule.get("name", "").startswith("autogen-") or not controllers:
        return None
    match_kinds = _kinds_of(rule.get("match") or {})
    exclude_kinds = _kinds_of(rule.get("exclude") or {})
    if "Pod" not in match_kinds or (exclude_kinds and "Pod" not in exclude_kinds):
        return None

    if controllers == "all":
        controllers = _NON_CRON
    else:
        valid = [c for c in controllers.split(",") if c in _NON_CRON.split(",")]
        if valid:
            controllers = ",".join(valid)

    name = f"autogen-{rule['name']}"[:63]
    gen: dict = {"name": name, "match": _set_kinds(rule.get("match") or {}, controllers)}
    if rule.get("context"):
        gen["context"] = copy.deepcopy(rule["context"])
    if rule.get("preconditions"):
        gen["preconditions"] = copy.deepcopy(rule["preconditions"])
    if rule.get("exclude"):
        exclude = rule["exclude"]
        gen["exclude"] = (
            _set_kinds(exclude, controllers)
            if _kinds_of(exclude)
            else copy.deepcopy(exclude)
        )

    mutate_block = rule.get("mutate") or {}
    validate_block = rule.get("validate") or {}
    if mutate_block.get("overlay") is not None or mutate_block.get("patchStrategicMerge") is not None:
        key = "overlay" if mutate_block.get("overlay") is not None else "patchStrategicMerge"
        gen["mutate"] = {
            "patchStrategicMerge": {"spec": {"template": copy.deepcopy(mutate_block[key])}}
        }
    elif mutate_block.get("foreach"):
        gen["mutate"] = {
            "foreach": [
                {
                    **{k: v for k, v in fe.items() if k != "patchStrategicMerge"},
                    "patchStrategicMerge": {
                        "spec": {"template": copy.deepcopy(fe.get("patchStrategicMerge"))}
                    },
                }
                for fe in mutate_block["foreach"]
            ]
        }
    elif validate_block.get("pattern") is not None:
        gen["validate"] = {
            "message": validate_block.get("message", ""),
            "pattern": {"spec": {"template": copy.deepcopy(validate_block["pattern"])}},
        }
    elif validate_block.get("anyPattern") is not None:
        gen["validate"] = {
            "message": validate_block.get("message", ""),
            "anyPattern": [
                {"spec": {"template": copy.deepcopy(p)}}
                for p in validate_block["anyPattern"]
            ],
        }
    elif validate_block.get("foreach"):
        gen["validate"] = {
            "message": validate_block.get("message", ""),
            "foreach": copy.deepcopy(validate_block["foreach"]),
        }
    elif rule.get("verifyImages"):
        gen["verifyImages"] = copy.deepcopy(rule["verifyImages"])
    else:
        return None

    return _shift_variables(gen, "Pod")


def generate_cronjob_rule(rule: dict, controllers: str) -> dict | None:
    """cronjob.go:15 generateCronJobRule: the Job twin wrapped once more."""
    if "CronJob" not in controllers and controllers != "all":
        return None
    job_rule = generate_rule_for_controllers(rule, "Job")
    if job_rule is None:
        return None
    cron = copy.deepcopy(job_rule)
    cron["name"] = f"autogen-cronjob-{rule['name']}"[:63]
    cron["match"] = _set_kinds(cron.get("match") or {}, "CronJob")
    if cron.get("exclude") and _kinds_of(cron["exclude"]):
        cron["exclude"] = _set_kinds(cron["exclude"], "CronJob")

    mutate_block = cron.get("mutate") or {}
    validate_block = cron.get("validate") or {}
    if mutate_block.get("patchStrategicMerge") is not None:
        cron["mutate"] = {
            "patchStrategicMerge": {
                "spec": {"jobTemplate": mutate_block["patchStrategicMerge"]}
            }
        }
    elif mutate_block.get("foreach"):
        # cronjob.go:134 ForEachMutation: each entry's patch re-wraps
        cron["mutate"] = {
            "foreach": [
                {
                    **{k: v for k, v in fe.items() if k != "patchStrategicMerge"},
                    "patchStrategicMerge": {
                        "spec": {"jobTemplate": fe.get("patchStrategicMerge")}
                    },
                }
                for fe in mutate_block["foreach"]
            ]
        }
    elif validate_block.get("pattern") is not None:
        cron["validate"] = {
            "message": validate_block.get("message", ""),
            "pattern": {"spec": {"jobTemplate": validate_block["pattern"]}},
        }
    elif validate_block.get("anyPattern") is not None:
        cron["validate"] = {
            "message": validate_block.get("message", ""),
            "anyPattern": [
                {"spec": {"jobTemplate": p}} for p in validate_block["anyPattern"]
            ],
        }
    # re-shift variables one level deeper (Job twin already shifted once)
    raw = json.dumps(cron).replace(
        "request.object.spec.template.spec",
        "request.object.spec.jobTemplate.spec.template.spec",
    )
    return json.loads(raw)


def generate_pod_controller_rules(policy_doc: dict) -> list[dict]:
    """policymutation.go:353 GeneratePodControllerRule, returning the new
    rule dicts (instead of JSON patches against the policy object)."""
    apply_autogen, desired = can_auto_gen(policy_doc)
    annotations = ((policy_doc.get("metadata") or {}).get("annotations")) or {}
    controllers = annotations.get(POD_CONTROLLERS_ANNOTATION)
    if controllers is None or not apply_autogen:
        controllers = desired
    if controllers == "none":
        return []

    out = []
    existing = {
        r.get("name") for r in ((policy_doc.get("spec") or {}).get("rules") or [])
    }
    for rule in ((policy_doc.get("spec") or {}).get("rules") or []):
        gen = generate_rule_for_controllers(rule, _strip_cronjob(controllers))
        if gen is not None and gen["name"] not in existing:
            out.append(gen)
        cron = generate_cronjob_rule(rule, controllers)
        if cron is not None and cron["name"] not in existing:
            out.append(cron)
    return out


def _strip_cronjob(controllers: str) -> str:
    parts = [c for c in controllers.split(",") if c != "CronJob"]
    return ",".join(parts)


def apply_defaults(policy_doc: dict) -> dict:
    """policymutation.go:25 GenerateJSONPatchesForDefaults (defaults half)."""
    doc = copy.deepcopy(policy_doc)
    spec = doc.setdefault("spec", {})
    spec.setdefault("validationFailureAction", "audit")
    spec.setdefault("background", True)
    spec.setdefault("failurePolicy", "Fail")
    return doc


def mutate_policy_for_autogen(policy: ClusterPolicy) -> ClusterPolicy:
    """The CLI/webhook policy mutation entry: defaults + autogen rules
    appended (common.go:177 MutatePolicy)."""
    doc = apply_defaults(policy.raw if policy.raw else _policy_to_doc(policy))
    new_rules = generate_pod_controller_rules(doc)
    if new_rules:
        doc["spec"]["rules"] = list(doc["spec"]["rules"]) + new_rules
    return load_policy(doc)


def _policy_to_doc(policy: ClusterPolicy) -> dict:
    return {
        "apiVersion": policy.api_version,
        "kind": policy.kind,
        "metadata": policy.metadata,
        "spec": {"rules": []},
    }
