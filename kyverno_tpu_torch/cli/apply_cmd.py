"""``apply`` verb (mirrors kyverno/pkg/kyverno/apply/apply_command.go)."""

from __future__ import annotations

import json
import os
import sys

from .. import store
from ..api.load import load_policies_from_path, load_resources
from ..engine.response import RuleStatus
from .common import ResultCounts, apply_policy_on_resource
from .values import Values, load_values_file, parse_set


def run(args) -> int:
    if not args.policies:
        print("requires at least one policy path", file=sys.stderr)
        return 2
    if not args.resource:
        print("resource file(s) required (-r)", file=sys.stderr)
        return 2

    values = Values()
    if args.values_file:
        values = load_values_file(args.values_file)
    if args.set:
        values.set_values = parse_set(args.set)

    policies = []
    for path in args.policies:
        policies.extend(load_policies_from_path(path))
    resources = []
    for path in args.resource:
        resources.extend(load_resources(path))
    if args.namespace:
        resources = [
            r for r in resources
            if (r.get("metadata") or {}).get("namespace", "") == args.namespace
        ]

    # autogen mutation of incoming policies (common.go:177 MutatePolicy)
    from ..policy.autogen import mutate_policy_for_autogen

    policies = [mutate_policy_for_autogen(p) for p in policies]

    store.set_mock(True)
    values.install_mock_store()
    rc = ResultCounts()
    mutated_resources = []
    try:
        for resource in resources:
            patched = resource
            for policy in policies:
                result = apply_policy_on_resource(
                    policy,
                    patched,
                    variables=values.for_resource(
                        policy.name, (resource.get("metadata") or {}).get("name", "")
                    ),
                    namespace_labels_map=values.namespace_selectors,
                    rc=rc,
                )
                if result.mutate_response is not None:
                    patched = result.mutate_response.patched_resource or patched
                vr = result.validate_response
                if vr is not None:
                    for r in vr.policy_response.rules:
                        if r.status in (RuleStatus.FAIL, RuleStatus.ERROR):
                            res_meta = resource.get("metadata") or {}
                            print(
                                f"policy {policy.name} -> resource "
                                f"{res_meta.get('namespace', 'default')}/"
                                f"{resource.get('kind')}/{res_meta.get('name')}"
                                f" failed: \n{_indent(r.message)}"
                            )
            mutated_resources.append(patched)
    finally:
        store.set_mock(False)
        store.set_context(store.Context())

    if args.output:
        _write_mutated(mutated_resources, args.output)
    elif any(p != r for p, r in zip(mutated_resources, resources)):
        import yaml

        for patched in mutated_resources:
            print("---")
            print(yaml.safe_dump(patched, sort_keys=False).rstrip())

    print(
        f"\npass: {rc.pass_}, fail: {rc.fail}, warn: {rc.warn}, "
        f"error: {rc.error}, skip: {rc.skip}"
    )
    if args.policy_report:
        print(json.dumps(_policy_report(rc)))
    return 1 if rc.fail or rc.error else 0


def _indent(msg: str) -> str:
    return "\n".join("  " + line for line in (msg or "").splitlines()) or "  (no message)"


def _write_mutated(resources: list[dict], output: str) -> None:
    import yaml

    if os.path.isdir(output):
        for resource in resources:
            name = (resource.get("metadata") or {}).get("name", "resource")
            path = os.path.join(output, f"{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(resource, f, sort_keys=False)
    else:
        with open(output, "w") as f:
            for resource in resources:
                f.write("---\n")
                yaml.safe_dump(resource, f, sort_keys=False)


def _policy_report(rc: ResultCounts) -> dict:
    """--policy-report summary (wgpolicyk8s.io/v1alpha2 shape)."""
    return {
        "apiVersion": "wgpolicyk8s.io/v1alpha2",
        "kind": "ClusterPolicyReport",
        "metadata": {"name": "clusterpolicyreport"},
        "summary": {
            "pass": rc.pass_,
            "fail": rc.fail,
            "warn": rc.warn,
            "error": rc.error,
            "skip": rc.skip,
        },
    }


def register(subparsers) -> None:
    p = subparsers.add_parser("apply", help="applies policies on resources")
    p.add_argument("policies", nargs="*", help="policy YAML paths")
    p.add_argument("-r", "--resource", action="append", default=[],
                   help="path to resource files")
    p.add_argument("-o", "--output", default="",
                   help="prints mutated resources to file/directory")
    p.add_argument("-s", "--set", default="", help="variables key=value[,k=v]")
    p.add_argument("-f", "--values-file", default="",
                   help="file containing values for policy variables")
    p.add_argument("--policy-report", action="store_true",
                   help="emit a PolicyReport summary")
    p.add_argument("-n", "--namespace", default="", help="namespace filter")
    p.set_defaults(func=run)
