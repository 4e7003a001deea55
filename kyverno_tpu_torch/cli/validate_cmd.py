"""``validate`` verb: structural validation of policy YAMLs (the same
policy.Validate the /policyvalidate webhook runs; pkg/kyverno/validate)."""

from __future__ import annotations

import sys

from ..api.load import load_policies_from_path
from ..policy.validation import validate_policy


def run(args) -> int:
    if not args.policies:
        print("requires at least one policy path", file=sys.stderr)
        return 2
    rc = 0
    for path in args.policies:
        try:
            policies = load_policies_from_path(path)
        except Exception as e:
            print(f"Policy {path} is invalid: failed to load: {e}")
            rc = 1
            continue
        for policy in policies:
            errors = validate_policy(policy)
            if errors:
                rc = 1
                print(f"Policy {policy.name} is invalid:")
                for err in errors:
                    print(f"  - {err}")
            else:
                print(f"Policy {policy.name} is valid.")
    return rc


def register(subparsers) -> None:
    p = subparsers.add_parser("validate", help="validate policy YAML structure")
    p.add_argument("policies", nargs="*", help="policy YAML paths")
    p.set_defaults(func=run)
