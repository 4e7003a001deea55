"""``lint`` verb: static analysis over policy YAML (kyverno_tpu_torch/analysis).

Host-only by construction — compiles rule IR and tensors with numpy and
never imports torch, so it runs in CI images without the accelerator
stack. Exit code: 0 clean (relative to ``--fail-on``), 1 diagnostics at
or above the threshold, 2 usage/load errors.
"""

from __future__ import annotations

import json
import os
import sys

from ..analysis import Severity, analyze_policies, parse_suppressions
from ..api.load import load_policies_from_path

_FAIL_LEVELS = {
    "error": Severity.ERROR,
    "warning": Severity.WARNING,
    "info": Severity.INFO,
    "never": None,
}

# --self target: the analyzer lints the policies its own test battery
# ships, proving the CLI wiring end to end with no arguments
SELF_POLICY_DIR = "tests/policies"


def _self_dir() -> str:
    if os.path.isdir(SELF_POLICY_DIR):
        return SELF_POLICY_DIR
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, SELF_POLICY_DIR)


def run(args) -> int:
    paths = list(args.paths)
    if args.self_check:
        paths.append(_self_dir())
    if not paths:
        print("requires at least one policy path (or --self)",
              file=sys.stderr)
        return 2

    policies = []
    for path in paths:
        try:
            policies.extend(load_policies_from_path(path))
        except OSError as e:
            print(f"lint: cannot load {path}: {e}", file=sys.stderr)
            return 2
    if not policies:
        print("lint: no policies found", file=sys.stderr)
        return 2

    suppress = parse_suppressions(args.suppress or "")
    report = analyze_policies(policies,
                              include_tensors=not args.no_tensors,
                              suppress=suppress)

    certify_counts = None
    if args.certify:
        from ..analysis.certify import certify_policies

        cert = certify_policies(policies)
        report.diagnostics += [d for d in cert.diagnostics
                               if d.code not in suppress]
        certify_counts = cert.counts()
        certify_counts["states_checked"] = cert.states_checked
        certify_counts["escalation_cells"] = cert.escalation_cells

    if args.json:
        out = report.to_dict()
        if certify_counts is not None:
            out["certification"] = certify_counts
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        for d in sorted(report.diagnostics,
                        key=lambda d: (-d.severity, d.policy, d.rule, d.code)):
            print(d.format())
        counts = {s: len(report.by_severity(s)) for s in Severity}
        print(f"lint: {len(policies)} policies, "
              f"{counts[Severity.ERROR]} errors, "
              f"{counts[Severity.WARNING]} warnings, "
              f"{counts[Severity.INFO]} info")
        if certify_counts is not None:
            summary = ", ".join(
                f"{k}={v}" for k, v in sorted(certify_counts.items()))
            print(f"certify: {summary}")

    threshold = _FAIL_LEVELS[args.fail_on]
    if threshold is None:
        return 0
    worst = report.max_severity()
    return 1 if worst is not None and worst >= threshold else 0


def register(subparsers) -> None:
    p = subparsers.add_parser(
        "lint", help="statically analyze policies (escalation provenance, "
        "reachability, tensor invariants)")
    p.add_argument("paths", nargs="*", help="policy YAML files/directories")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as JSON")
    p.add_argument("--fail-on", choices=sorted(_FAIL_LEVELS), default="error",
                   help="minimum severity that makes the exit code "
                   "non-zero (default: error)")
    p.add_argument("--suppress", default="",
                   help="comma-separated diagnostic codes to drop "
                   "(e.g. KT202,KT110)")
    p.add_argument("--no-tensors", action="store_true",
                   help="skip the PolicyTensors invariant pass")
    p.add_argument("--certify", action="store_true",
                   help="run the KT4xx cross-layer certifier (device "
                   "tensor program vs host IR walk over an abstract "
                   "resource domain)")
    p.add_argument("--self", dest="self_check", action="store_true",
                   help="lint the repo's own sample policies "
                   f"({SELF_POLICY_DIR}) as a smoke check")
    p.set_defaults(func=run)
