"""``test`` verb: declarative snapshot tests.

Mirrors kyverno/pkg/kyverno/test/test_command.go: a ``test.yaml``
declares policies, resources, optional variables file, and expected
per-(policy, rule, resource) statuses; the engine replays them and diffs.
"""

from __future__ import annotations

import os
import sys

from .. import store
from ..api.load import load_policies_from_path, load_resources
from ..engine.response import RuleStatus
from ..policy.autogen import mutate_policy_for_autogen
from .common import apply_policy_on_resource
from .values import Values, load_values_file

TEST_FILE_NAMES = ("test.yaml", "kyverno-test.yaml")


def run(args) -> int:
    failures = 0
    ran = 0
    for test_dir in args.paths or ["."]:
        if is_git_url(test_dir):
            test_dir = clone_git_source(test_dir, args.git_branch)
            if test_dir is None:
                # a corpus the caller named but we couldn't fetch is a
                # failure, not a silent skip — CI must go red
                failures += 1
                continue
        for test_file in _find_test_files(test_dir):
            ran += 1
            failures += run_test_file(test_file, verbose=not args.quiet)
    if ran == 0:
        print("no test yamls available", file=sys.stderr)
        return 2
    return 1 if failures else 0


def is_git_url(path: str) -> bool:
    """Git sources the way the reference CLI takes them
    (pkg/kyverno/test/git.go:14 — the public-policies regression replay
    clones https URLs; file:// and .git paths work offline)."""
    return (path.startswith(("https://", "http://", "git://", "ssh://",
                             "file://"))
            or path.endswith(".git"))


def clone_git_source(url: str, branch: str = "") -> str | None:
    """Shallow-clone a git test source into a temp dir; returns the
    checkout path (cleaned up at process exit), or None on failure."""
    import atexit
    import shutil
    import subprocess
    import tempfile

    dest = tempfile.mkdtemp(prefix="kyverno-test-git-")
    atexit.register(shutil.rmtree, dest, ignore_errors=True)
    cmd = ["git", "clone", "--depth", "1"]
    if branch:
        cmd += ["--branch", branch]
    cmd += [url, dest]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        stderr = e.stderr.decode(errors="replace").strip()
        print(f"failed to clone {url}: {stderr}", file=sys.stderr)
        return None
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"failed to clone {url}: {e}", file=sys.stderr)
        return None
    return dest


def _find_test_files(root: str) -> list[str]:
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            if name in TEST_FILE_NAMES:
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def run_test_file(path: str, verbose: bool = True) -> int:
    """Returns the number of mismatched results."""
    import yaml

    base = os.path.dirname(path)
    with open(path) as f:
        doc = yaml.safe_load(f) or {}

    policies = []
    for rel in doc.get("policies") or []:
        policies.extend(load_policies_from_path(os.path.join(base, rel)))
    resources = []
    for rel in doc.get("resources") or []:
        resources.extend(load_resources(os.path.join(base, rel)))

    values = Values()
    if doc.get("variables"):
        values = load_values_file(os.path.join(base, doc["variables"]))

    policies = [mutate_policy_for_autogen(p) for p in policies]

    # build actual results table (test_command.go:347 buildPolicyResults);
    # records carry namespace/kind so same-named resources are distinct
    records: list[dict] = []
    store.set_mock(True)
    values.install_mock_store()
    try:
        for resource in resources:
            res_meta = resource.get("metadata") or {}
            res_name = res_meta.get("name", "")
            for policy in policies:
                result = apply_policy_on_resource(
                    policy,
                    resource,
                    variables=values.for_resource(policy.name, res_name),
                    namespace_labels_map=values.namespace_selectors,
                )
                patched = (
                    result.mutate_response.patched_resource
                    if result.mutate_response is not None else None
                )
                for resp in result.responses:
                    for rr in resp.policy_response.rules:
                        records.append({
                            "policy": policy.name,
                            "policy_ns": policy.namespace,
                            "rule": rr.name,
                            "resource": res_name,
                            "namespace": res_meta.get("namespace", ""),
                            "kind": resource.get("kind", ""),
                            "type": rr.type,
                            "status": rr.status.value,
                            "patched": patched,
                        })
    finally:
        store.set_mock(False)
        store.set_context(store.Context())

    def lookup(policy: str, rule: str, resource: str, namespace: str, kind: str):
        for r in records:
            if r["rule"] != rule or r["resource"] != resource:
                continue
            if r["policy"] != policy and f"{r['policy_ns']}/{r['policy']}" != policy:
                continue
            if namespace and r["namespace"] and r["namespace"] != namespace:
                continue
            if kind and r["kind"] and r["kind"] != kind:
                continue
            return r
        return None

    mismatches = 0
    rows = []
    for want in doc.get("results") or []:
        want_status = want.get("status") or want.get("result") or ""
        base_key = (
            want.get("policy", ""), want.get("rule", ""), want.get("resource", ""),
            want.get("namespace", ""), want.get("kind", ""),
        )
        # a rule absent from the response means "didn't match" -> skip; an
        # autogen twin's result substitutes (test_command.go:391-407)
        record = None
        for prefix in ("", "autogen-", "autogen-cronjob-"):
            record = lookup(base_key[0], prefix + base_key[1], *base_key[2:])
            if record is not None:
                break
        got_status = record["status"] if record else "skip"

        if want.get("patchedResource") and record is not None:
            got_status = _check_patched_resource(base, want, record)

        ok = got_status == want_status
        mismatches += 0 if ok else 1
        rows.append((base_key[:3], want_status, got_status, ok))

    if verbose:
        print(f"\nTest: {doc.get('name', path)} ({path})")
        for (policy, rule, resource), want, got, ok in rows:
            mark = "Pass" if ok else f"Fail (got {got or 'no result'!r})"
            print(f"  {policy} / {rule} / {resource} -> {want}: {mark}")
        total = len(rows)
        print(f"  {total - mismatches}/{total} passed")
    return mismatches


def _check_patched_resource(base, want, record) -> str:
    """test_command.go:534: mutate rule outcome = skip if the rule skipped,
    else the patchedResource comparison decides pass/fail."""
    if record["status"] == "skip":
        return "skip"
    import yaml

    try:
        with open(os.path.join(base, want["patchedResource"])) as f:
            expected = yaml.safe_load(f)
    except OSError:
        return "error"
    return "pass" if record["patched"] == expected else "fail"


def register(subparsers) -> None:
    p = subparsers.add_parser("test", help="run declarative policy tests")
    p.add_argument("paths", nargs="*",
                   help="dirs containing test.yaml, or git URLs to clone "
                        "(https://..., file://..., *.git)")
    p.add_argument("-b", "--git-branch", default="",
                   help="branch to clone when a path is a git URL")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(func=run)
