"""``dryrun`` verb: blast radius of a candidate policy before rollout.

Two modes share the report schema (workload/dryrun.py):

- ``--url http://host:port`` POSTs the candidate to a running server's
  ``/debug/dryrun`` — the report reflects the server's *live* scan
  corpus.
- offline (default): the corpus comes from ``--trace`` (a workload
  JSONL trace replayed to its final resource set — CREATE/UPDATE upsert,
  DELETE removes) or ``--corpus`` (a JSON list of resource bodies), and
  evaluation runs in-process, on the card unless ``--device cpu`` asks
  for the kernels' plain versions on the CPU.

Exit code: 0 when the candidate newly fails nothing, 1 when it has a
blast radius (so a rollout pipeline can gate on it), 2 on usage/load
errors. Requires KTPU_DRYRUN=1 (the default) in the evaluating process.
"""

from __future__ import annotations

import json
import sys


def _load_candidate(path: str) -> dict:
    from ..api.load import load_policies_from_path

    policies = load_policies_from_path(path)
    if len(policies) != 1:
        raise ValueError(f"{path}: expected exactly one policy, "
                         f"found {len(policies)}")
    return policies[0].raw


def _corpus_from_trace(path: str) -> list[dict]:
    from ..workload.trace import WorkloadTrace

    tr = WorkloadTrace.read_jsonl(path)
    live: dict[tuple, dict] = {}
    for ev in tr.events:
        if ev.op == "POLICY":
            continue
        key = (ev.kind, ev.namespace, ev.name)
        if ev.op == "DELETE":
            live.pop(key, None)
        else:
            live[key] = tr.body_of(ev)
    return list(live.values())


def run(args) -> int:
    try:
        doc = _load_candidate(args.policy)
    except (OSError, ValueError) as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2

    if args.url:
        import urllib.request

        req = urllib.request.Request(
            args.url.rstrip("/") + "/debug/dryrun",
            data=json.dumps({"policy": doc,
                             "sample_limit": args.samples}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=args.timeout) as resp:
                report = json.loads(resp.read())
        except Exception as e:
            detail = ""
            body = getattr(e, "read", lambda: b"")()
            if body:
                detail = f": {body.decode('utf-8', 'replace')[:200]}"
            print(f"dryrun: {args.url}: {e}{detail}", file=sys.stderr)
            return 2
    else:
        from ..workload.dryrun import DryRunDisabled, dry_run

        try:
            if args.trace:
                resources = _corpus_from_trace(args.trace)
            elif args.corpus:
                with open(args.corpus) as f:
                    resources = json.load(f)
            else:
                print("dryrun: offline mode needs --trace or --corpus "
                      "(or point --url at a running server)",
                      file=sys.stderr)
                return 2
            report = dry_run(doc, resources=resources,
                             sample_limit=args.samples,
                             device=args.device)
        except DryRunDisabled as e:
            print(f"dryrun: {e}", file=sys.stderr)
            return 2
        except RuntimeError as e:
            # no card and no --device cpu (models.engine.resolve_device)
            print(f"dryrun: {e}", file=sys.stderr)
            return 2
        except (OSError, ValueError) as e:
            print(f"dryrun: {e}", file=sys.stderr)
            return 2

    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        dd = report.get("device_decidability") or {}
        print(f"dryrun: {report.get('policy')} over "
              f"{report.get('resources_evaluated')} resources: "
              f"{report.get('newly_failing')} newly failing, "
              f"{report.get('newly_passing')} newly passing "
              f"(device fraction "
              f"{dd.get('device_fraction', 1.0)})")
        for ns, counts in sorted(
                (report.get("per_namespace") or {}).items()):
            print(f"  {ns or '<cluster>'}: "
                  f"+{counts.get('newly_failing', 0)} failing, "
                  f"-{counts.get('newly_passing', 0)} passing")
        for s in report.get("samples") or []:
            print(f"  sample: {s['namespace']}/{s['name']} "
                  f"rule={s['rule']}: {s['message']}")
    return 1 if report.get("newly_failing") else 0


def register(subparsers) -> None:
    p = subparsers.add_parser(
        "dryrun", help="blast-radius report for a candidate policy "
        "(no live decisions touched)")
    p.add_argument("policy", help="candidate policy YAML (one policy)")
    p.add_argument("--url", default="",
                   help="running server base URL; POSTs /debug/dryrun "
                   "against its live scan corpus")
    p.add_argument("--trace", default="",
                   help="workload JSONL trace; its final live set is "
                   "the corpus (offline mode)")
    p.add_argument("--corpus", default="",
                   help="JSON file with a list of resource bodies "
                   "(offline mode)")
    p.add_argument("--samples", type=int, default=5,
                   help="sample violating resources in the report")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="HTTP timeout for --url mode")
    p.add_argument("--device", default=None,
                   help="offline mode: where the candidate runs (cuda, "
                   "the default, or cpu)")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as JSON")
    p.set_defaults(func=run)
