"""Differential fuzz harness backing the KT4xx certifier.

The certifier (:mod:`.certify`) proves tensor-vs-IR agreement over an
abstract domain; this module grounds the *shared* semantics against the
real engine: random policies x random resources are scored through the
production device path (the packed-blob kernel that webhook admissions,
``screen_row`` and ``evaluate_block`` all dispatch through) and through
the CPU oracle, asserting:

- **verdict parity** — every device-decided cell (device verdict !=
  HOST) equals the oracle verdict for the same (resource, rule);
- **message parity** — for device-decided FAIL cells, the oracle's
  denial message contains the rule's validate message verbatim (the
  text the device lane renders); rules the certifier flags KT403
  (variable substitution, anyPattern composition) are excused;
- **pipeline parity** — ``evaluate_pipelined`` returns the exact
  matrix of ``evaluate_device`` + oracle-resolved HOST cells;
- **stream parity** — a sample of cases rides the columnar streaming
  lane (``AdmissionBatcher.screen_row`` / ``evaluate_block``) and must
  produce the same clean/attention split as the verdict matrix.

Resource generation is biased toward the certifier's *incomplete*
regions: paths under list patterns, wildcard segments and boundary
values of every numeric/glob literal in the generated policies — the
cells KT404 marks as not statically certified are exactly the ones the
fuzzer leans on.

Any divergence maps back to a **KT401** diagnostic carrying a
greedily-minimized repro (policy set + resource JSON), so a fuzz
failure lands in the same triage stream as a certifier failure.

Run directly (``python -m kyverno_tpu_torch.analysis.difffuzz -n 1000``,
on the card) or through ``chip_smoke.py --analysis``. Every entry takes
``device``: ``None`` is ``cuda`` (no card: the first compiled set
raises), ``"cpu"`` runs the kernels' plain versions. Engine imports stay
inside functions: importing this module does not pull torch.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from dataclasses import dataclass, field

from .diagnostics import Diagnostic, make

_KINDS = ("Pod", "Deployment", "Scale")

# (path tuple, value domain) — the scalar surface the generator wires
# into patterns, deny conditions and resources alike
_SCALAR_PATHS = (
    (("spec", "hostNetwork"), "bool"),
    (("spec", "replicas"), "int"),
    (("spec", "schedulerName"), "str"),
    (("spec", "priorityClassName"), "str"),
    (("spec", "terminationGracePeriodSeconds"), "int"),
    (("metadata", "labels", "app"), "str"),
)

_STR_LITERALS = ("nginx", "redis", "kube-scheduler", "web-app", "")
_STR_PATTERNS = ("nginx", "nginx*", "!nginx*", "?edis", "web-*", "redis")
_INT_PATTERNS = (">5", "<5", ">=2", "<=8", "!3", 3, 0, 7)
_IMG_PATTERNS = ("!*:latest", "nginx:*", "*@sha256:*")
_IMG_VALUES = ("nginx:latest", "nginx:1.25", "redis:7",
               "img@sha256:abc", "busybox")


def _nested_set(doc: dict, path: tuple, value) -> None:
    cur = doc
    for seg in path[:-1]:
        cur = cur.setdefault(seg, {})
    cur[path[-1]] = value


def _pattern_value(rng: random.Random, kind: str):
    if kind == "bool":
        return rng.choice((True, False, "true", "false"))
    if kind == "int":
        return rng.choice(_INT_PATTERNS)
    return rng.choice(_STR_PATTERNS)


def _resource_value(rng: random.Random, kind: str):
    if kind == "bool":
        return rng.choice((True, False, "true", None))
    if kind == "int":
        return rng.choice((0, 3, 5, 6, 8, "5", 2.5, None, "many"))
    return rng.choice(_STR_LITERALS + (None, 42))


def gen_rule(rng: random.Random, i: int) -> dict:
    kinds = rng.choice((["Pod"], ["Pod"], ["Deployment"],
                        ["Pod", "Deployment"], ["*"], ["Scale"]))
    rule = {"name": f"r{i}", "match": {"resources": {"kinds": kinds}}}
    msg = (f"rule r{i} violated" if rng.random() > 0.15
           else f"rule r{i}: {{{{ request.object.metadata.name }}}}")
    style = rng.random()

    def one_pattern() -> dict:
        pat: dict = {}
        for path, dom in rng.sample(_SCALAR_PATHS, rng.randint(1, 3)):
            _nested_set(pat, path, _pattern_value(rng, dom))
        if rng.random() < 0.35:
            # list pattern — the certifier's KT404 territory, which is
            # exactly where the fuzzer must carry the load
            _nested_set(pat, ("spec", "containers"),
                        [{"image": rng.choice(_IMG_PATTERNS)}])
        return pat

    if style < 0.62:
        rule["validate"] = {"message": msg, "pattern": one_pattern()}
    elif style < 0.82:
        rule["validate"] = {"message": msg,
                            "anyPattern": [one_pattern(), one_pattern()]}
    else:
        conds = [{"key": rng.choice(("frozen", "live", "x")),
                  "operator": rng.choice(("Equals", "NotEquals")),
                  "value": rng.choice(("frozen", "live", "y"))}
                 for _ in range(rng.randint(1, 2))]
        block = "all" if rng.random() < 0.7 else "any"
        rule["validate"] = {"message": msg,
                            "deny": {"conditions": {block: conds}}}
    return rule


def gen_policy_docs(rng: random.Random, tag: int,
                    n_policies: int = 3) -> list[dict]:
    docs = []
    ridx = 0
    for p in range(n_policies):
        rules = []
        for _ in range(rng.randint(1, 3)):
            rules.append(gen_rule(rng, ridx))
            ridx += 1
        docs.append({
            "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": f"fuzz-{tag}-{p}"},
            "spec": {"validationFailureAction": "enforce",
                     "rules": rules}})
    return docs


def gen_resource(rng: random.Random, kind: str) -> dict:
    doc = {"apiVersion": "v1", "kind": kind,
           "metadata": {"name": f"res-{rng.randrange(1 << 30)}",
                        "namespace": "default"}}
    for path, dom in _SCALAR_PATHS:
        roll = rng.random()
        if roll < 0.3:
            continue  # leaf absent
        v = _resource_value(rng, dom)
        if roll < 0.36:
            # type poke: a mapping/list where a scalar is expected
            v = rng.choice(({"nested": 1}, [1, 2]))
        _nested_set(doc, path, v)
    if rng.random() < 0.6:
        n = rng.randint(0, 3)
        _nested_set(doc, ("spec", "containers"),
                    [{"name": f"c{j}", "image": rng.choice(_IMG_VALUES)}
                     for j in range(n)])
    return doc


# ---------------------------------------------------------------------------


@dataclass
class Divergence:
    leg: str                 # verdict|message|pipeline|stream-row|stream-block
    policy: str
    rule: str
    rule_index: int
    device: str
    host: str
    resource: dict
    policy_docs: list
    detail: str = ""

    def to_repro(self) -> dict:
        return {"leg": self.leg, "policy": self.policy, "rule": self.rule,
                "device": self.device, "host": self.host,
                "detail": self.detail, "resource": self.resource,
                "policies": self.policy_docs}


def divergence_to_diagnostic(d: Divergence) -> Diagnostic:
    return make(
        "KT401",
        f"fuzz divergence on the {d.leg} leg: device={d.device} "
        f"host={d.host}; repro: {json.dumps(d.to_repro(), default=str)}",
        policy=d.policy, rule=d.rule, component="difffuzz")


@dataclass
class FuzzReport:
    cases: int = 0
    device_cells: int = 0
    escalated_cells: int = 0
    messages_checked: int = 0
    stream_rows: int = 0
    # K6 dispatches of the stream leg's compiled set (its own
    # ``donation_stats``): the rows and the block reached the card
    stream_dispatches: int = 0
    # the stream leg batcher's screens that gave up at their deadline
    # (``stream_timeout``), the times its breaker opened
    # (``circuit_open``) and the rows the open breaker turned away
    # (``oracle``): each answers ATTENTION with no verdict row, which the
    # clean/attention split alone cannot tell from a device verdict
    stream_timeouts: int = 0
    stream_circuit_open: int = 0
    stream_refused: int = 0
    divergences: list = field(default_factory=list)

    def ok(self) -> bool:
        return not self.divergences

    def diagnostics(self) -> list:
        return [divergence_to_diagnostic(d) for d in self.divergences]


def _kt403_excused(ref) -> bool:
    """Rules whose message the certifier already flags as
    device-unrenderable (KT403) are excused from message parity."""
    v = ref.rule.validation
    msg = v.message or ""
    return "{{" in msg or "$(" in msg or len(v.any_pattern or ()) > 1


def minimize(cps, resource: dict, row: int, reproduce) -> dict:
    """Greedy structural shrink: drop subtrees of ``resource`` while
    ``reproduce(candidate)`` still observes the divergence."""
    def paths(doc, prefix=()):
        out = []
        if isinstance(doc, dict):
            for k, v in doc.items():
                out.append(prefix + (k,))
                out.extend(paths(v, prefix + (k,)))
        elif isinstance(doc, list):
            for j, v in enumerate(doc):
                out.append(prefix + (j,))
                out.extend(paths(v, prefix + (j,)))
        return out

    def without(doc, path):
        clone = json.loads(json.dumps(doc, default=str))
        cur = clone
        try:
            for seg in path[:-1]:
                cur = cur[seg]
            del cur[path[-1]]
        except (KeyError, IndexError, TypeError):
            return None
        return clone

    current = resource
    for _ in range(4):  # a few passes; deletions enable deletions
        shrunk = False
        for path in sorted(paths(current), key=len, reverse=True):
            if path[:1] == ("kind",) or path[:1] == ("apiVersion",):
                continue
            cand = without(current, path)
            if cand is None:
                continue
            try:
                if reproduce(cand):
                    current = cand
                    shrunk = True
            except Exception:
                continue
        if not shrunk:
            break
    return current


def _expected_matrix(cps, resources, dv):
    """evaluate_device verdicts with HOST cells resolved by the oracle —
    the reference for the pipelined-path comparison."""
    import numpy as np

    from ..models.engine import Verdict

    out = np.array(dv, copy=True)
    for b, resource in enumerate(resources):
        host_rows = [r for r in range(dv.shape[1])
                     if dv[b, r] == Verdict.HOST]
        if not host_rows:
            continue
        oracle = cps._oracle_verdicts(resource, host_rows)
        for r, (v, _) in oracle.items():
            out[b, r] = int(v)
    return out


def _fuzz_set(rng: random.Random, tag: int, batch: int, n_batches: int,
              report: FuzzReport, check_pipeline: bool,
              device=None) -> None:
    from ..api.load import load_policy
    from ..models.engine import CompiledPolicySet, Verdict

    docs = gen_policy_docs(rng, tag)
    policies = [load_policy(d) for d in docs]
    cps = CompiledPolicySet(policies, device=device)
    n_rules = len(cps.rule_refs)
    kinds = list(_KINDS)

    for bi in range(n_batches):
        resources = [gen_resource(rng, rng.choice(kinds))
                     for _ in range(batch)]
        dv = cps.evaluate_device(cps.flatten(resources))
        report.cases += len(resources)
        for b, resource in enumerate(resources):
            oracle = cps._oracle_verdicts(resource, list(range(n_rules)))
            for r in range(n_rules):
                d = int(dv[b, r])
                hv, hmsg = oracle[r]
                if d == int(Verdict.HOST):
                    report.escalated_cells += 1
                    continue
                report.device_cells += 1
                ref = cps.rule_refs[r]
                if d != int(hv):
                    def reproduce(cand, _r=r, _d=d, _hv=hv):
                        cdv = cps.evaluate_device(cps.flatten([cand]))
                        if int(cdv[0, _r]) != _d:
                            return False
                        co = cps._oracle_verdicts(cand, [_r])
                        return int(co[_r][0]) == int(_hv)
                    small = minimize(cps, resource, r, reproduce)
                    report.divergences.append(Divergence(
                        "verdict", ref.policy.name, ref.rule.name, r,
                        Verdict(d).name, Verdict(int(hv)).name, small,
                        docs))
                    continue
                if d == int(Verdict.FAIL) and not _kt403_excused(ref):
                    report.messages_checked += 1
                    dev_msg = ref.rule.validation.message or ""
                    if dev_msg and dev_msg not in (hmsg or ""):
                        report.divergences.append(Divergence(
                            "message", ref.policy.name, ref.rule.name,
                            r, repr(dev_msg), repr(hmsg), resource,
                            docs))
        if check_pipeline and bi % 3 == 0 and len(resources) > 4:
            import numpy as np

            expect = _expected_matrix(cps, resources, dv)
            got = cps.evaluate_pipelined(resources, chunk=8)
            if not np.array_equal(np.asarray(got), expect):
                bad = np.argwhere(np.asarray(got) != expect)
                b, r = (int(x) for x in bad[0])
                ref = cps.rule_refs[r]
                report.divergences.append(Divergence(
                    "pipeline", ref.policy.name, ref.rule.name, r,
                    Verdict(int(got[b, r])).name,
                    Verdict(int(expect[b, r])).name, resources[b], docs,
                    detail=f"{len(bad)} mismatched cell(s)"))
        if len(report.divergences) >= 8:
            return  # enough witnesses; stop burning the budget


def _fuzz_stream_leg(rng: random.Random, report: FuzzReport,
                     rows: int = 12, device=None) -> None:
    """Drive a fuzz corpus through the columnar streaming lane and check
    the clean/attention split against the verdict matrix."""
    from ..api.load import load_policy
    from ..models.engine import Verdict
    from ..runtime.batch import ATTENTION, CLEAN, AdmissionBatcher
    from ..runtime.policycache import PolicyCache, PolicyType
    from ..runtime.stream_server import (flatten_block_for_wire,
                                         flatten_rows_for_wire)

    docs = gen_policy_docs(rng, tag=999)
    cache = PolicyCache(device=device)
    for d in docs:
        cache.add(load_policy(d))
    batcher = AdmissionBatcher(cache, window_s=0.002, burst_threshold=1,
                               dispatch_cost_init_s=0.0,
                               oracle_cost_init_s=1.0,
                               cold_flush_fallback=False,
                               result_cache_ttl_s=0.0)
    try:
        cps = cache.compiled(PolicyType.VALIDATE_ENFORCE, "Pod", "default")
        if not cps.policies:
            return
        pods = [gen_resource(rng, "Pod") for _ in range(rows)]
        dv = cps.evaluate_device(cps.flatten(pods))
        clean = [bool(all(int(v) in (int(Verdict.PASS), int(Verdict.SKIP),
                                     int(Verdict.NOT_APPLICABLE))
                          for v in dv[b])) for b in range(len(pods))]
        wire = flatten_rows_for_wire(cps, pods)
        for i, row in enumerate(wire):
            status, _ = batcher.screen_row(
                PolicyType.VALIDATE_ENFORCE, "Pod", "default", row)
            report.stream_rows += 1
            expect = CLEAN if clean[i] else ATTENTION
            if status != expect:
                report.divergences.append(Divergence(
                    "stream-row", "", "", -1, status, expect, pods[i],
                    docs))
        block = flatten_block_for_wire(cps, pods)
        out = batcher.evaluate_block(
            PolicyType.VALIDATE_ENFORCE, "Pod", "default", block)
        if out is None or len(out) != len(pods):
            report.divergences.append(Divergence(
                "stream-block", "", "", -1,
                f"{None if out is None else len(out)} rows",
                f"{len(pods)} rows", {}, docs))
        else:
            for i, (status, _) in enumerate(out):
                report.stream_rows += 1
                expect = CLEAN if clean[i] else ATTENTION
                if status != expect:
                    report.divergences.append(Divergence(
                        "stream-block", "", "", -1, status, expect,
                        pods[i], docs))
        report.stream_dispatches = cps.donation_stats["dispatches"]
        report.stream_timeouts = batcher.stats.get("stream_timeout", 0)
        report.stream_circuit_open = batcher.stats.get("circuit_open", 0)
        report.stream_refused = batcher.stats.get("oracle", 0)
    finally:
        batcher.stop()


def run_fuzz(cases: int = 1000, seed: int = 20260805, batch: int = 24,
             stream_leg: bool = True,
             check_pipeline: bool = True, device=None) -> FuzzReport:
    """Run the differential fuzz until ~``cases`` resources scored, on
    ``device`` (``None``: the card)."""
    rng = random.Random(seed)
    report = FuzzReport()
    tag = 0
    per_set = max(1, cases // (4 * batch))
    while report.cases < cases and len(report.divergences) < 8:
        _fuzz_set(rng, tag, batch, per_set, report, check_pipeline,
                  device)
        tag += 1
    if stream_leg and not report.divergences:
        _fuzz_stream_leg(rng, report, device=device)
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="differential device-vs-host fuzz (KT401 on "
                    "divergence)")
    ap.add_argument("-n", "--cases", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=20260805)
    ap.add_argument("--no-stream", action="store_true")
    args = ap.parse_args(argv)
    report = run_fuzz(cases=args.cases, seed=args.seed,
                      stream_leg=not args.no_stream)
    print(f"difffuzz: {report.cases} cases, {report.device_cells} "
          f"device-decided cells, {report.escalated_cells} escalated, "
          f"{report.messages_checked} messages checked, "
          f"{report.stream_rows} stream rows "
          f"({report.stream_dispatches} K6 dispatches)")
    for d in report.diagnostics():
        print(d.format())
    if not report.ok():
        print(f"difffuzz: {len(report.divergences)} divergence(s)",
              file=sys.stderr)
        return 1
    print("difffuzz: device and host agree on every decided cell")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
