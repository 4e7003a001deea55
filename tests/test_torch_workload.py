"""The workload plane on the port (``kyverno_tpu_torch/workload``: the
trace, the replay harness, the dry-run service, the chaos scenarios) and
the CLI's ``dryrun`` against the JAX package's, on the CPU.

- The JAX package's batteries ``tests/workload/test_trace.py``,
  ``test_replay.py``, ``test_dryrun.py`` and ``test_chaos.py``, case by
  case, on the port (``torch_parity.mirror_battery``; the JAX side of
  each case is the battery's own file). The edits are the port's: a
  stack, scanner or dry-run on ``device="cpu"``. The chaos battery's one
  end-to-end class keeps its ``slow`` marker.
- Both packages on the same seeded churn trace over 16 of the library's
  policies (enforce): the verdict digests, decisions and failing sets of
  the webhook, ``stream_json``, ``stream_row`` and background legs.
- ``dry_run``'s report on both packages, all but ``duration_s``: a new
  policy through the scanner's isolated compile, a loosened policy of a
  live name, and an explicit corpus through a one-shot compile.
- The CLI's ``dryrun`` through both packages' ``main``: exit codes and
  output, on a trace file and on a corpus file.
- A CPU rehearsal of ``chip_smoke.workload_phase`` at a small depth.
"""

import json
import os

import pytest

import chip_smoke
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.cli.__main__ import main as jax_cli
from kyverno_tpu.runtime import hostlane as jax_hostlane
from kyverno_tpu.runtime.background import BackgroundScanner as JaxScanner
from kyverno_tpu.workload import dryrun as jax_dryrun
from kyverno_tpu.workload import replay as jax_replay
from kyverno_tpu.workload import trace as jax_trace
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.cli.__main__ import main as torch_cli
from kyverno_tpu_torch.runtime import hostlane as torch_hostlane
from kyverno_tpu_torch.runtime.background import (
    BackgroundScanner as TorchScanner)
from kyverno_tpu_torch.workload import dryrun as torch_dryrun
from kyverno_tpu_torch.workload import replay as torch_replay
from kyverno_tpu_torch.workload import trace as torch_trace
from tests.torch_parity import (FLEET_SEED, count_plain_launches,
                                fleet_docs, fleet_trace, mirror_battery)
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

# the JAX package's workload batteries, on the port
for _relpath, _subs in (
        ("tests/workload/test_trace.py", ()),
        ("tests/workload/test_replay.py", (
            ("build_stack([load_policy(d) for d in _policy_docs()])",
             'build_stack([load_policy(d) for d in _policy_docs()], '
             'device="cpu")'),
            ("build_stack(pols)", 'build_stack(pols, device="cpu")'))),
        ("tests/workload/test_dryrun.py", (
            ("BackgroundScanner([load_policy(_baseline_doc())])",
             'BackgroundScanner([load_policy(_baseline_doc())], '
             'device="cpu")'),
            ("BackgroundScanner([])", 'BackgroundScanner([], device="cpu")'),
            ("dry_run(_candidate_doc(), scanner=None,",
             'dry_run(_candidate_doc(), scanner=None, device="cpu",'))),
        ("tests/workload/test_chaos.py", (
            ("delay_s=0.35, workers=6)",
             'delay_s=0.35, workers=6, device="cpu")'),
            ('workers=6, actions="0")',
             'workers=6, actions="0", device="cpu")')))):
    _exports = mirror_battery(_relpath, _subs)
    _clash = set(_exports) & set(globals())
    assert not _clash, (_relpath, _clash)
    globals().update(_exports)


@pytest.fixture(autouse=True)
def _detach_host_lane():
    """A stack's webhook attaches its oracle pool to its package's
    process-wide host lane: detach both after each case."""
    yield
    for mod in (jax_hostlane, torch_hostlane):
        mod.resolver().attach_pool(None, None)


DOCS = fleet_docs()


# ------------------------------------------------------------ the legs

LEGS = ("webhook", "stream_json", "stream_row", "background")


@pytest.fixture(scope="module")
def legs():
    """Every leg of both packages over one stack each, the same trace."""
    out = {}
    for side, replay, mod, load, kw in (
            ("jax", jax_replay, jax_trace, jax_load_policy, {}),
            ("torch", torch_replay, torch_trace, torch_load_policy,
             {"device": "cpu"})):
        stack = replay.build_stack([load(d) for d in DOCS], **kw)
        drv = replay.ReplayDriver.from_stack(stack)
        try:
            out[side] = {leg: drv.run(fleet_trace(mod), leg, workers=4)
                         for leg in LEGS}
        finally:
            stack["batcher"].stop()
            stack["webhook"].stop()
    return out


@pytest.mark.parametrize("leg", LEGS[:3])
def test_admission_leg_matches_jax(legs, leg):
    want, got = legs["jax"][leg], legs["torch"][leg]
    assert not got["errors"] and got["processed"] == want["processed"]
    assert got["verdict_digest"] == want["verdict_digest"]
    assert chip_smoke.decision_map(got) == chip_smoke.decision_map(want)
    assert got["failing_resources"] == want["failing_resources"]
    assert got["denied"] == want["denied"] > 0


def test_json_legs_agree_and_rows_escalate_host_cells(legs):
    """The webhook and JSON-frame legs answer alike; a ROW frame carries
    no body for the oracle, so every Pod row (the host-only policies
    give each a HOST cell) escalates, in both packages."""
    got = legs["torch"]
    assert got["webhook"]["verdict_digest"] == \
        got["stream_json"]["verdict_digest"]
    assert got["stream_row"]["denied"] == got["stream_row"]["events"]


def test_background_leg_matches_jax(legs):
    want, got = legs["jax"]["background"], legs["torch"]["background"]
    for k in ("events", "processed", "delta_scans", "rows_evaluated",
              "cols_evaluated", "violations", "failing_resources"):
        assert got[k] == want[k], k
    assert got["failing_resources"] == \
        legs["torch"]["webhook"]["failing_resources"]


# ----------------------------------------------------------- the dry-run

def _corpus():
    tr = torch_trace.synthesize(events=160, namespaces=4, name_pool=40,
                                distinct_bodies=16, seed=FLEET_SEED,
                                make_body=chip_smoke.fleet_body)
    live = {}
    for ev in tr.events:
        key = (ev.kind, ev.namespace, ev.name)
        if ev.op == "DELETE":
            live.pop(key, None)
        else:
            live[key] = tr.body_of(ev)
    return list(live.values())


LOOSE_LATEST = dict(DOCS[0], spec=dict(DOCS[0]["spec"], rules=[dict(
    DOCS[0]["spec"]["rules"][0], validate={
        "message": "anything goes",
        "pattern": {"spec": {"containers": [{"image": "*"}]}}})]))


@pytest.fixture(scope="module")
def scanners():
    resources = _corpus()
    j = JaxScanner([jax_load_policy(d) for d in DOCS])
    t = TorchScanner([torch_load_policy(d) for d in DOCS], device="cpu")
    j.scan(resources)
    t.scan(resources)
    return j, t, resources


def _without_duration(report: dict) -> dict:
    return {k: v for k, v in report.items() if k != "duration_s"}


@pytest.mark.parametrize("candidate,lane", [
    ("freeze", "incremental_isolated"), ("loose", "incremental_isolated"),
    ("freeze", "one_shot")])
def test_dry_run_report_matches_jax(scanners, candidate, lane):
    j, t, resources = scanners
    doc = chip_smoke.FREEZE_APP_3 if candidate == "freeze" else LOOSE_LATEST
    if lane == "one_shot":
        want = jax_dryrun.dry_run(doc, resources=resources, sample_limit=3)
        got = torch_dryrun.dry_run(doc, resources=resources, sample_limit=3,
                                   device="cpu")
    else:
        want = jax_dryrun.dry_run(doc, scanner=j, sample_limit=3)
        got = torch_dryrun.dry_run(doc, scanner=t, sample_limit=3)
    assert _without_duration(got) == _without_duration(want)
    assert got["compile_lane"] == lane
    if candidate == "freeze":
        assert sorted(got["newly_failing_resources"]) == \
            chip_smoke.planted_failures(resources)
        assert got["newly_failing"] > 0
    else:
        assert got["baseline_present"] and got["newly_passing"] > 0


def test_dry_run_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_dryrun.dry_run(chip_smoke.FREEZE_APP_3,
                             resources=_corpus()[:4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_replay.build_stack([torch_load_policy(DOCS[0])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_replay.build_fleet_stacks([torch_load_policy(DOCS[0])])


# --------------------------------------------------------------- the CLI

@pytest.mark.parametrize("source,json_out", [
    ("trace", False), ("trace", True), ("corpus", False), ("none", False)])
def test_cli_dryrun_matches_jax(tmp_path, capsys, source, json_out):
    cand = tmp_path / "candidate.yaml"
    cand.write_text(json.dumps(chip_smoke.FREEZE_APP_3))   # JSON is YAML
    argv = ["dryrun", str(cand), "--samples", "2"]
    if source == "trace":
        path = tmp_path / "trace.jsonl"
        torch_trace.synthesize(events=160, namespaces=4, name_pool=40,
                               distinct_bodies=16, seed=FLEET_SEED,
                               make_body=chip_smoke.fleet_body
                               ).write_jsonl(str(path))
        argv += ["--trace", str(path)]
    elif source == "corpus":
        path = tmp_path / "corpus.json"
        path.write_text(json.dumps(_corpus()))
        argv += ["--corpus", str(path)]
    if json_out:
        argv.append("--json")
    out = {}
    for side, main, extra in (("jax", jax_cli, []),
                              ("torch", torch_cli, ["--device", "cpu"])):
        rc = main(argv + extra)
        captured = capsys.readouterr()
        out[side] = (rc, captured.out, captured.err)
    (jrc, jout, jerr), (trc, tout, terr) = out["jax"], out["torch"]
    assert trc == jrc == (2 if source == "none" else 1)
    if json_out:
        assert _without_duration(json.loads(tout)) == \
            _without_duration(json.loads(jout))
    else:
        assert tout == jout
        assert terr == jerr


def test_cli_dryrun_without_a_card_exits_2(tmp_path, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cand = tmp_path / "candidate.yaml"
    cand.write_text(json.dumps(chip_smoke.FREEZE_APP_3))
    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps(_corpus()[:4]))
    assert torch_cli(["dryrun", str(cand), "--corpus", str(corpus)]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# -------------------------------------------------------- the rehearsal

def test_chip_smoke_workload_phase_on_the_cpu(monkeypatch):
    count_plain_launches(monkeypatch)
    for k in ("KTPU_DRYRUN", "KTPU_REPLAY"):
        monkeypatch.delenv(k, raising=False)
    out = chip_smoke.workload_phase(chip_smoke._synth_policy_docs(25),
                                    events=48, corpus_events=300,
                                    corpus_min=250, device="cpu")
    assert out["corpus"] >= 250 and out["newly_failing"] > 0
    assert out["dry_launches"]["glob_nfa"] > 0
    assert set(out["legs"]) == {"webhook", "stream_json", "stream_row",
                                "stream_row device-decidable"}
    assert "KTPU_DRYRUN" not in os.environ
    assert torch_dryrun.scan_source() is None
