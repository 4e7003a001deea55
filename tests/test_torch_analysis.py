"""The analysis plane on the port: the lint passes (KT1xx-KT3xx), the KT4xx
certifier, the KT5xx feature-lane lint, the differential fuzz, and the
hooks that use them (the certifier on an incremental refresh, the
admission lint, the SLO shed ranking by lint severity, the metrics
recorders and the compile-cache switches).

Two kinds of test:

- The JAX package's batteries, case by case, on the port
  (``torch_parity.mirror_battery``): ``tests/analysis/test_certify.py``,
  ``test_lint_escalation.py``, ``test_lint_invariants.py``,
  ``test_lint_reachability.py`` and ``test_featurelint.py``. The only
  edit: ``test_certify.py``'s ``run_fuzz`` call gains ``device="cpu"``
  (the port's entry points run on the card unless asked for the CPU).
  In ``test_featurelint.py`` the synthetic trees' package directory is
  ``kyverno_tpu_torch`` (the import rewrite makes it so), and the repo
  case scans the port's tree and its driver, ``chip_smoke.py``.
- Both packages on the same inputs: ``analyze_policies`` and
  ``certify_policies`` on every policy file of ``tests/policies``, the
  250-policy library and its autogen'd 670 rules; the fuzz generators;
  ``run_fuzz(cases=48)``'s report; ``last_refresh_certify`` and the
  stamped ``ir.certified`` after the same refreshes; the admission
  lint's reports and gauges; the shed ranking with lint severities.
  ``chip_smoke.py``'s ``[analysis]`` pins are held to the JAX package's
  numbers here.
"""

import logging
import os
import random

import pytest

import chip_smoke
from kyverno_tpu.analysis import analyze_policies as jax_analyze
from kyverno_tpu.analysis import certify_policies as jax_certify
from kyverno_tpu.analysis import difffuzz as jax_fuzz
from kyverno_tpu.api.load import load_policy as jax_load_policy
from kyverno_tpu.models.engine import IncrementalCompiler as JaxCompiler
from kyverno_tpu.runtime import featureplane as jax_featureplane
from kyverno_tpu.runtime import metrics as jax_metrics
from kyverno_tpu.runtime import policycache as jax_policycache
from kyverno_tpu.runtime import sloactions as jax_sloactions
from kyverno_tpu_torch.analysis import analyze_policies as torch_analyze
from kyverno_tpu_torch.analysis import certify_policies as torch_certify
from kyverno_tpu_torch.analysis import difffuzz as torch_fuzz
from kyverno_tpu_torch.api.load import load_policy as torch_load_policy
from kyverno_tpu_torch.models.engine import IncrementalCompiler as TorchCompiler
from kyverno_tpu_torch.runtime import featureplane as torch_featureplane
from kyverno_tpu_torch.runtime import hostlane
from kyverno_tpu_torch.runtime import metrics as torch_metrics
from kyverno_tpu_torch.runtime import policycache as torch_policycache
from kyverno_tpu_torch.runtime import sloactions as torch_sloactions
from tests.test_torch_autogen import JAX_STEPS
from tests.torch_parity import corpus_docs, mirror_battery, policy_files
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

# the JAX batteries, on the port
for _relpath, _subs in (
        ("tests/analysis/test_certify.py", (
            ("run_fuzz(cases=60, seed=7, stream_leg=True)",
             'run_fuzz(cases=60, seed=7, stream_leg=True, device="cpu")'),)),
        ("tests/analysis/test_lint_escalation.py", ()),
        ("tests/analysis/test_lint_invariants.py", ()),
        ("tests/analysis/test_lint_reachability.py", ()),
        ("tests/analysis/test_featurelint.py", ())):
    _exports = mirror_battery(_relpath, _subs)
    _clash = set(_exports) & set(globals())
    assert not _clash, (_relpath, _clash)
    globals().update(_exports)


# ------------------------------------------------ both packages at once

CORPORA = [f"file:{os.path.basename(f)}" for f in policy_files()] + [
    "library250", "autogen670"]


def _policies(corpus: str, side: str) -> list:
    """The corpus's policies, loaded by one package (``autogen670``: the
    library through each package's policy webhook steps)."""
    if corpus == "autogen670":
        steps = JAX_STEPS if side == "jax" else chip_smoke.policy_steps()
        pols, errs = chip_smoke.autogen_policies(corpus_docs("library250"),
                                                 steps)
        assert not errs
        return pols
    load = jax_load_policy if side == "jax" else torch_load_policy
    return [load(d) for d in corpus_docs(corpus)]


@pytest.mark.parametrize("corpus", CORPORA)
def test_analyze_policies_equal_to_jax(corpus):
    got = torch_analyze(_policies(corpus, "torch")).to_dict()
    want = jax_analyze(_policies(corpus, "jax")).to_dict()
    assert got == want


@pytest.mark.parametrize("corpus", CORPORA)
def test_certify_policies_equal_to_jax(corpus):
    got = torch_certify(_policies(corpus, "torch"))
    want = jax_certify(_policies(corpus, "jax"))
    assert got.statuses == want.statuses
    assert got.counts() == want.counts()
    assert (got.states_checked, got.escalation_cells) == (
        want.states_checked, want.escalation_cells)
    assert [d.to_dict() for d in got.diagnostics] == [
        d.to_dict() for d in want.diagnostics]


@pytest.mark.parametrize("corpus,label", [("library250", "library 250"),
                                          ("autogen670", "autogen'd 670")])
def test_chip_smoke_analysis_pins_are_the_jax_packages(corpus, label):
    """``chip_smoke.py [analysis]`` holds the port on the card to these
    numbers: the JAX package's certify statuses and lint codes."""
    cert = jax_certify(_policies(corpus, "jax"))
    assert cert.counts() == chip_smoke.EXPECTED_CERTIFY[label]
    assert not cert.divergences
    codes = {}
    for d in jax_analyze(_policies(corpus, "jax")).diagnostics:
        codes[d.code] = codes.get(d.code, 0) + 1
    assert codes == chip_smoke.EXPECTED_LINT[label]


@pytest.mark.parametrize("seed", [0, 1, 7, 20260805])
def test_fuzz_generators_equal_to_jax(seed):
    a, b = random.Random(seed), random.Random(seed)
    assert torch_fuzz.gen_policy_docs(a, seed, n_policies=5) == \
        jax_fuzz.gen_policy_docs(b, seed, n_policies=5)
    for kind in ("Pod", "Deployment", "Scale") * 8:
        assert torch_fuzz.gen_resource(a, kind) == \
            jax_fuzz.gen_resource(b, kind)
    assert a.random() == b.random()


def test_run_fuzz_report_equal_to_jax():
    """48 cases (two batches of 24, one pipeline check, the stream leg)
    through the port's plain kernels and through the JAX package as its
    own tests run it: the same counts, no divergence, and the stream
    leg's rows dispatched through K6 on the port's set."""
    hostlane.host_cache().clear()
    got = torch_fuzz.run_fuzz(cases=48, device="cpu")
    want = jax_fuzz.run_fuzz(cases=48)
    fields = ("cases", "device_cells", "escalated_cells",
              "messages_checked", "stream_rows")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.ok() and want.ok(), [d.format() for d in got.diagnostics()]
    assert got.cases >= 48 and got.device_cells > 0 and got.stream_rows > 0
    assert got.stream_dispatches > 0


@pytest.mark.parametrize("stat,field", [
    ("stream_timeout", "stream_timeouts"),
    ("circuit_open", "stream_circuit_open"),
    ("oracle", "stream_refused")])
def test_run_fuzz_counts_stream_screens_without_a_verdict(monkeypatch, stat,
                                                          field):
    """A stream screen that gives up, or meets an open breaker, answers
    ATTENTION with no verdict row: the report counts each, from the stream
    leg batcher's own counters."""
    from kyverno_tpu_torch.runtime import batch as torch_batch

    def gave_up(self, *a, **k):
        with self._lock:
            self.stats[stat] = self.stats.get(stat, 0) + 1
        return torch_batch.ATTENTION, []

    monkeypatch.setattr(torch_batch.AdmissionBatcher, "screen_row", gave_up)
    hostlane.host_cache().clear()
    got = torch_fuzz.run_fuzz(cases=24, device="cpu", check_pipeline=False)
    counts = {f: getattr(got, f) for f in (
        "stream_timeouts", "stream_circuit_open", "stream_refused")}
    assert counts == {f: (12 if f == field else 0) for f in counts}


def test_run_fuzz_raises_without_a_card(monkeypatch):
    """``device=None`` is the card: with no card the first compiled set
    raises, as every entry point of the port does."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_fuzz.run_fuzz(cases=24, stream_leg=False)


def _certified(cps) -> list:
    return [(ir.policy_name, ir.rule_name, ir.certified)
            for ir in cps.tensors.rules]


def _refresh_both(steps):
    """Run the same refreshes on a JAX and a port IncrementalCompiler;
    yield each step's (port, JAX) certify counts and stamps."""
    jc, tc = JaxCompiler(), TorchCompiler(device="cpu")
    for docs in steps:
        jpols = [jax_load_policy(d) for d in docs]
        tpols = [torch_load_policy(d) for d in docs]
        j, t = jc.refresh(jpols), tc.refresh(tpols)
        yield ((tc.last_refresh_certify, _certified(t)),
               (jc.last_refresh_certify, _certified(j)))


def _refresh_steps() -> list:
    lib = corpus_docs("library250")[:40]
    fixtures = [d for f in policy_files()
                for d in corpus_docs(f"file:{os.path.basename(f)}")]
    return [lib, lib[:20] + lib[21:], fixtures + lib[:10], fixtures]


def test_refresh_certify_equal_to_jax():
    """``_certify_spliced`` after a full refresh, a policy dropped, the
    fixtures (a KT404 list pattern, a host rule, a variable message)
    spliced in, and the library dropped: the same counts and stamps."""
    n = 0
    for got, want in _refresh_both(_refresh_steps()):
        assert got == want
        assert "divergent" not in got[0] and "unchecked" not in got[0]
        n += 1
    assert n == 4


def test_refresh_certify_off_stamps_nothing(monkeypatch):
    monkeypatch.setenv("KTPU_CERTIFY", "0")
    for got, want in _refresh_both(_refresh_steps()[:1]):
        assert got == want
        assert got[0] == {}
        assert {c for *_, c in got[1]} == {""}


def _gauge_lines(metrics, name: str) -> list:
    return sorted(line for line in metrics.registry().expose().splitlines()
                  if line.startswith(name + "{"))


def test_refresh_certify_gauges_equal_to_jax():
    jax_metrics.registry().reset()
    torch_metrics.registry().reset()
    for _ in _refresh_both(_refresh_steps()[:2]):
        pass
    got = _gauge_lines(torch_metrics, "kyverno_certified_rules")
    assert got == _gauge_lines(jax_metrics, "kyverno_certified_rules")
    assert len(got) == 5


def test_certifier_failure_is_logged_not_raised(monkeypatch, caplog):
    """The hook is warn-only: a certifier that raises leaves the refresh
    and its compiled set as they were, and logs."""
    import kyverno_tpu_torch.analysis.certify as certify_mod

    def boom(*a, **k):
        raise RuntimeError("certifier down")

    monkeypatch.setattr(certify_mod, "certify_tensors", boom)
    tc = TorchCompiler(device="cpu")
    with caplog.at_level(logging.ERROR):
        cps = tc.refresh([torch_load_policy(d)
                          for d in corpus_docs("library250")[:5]])
    assert cps.tensors.n_rules_live == 5
    assert tc.last_refresh_certify == {}
    assert "certification of spliced segments failed" in caplog.text


DEAD_POLICY = {
    "apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
    "metadata": {"name": "injected-dead"},
    "spec": {"validationFailureAction": "enforce", "rules": [{
        "name": "unreachable", "match": {"any": [{}]},
        "validate": {"pattern": {"metadata": {"name": "?*"}}}}]}}


def _admission_docs() -> list:
    fixtures = [d for f in policy_files()
                for d in corpus_docs(f"file:{os.path.basename(f)}")]
    return fixtures + corpus_docs("library250")[:30] + [DEAD_POLICY]


def _lint_exposed(metrics) -> list:
    return sorted(
        line for line in metrics.registry().expose().splitlines()
        if line.startswith(("kyverno_policy_device_decidability{",
                            "kyverno_policy_host_rule_info{")))


def test_admission_lint_equal_to_jax():
    """``_lint_admitted`` on every add: the same reports per policy key
    and the same decidability and host-rule gauges; a removed policy's
    report goes with it."""
    assert torch_policycache.LINT_ON_ADMISSION == \
        jax_policycache.LINT_ON_ADMISSION
    if not torch_policycache.LINT_ON_ADMISSION:
        pytest.skip("admission lint disabled via env")
    jax_metrics.registry().reset()
    torch_metrics.registry().reset()
    jc = jax_policycache.PolicyCache()
    tc = torch_policycache.PolicyCache(device="cpu")
    for d in _admission_docs():
        jc.add(jax_load_policy(d))
        tc.add(torch_load_policy(d))
    assert sorted(tc.lint_reports) == sorted(jc.lint_reports)
    for key, report in tc.lint_reports.items():
        assert report.to_dict() == jc.lint_reports[key].to_dict(), key
    assert "KT201" in tc.lint_reports["injected-dead"].categories()
    exposed = _lint_exposed(torch_metrics)
    assert exposed == _lint_exposed(jax_metrics)
    assert any('reason="variable-reference"' in line for line in exposed)
    for cache, load in ((jc, jax_load_policy), (tc, torch_load_policy)):
        cache.remove(load(DEAD_POLICY))
        assert "injected-dead" not in cache.lint_reports


def test_admission_lint_never_raises(monkeypatch, caplog):
    import kyverno_tpu_torch.analysis as analysis_mod

    def boom(*a, **k):
        raise RuntimeError("analyzer down")

    monkeypatch.setattr(analysis_mod, "analyze_policies", boom)
    cache = torch_policycache.PolicyCache(device="cpu")
    with caplog.at_level(logging.ERROR):
        cache.add(torch_load_policy(DEAD_POLICY))
    assert cache.snapshot()[1][0].name == "injected-dead"
    assert cache.lint_reports == {}
    assert "policy lint failed for injected-dead" in caplog.text


@pytest.mark.parametrize("shed_max", ["2", "40"])
def test_shed_ranking_by_lint_severity_equal_to_jax(monkeypatch, shed_max):
    """The SLO shed action over a real policy cache: the lint severities
    of ``_lint_severities`` and the shed set (an ERROR-flagged policy is
    never shed; least impact first) equal to the JAX controller's."""
    monkeypatch.setenv("KTPU_SLO_SHED_MAX", shed_max)
    docs = [dict(d, spec=dict(d["spec"], validationFailureAction="enforce"))
            for d in _admission_docs()]
    impact = {d["metadata"]["name"]: (7 * i) % 11
              for i, d in enumerate(docs)}
    out = []
    for mod, pc, load, metrics in (
            (jax_sloactions, jax_policycache.PolicyCache(), jax_load_policy,
             jax_metrics),
            (torch_sloactions, torch_policycache.PolicyCache(device="cpu"),
             torch_load_policy, torch_metrics)):
        monkeypatch.setattr(mod, "_attribution_impact", lambda: impact)
        for d in docs:
            pc.add(load(d))
        c = mod.DegradationController()
        c.attach(pc)
        c._recompute_shed(metrics.registry())
        gen, pols = pc.snapshot()
        out.append((c._lint_severities(gen, pols), list(c.shed)))
    assert out[0] == out[1]
    sevs, shed = out[0]
    assert sevs["injected-dead"] == 2 and "injected-dead" not in shed
    candidates = [d["metadata"]["name"] for d in docs
                  if sevs.get(d["metadata"]["name"], 0) < 2]
    assert len(shed) == min(int(shed_max), len(candidates))
    assert all(impact[a] <= impact[b] for a, b in zip(shed, shed[1:]))


def test_recorders_equal_to_jax():
    jax_metrics.registry().reset()
    torch_metrics.registry().reset()
    for m in (jax_metrics, torch_metrics):
        m.record_lint_finding(m.registry(), "KT201", "ERROR")
        m.record_lint_finding(m.registry(), "KT201", "ERROR")
        m.record_certified_rules(m.registry(), {"certified": 3, "host": 1})
        m.record_certified_rules(m.registry(), {"incomplete": 2})
    for name in ("kyverno_lint_findings_total", "kyverno_certified_rules"):
        assert _gauge_lines(torch_metrics, name) == \
            _gauge_lines(jax_metrics, name)
    assert torch_metrics.lint_findings_snapshot(torch_metrics.registry()) == \
        jax_metrics.lint_findings_snapshot(jax_metrics.registry())


def test_certify_switch_declared_with_jax_default():
    got = torch_featureplane.REGISTRY["KTPU_CERTIFY"]
    want = jax_featureplane.REGISTRY["KTPU_CERTIFY"]
    assert got.default == want.default
    assert got.owner.startswith("kyverno_tpu_torch.")
    assert got.gate.startswith("tests/test_torch_")
    assert os.path.exists(os.path.join(chip_smoke.ROOT, got.gate))


# the JAX switches the port does not declare: the persistent compile
# cache's (the port's kernel cache is the hash-named build directory of
# ops/_build.py, with nothing to switch), and that of bench.py, the JAX
# package's benchmark script
NOT_DECLARED = {
    "KTPU_COMPILE_CACHE": "kyverno_tpu.utils.compilecache",
    "KTPU_COMPILE_CACHE_DIR": "kyverno_tpu.utils.compilecache",
    "KTPU_BENCH_CONFIGS": "bench"}


def test_jax_switches_the_port_does_not_declare():
    missing = set(jax_featureplane.REGISTRY) - set(torch_featureplane.REGISTRY)
    assert {n: jax_featureplane.REGISTRY[n].owner for n in missing} == \
        NOT_DECLARED
    assert not set(torch_featureplane.REGISTRY) - set(
        jax_featureplane.REGISTRY)


@pytest.mark.parametrize("name", sorted(torch_featureplane.REGISTRY))
def test_port_switch_has_the_jax_default(name):
    assert torch_featureplane.REGISTRY[name].default == \
        jax_featureplane.REGISTRY[name].default
