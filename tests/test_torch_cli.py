"""The port's CLI (``python -m kyverno_tpu_torch.cli``): ``apply``,
``test``, ``validate``, ``render-chart``, ``lint`` and ``version``.

Two kinds of test:

- The JAX package's batteries, case by case, on the port
  (``torch_parity.mirror_battery``): ``tests/analysis/test_lint_cli.py``
  and ``tests/unit/test_chart.py``. Edits: the admission-lint case's
  policy cache is on ``device="cpu"``; the lint path's import check
  also refuses torch (the port's lint is host-only by construction, as
  the JAX package's is jax-free); ``test_ci_lint_script_gates_on_injected_error``
  is left out, because ``deploy/ci_lint.sh`` drives the JAX package.
- Both packages' ``main(argv)`` on the same argv over a small corpus
  written to ``tmp_path`` (policies, Pods, a values file, ``test.yaml``
  corpora that pass and one that fails): the same exit code and the same
  standard output, byte for byte. ``tests/unit/test_cli.py`` reads the
  reference tree, which this suite cannot assume.
"""

import json
import os

import pytest
import yaml

import chip_smoke
from kyverno_tpu.cli.__main__ import main as jax_main
from kyverno_tpu_torch.cli.__main__ import main as torch_main
from tests.torch_parity import mirror_battery
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX batteries, on the port
for _relpath, _subs, _drop in (
        ("tests/analysis/test_lint_cli.py", (
            ("cache = PolicyCache()", 'cache = PolicyCache(device="cpu")'),
            ("sys.exit(1 if 'jax' in sys.modules ",
             "sys.exit(1 if {'jax', 'torch'} & set(sys.modules) ")),
         ("test_ci_lint_script_gates_on_injected_error",)),
        ("tests/unit/test_chart.py", (), ())):
    _exports = mirror_battery(_relpath, _subs, _drop)
    _clash = set(_exports) & set(globals())
    assert not _clash, (_relpath, _clash)
    globals().update(_exports)


# ------------------------------------------------ both packages at once

def _policy(name, rules, action="audit"):
    return {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
            "metadata": {"name": name},
            "spec": {"validationFailureAction": action, "rules": rules}}


POLICIES = {
    "disallow-latest.yaml": _policy("disallow-latest", [{
        "name": "no-latest", "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {"message": "latest tag not allowed",
                     "pattern": {"spec": {"containers": [
                         {"image": "!*:latest"}]}}}}], "enforce"),
    "require-team.yaml": _policy("require-team", [{
        "name": "team-label", "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {"message": "label team is required",
                     "pattern": {"metadata": {"labels": {"team": "?*"}}}}}]),
    "deny-prod.yaml": _policy("deny-prod", [{
        "name": "deny-prod-ns", "match": {"resources": {"kinds": ["Pod"]}},
        "validate": {"message": "no {{ request.object.metadata.name }} "
                                "in {{ tier }}",
                     "deny": {"conditions": {"any": [{
                         "key": "{{ tier }}", "operator": "Equals",
                         "value": "prod"}]}}}}]),
    "add-label.yaml": _policy("add-label", [{
        "name": "add-owner", "match": {"resources": {"kinds": ["Pod"]}},
        "mutate": {"patchStrategicMerge": {"metadata": {"labels": {
            "+(owner)": "platform"}}}}}]),
}
BAD_POLICY = {"apiVersion": "kyverno.io/v1", "kind": "ClusterPolicy",
              "metadata": {"name": "no-rules"}, "spec": {"rules": [{
                  "name": "r", "match": {"resources": {"kinds": ["Pod"]}}}]}}


def _pod(name, image, labels=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "labels": labels or {}},
            "spec": {"containers": [{"name": "c", "image": image}]}}


PODS = [_pod("good", "nginx:1.25", {"team": "a"}),
        _pod("latest", "nginx:latest", {"team": "b"}),
        _pod("unlabelled", "redis:7")]


def _dump(path, docs):
    path.write_text("".join("---\n" + yaml.safe_dump(d, sort_keys=False)
                            for d in docs))
    return str(path)


@pytest.fixture
def corpus(tmp_path):
    pol_dir = tmp_path / "policies"
    pol_dir.mkdir()
    for name, doc in POLICIES.items():
        _dump(pol_dir / name, [doc])
    validate_dir = tmp_path / "validate"
    validate_dir.mkdir()
    for name in ("disallow-latest.yaml", "require-team.yaml"):
        _dump(validate_dir / name, [POLICIES[name]])
    pods = _dump(tmp_path / "pods.yaml", PODS)
    values = _dump(tmp_path / "values.yaml", [{
        "globalValues": {"tier": "dev"},
        "policies": [{"name": "deny-prod", "resources": [
            {"name": "latest", "values": {"tier": "prod"}}]}]}])
    results = [
        {"policy": "disallow-latest", "rule": "no-latest",
         "resource": "good", "status": "pass"},
        {"policy": "disallow-latest", "rule": "no-latest",
         "resource": "latest", "status": "fail"},
        {"policy": "require-team", "rule": "team-label",
         "resource": "unlabelled", "status": "fail"},
        {"policy": "deny-prod", "rule": "deny-prod-ns",
         "resource": "latest", "status": "fail"},
        {"policy": "deny-prod", "rule": "deny-prod-ns",
         "resource": "good", "status": "pass"},
        {"policy": "add-label", "rule": "add-owner",
         "resource": "good", "status": "pass",
         "patchedResource": "patched.yaml"},
    ]
    for name, rows in (("passing", results),
                       ("failing", results[:-1] + [
                           dict(results[0], status="fail"),
                           {"policy": "require-team", "rule": "team-label",
                            "resource": "missing", "status": "pass"}])):
        case = tmp_path / "tests" / name
        case.mkdir(parents=True)
        for p in POLICIES.values():
            _dump(case / f"{p['metadata']['name']}.yaml", [p])
        _dump(case / "resources.yaml", PODS)
        _dump(case / "values.yaml",
              yaml.safe_load_all(open(values).read()))
        patched = json.loads(json.dumps(PODS[0]))
        patched["metadata"]["labels"]["owner"] = "platform"
        _dump(case / "patched.yaml", [patched])
        _dump(case / "test.yaml", [{
            "name": name,
            "policies": [f"{p['metadata']['name']}.yaml"
                         for p in POLICIES.values()],
            "resources": ["resources.yaml"], "variables": "values.yaml",
            "results": rows}])
    (tmp_path / "empty").mkdir()
    bad = _dump(tmp_path / "bad.yaml", [BAD_POLICY])
    return {"policies": str(pol_dir), "validate": str(validate_dir),
            "pods": pods, "values": values, "tests": str(tmp_path / "tests"),
            "passing": str(tmp_path / "tests" / "passing"),
            "failing": str(tmp_path / "tests" / "failing"),
            "empty": str(tmp_path / "empty"), "bad": bad,
            "chart": os.path.join(ROOT, "deploy", "chart", "kyverno-tpu"),
            "samples": os.path.join(ROOT, "tests", "policies")}


ARGVS = {
    "apply": ["apply", "{policies}", "-r", "{pods}"],
    "apply-values": ["apply", "{policies}", "-r", "{pods}", "-f", "{values}"],
    "apply-set": ["apply", "{policies}", "-r", "{pods}", "-s", "tier=prod",
                  "--policy-report"],
    "apply-namespace": ["apply", "{policies}", "-r", "{pods}", "-n", "other"],
    "apply-no-resource": ["apply", "{policies}"],
    "test-passing": ["test", "{passing}"],
    "test-failing": ["test", "{failing}"],
    "test-both": ["test", "{tests}"],
    "test-quiet": ["test", "-q", "{failing}"],
    "test-empty": ["test", "{empty}"],
    "validate": ["validate", "{validate}"],
    "validate-bad": ["validate", "{validate}", "{bad}"],
    "chart": ["render-chart", "{chart}"],
    "chart-set": ["render-chart", "{chart}", "--set", "replicaCount=3",
                  "-n", "policy"],
    "lint": ["lint", "{policies}"],
    "lint-self": ["lint", "--self"],
    "lint-json": ["lint", "--json", "{samples}"],
    "lint-certify": ["lint", "--certify", "{samples}"],
    "lint-certify-json": ["lint", "--certify", "--json", "{policies}"],
    "lint-suppress": ["lint", "--suppress", "KT110,KT101", "{samples}"],
    "lint-fail-on": ["lint", "--fail-on", "info", "--no-tensors",
                     "{policies}"],
    "lint-none": ["lint"],
    "version": ["version"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_cli_equal_to_jax(case, corpus, capsys):
    argv = [a.format(**corpus) for a in ARGVS[case]]
    got = torch_main(argv)
    got_out = capsys.readouterr()
    want = jax_main(argv)
    want_out = capsys.readouterr()
    assert (got, got_out.out) == (want, want_out.out)
    assert got_out.out or got_out.err or "-q" in argv


def test_cli_corpus_exercises_every_exit_code(corpus, capsys):
    """The corpus reaches each outcome: a clean run, failures and a
    usage error, for both verbs that replay policies."""
    codes = {}
    for case in ("apply", "apply-namespace", "apply-no-resource",
                 "test-passing", "test-failing", "test-empty"):
        codes[case] = torch_main([a.format(**corpus) for a in ARGVS[case]])
    capsys.readouterr()
    assert codes == {"apply": 1, "apply-namespace": 0,
                     "apply-no-resource": 2, "test-passing": 0,
                     "test-failing": 1, "test-empty": 2}


def test_apply_writes_mutated_resources_equal_to_jax(corpus, tmp_path,
                                                    capsys):
    outs = []
    for main, name in ((torch_main, "port"), (jax_main, "jax")):
        out_dir = tmp_path / f"out-{name}"
        out_dir.mkdir()
        rc = main(["apply", os.path.join(corpus["policies"], "add-label.yaml"),
                   "-r", corpus["pods"], "-o", str(out_dir)])
        capsys.readouterr()
        outs.append((rc, {f: (out_dir / f).read_text()
                          for f in sorted(os.listdir(out_dir))}))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) == len(PODS)
    assert "owner: platform" in outs[0][1]["good.yaml"]


def test_cli_main_registers_the_ported_verbs(capsys):
    """Every verb of the JAX CLI, ``dryrun`` included, is registered under
    the same program name: the two ``--help`` outputs are the same."""
    helps = []
    for main in (jax_main, torch_main):
        with pytest.raises(SystemExit):
            main(["--help"])
        helps.append(capsys.readouterr().out)
    assert helps[1].startswith("usage: kyverno-tpu ")
    assert "{apply,dryrun,lint,test,validate,render-chart,version}" in helps[1]
    assert helps[1] == helps[0]


# ------------------------------------- chip_smoke.py's [analysis] pins

@pytest.mark.parametrize("label", sorted(chip_smoke.EXPECTED_CLI))
def test_chip_smoke_cli_pins_are_the_jax_packages(label, tmp_path, capsys,
                                                  monkeypatch):
    """``EXPECTED_CLI`` (the exit code and summary lines ``[analysis]``
    holds ``python -m kyverno_tpu_torch.cli`` to on the card) is what the
    JAX package's CLI prints over the same library and Pods, and the
    port's on the CPU prints the same."""
    monkeypatch.chdir(ROOT)
    argv = chip_smoke.write_cli_inputs(str(tmp_path))[label]
    want_rc, want_lines = chip_smoke.EXPECTED_CLI[label]
    for main in (jax_main, torch_main):
        rc = main(list(argv))
        lines = capsys.readouterr().out.splitlines()
        assert rc == want_rc, (main.__module__, lines[-3:])
        assert all(w in lines for w in want_lines), (main.__module__,
                                                     lines[-3:])
