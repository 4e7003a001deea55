"""The port stands alone: importing every module of kyverno_tpu_torch
(the admission path's too) loads neither jax nor any module of the JAX
package (kyverno_tpu), the package's sources name neither in an import,
no source of the port (Python, CUDA or C++) names a path under the JAX
package's ``native/`` or ``kyverno_tpu/`` directories, what an
oracle-pool worker imports loads no torch, the generate, verifyImages
and policy modules load neither PyYAML nor cryptography, importing the
webhook and the observability routes loads no profiling or workload
module, no port module imports a fleet module, and what the controller
process's modules import, inside their functions too, reaches neither
jax nor the JAX package."""

import ast

import json
import os
import pkgutil
import re
import subprocess
import sys

import kyverno_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        kyverno_tpu_torch.__path__, "kyverno_tpu_torch."))


def test_port_imports_no_jax_and_no_jax_package():
    mods = _port_modules()
    assert "kyverno_tpu_torch.ops.eval" in mods and len(mods) >= 20
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m.startswith('jaxlib.')"
        " or m == 'kyverno_tpu' or m.startswith('kyverno_tpu.')]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_admission_modules_are_checked():
    mods = _port_modules()
    for m in ("runtime.batch", "runtime.policycache", "runtime.oracle_pool",
              "runtime.resourcecache", "runtime.hostlane", "parallel.mesh",
              "runtime.background", "runtime.reports"):
        assert f"kyverno_tpu_torch.{m}" in mods


def test_mutate_modules_are_checked():
    mods = _port_modules()
    for m in ("engine.mutate", "engine.mutate.json_patch",
              "engine.mutate.strategic_merge", "engine.mutate.handlers",
              "engine.mutate.batch", "engine.force_mutate",
              "engine.mutation"):
        assert f"kyverno_tpu_torch.{m}" in mods


SLICE_10_MODULES = ("engine.generation", "engine.image_verify",
                    "engine.registry_verify", "engine.certchain",
                    "utils.ecdsa", "policy.autogen", "policy.validation",
                    "policy.openapi", "policy.crd_sync")


def test_generate_verify_images_and_policy_modules_are_checked():
    mods = _port_modules()
    for m in SLICE_10_MODULES:
        assert f"kyverno_tpu_torch.{m}" in mods


def test_slice_10_modules_import_no_yaml_and_no_cryptography():
    """The card's machine may lack PyYAML and cryptography: importing the
    generate, verifyImages and policy modules loads neither (each is
    imported inside the function that needs it), nor jax or the JAX
    package."""
    mods = [f"kyverno_tpu_torch.{m}" for m in SLICE_10_MODULES]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('yaml', 'cryptography', 'jax', 'jaxlib', 'kyverno_tpu')]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


SLICE_11_MODULES = ("runtime.config", "runtime.userinfo",
                    "runtime.workqueue", "runtime.events", "runtime.metrics",
                    "runtime.slo", "runtime.sloactions", "runtime.obs_http",
                    "runtime.watch", "runtime.client", "runtime.auth",
                    "runtime.webhook", "runtime.tracing",
                    "runtime.featureplane", "runtime.resourcecache")


def test_webhook_modules_are_checked():
    mods = _port_modules()
    for m in SLICE_11_MODULES:
        assert f"kyverno_tpu_torch.{m}" in mods


def test_webhook_and_obs_routes_load_no_profiling_or_workload():
    """Importing the webhook and the observability routes loads no
    ``profiling`` module (``/debug/profile`` imports it when it is
    served, as the JAX route does); serving every route, /debug/profile
    and /debug/dryrun included, loads no ``workload`` or ``fleet`` module
    (later slices), nor jax or the JAX package."""
    code = (
        "import json, sys\n"
        "import kyverno_tpu_torch.runtime.webhook\n"
        "from kyverno_tpu_torch.runtime import obs_http\n"
        "bad = [m for m in sys.modules if 'profiling' in m.split('.')]\n"
        "for path in ('/metrics', '/healthz', '/debug/traces',\n"
        "             '/debug/policies', '/debug/profile',\n"
        "             '/debug/dryrun'):\n"
        "    obs_http.handle_obs_get(path)\n"
        "obs_http.handle_obs_post('/debug/dryrun', b'{}')\n"
        "print(json.dumps(bad + [m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'kyverno_tpu')\n"
        "    or m.split('.')[0] == 'kyverno_tpu_torch' and {\n"
        "    'workload', 'fleet'} & set(m.split('.'))]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_port_module_imports_fleet():
    """The fleet plane waits for a later slice: no source of the port
    names a ``fleet`` module in an import, and importing every port
    module loads none."""
    pkg = os.path.dirname(kyverno_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            for line in open(os.path.join(dirpath, f)):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    words = s.replace(",", " ").split()
                    assert not any(w == "fleet" or ".fleet" in w
                                   or w.startswith("fleet.")
                                   for w in words), (f, s)
    mods = _port_modules()
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps([m for m in sys.modules if m.split('.')[0]"
        " == 'kyverno_tpu_torch' and 'fleet' in m.split('.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_oracle_pool_worker_modules_load_no_torch():
    """What an oracle-pool worker imports (the pool module, the loader
    and the CPU oracle) loads neither torch nor jax."""
    code = (
        "import json, sys\n"
        "import kyverno_tpu_torch.runtime.oracle_pool as op\n"
        "op._worker_init([])\n"
        "op._worker_evaluate([], {}, {}, {}, [], [], [])\n"
        "print(json.dumps([m for m in ('torch', 'jax', 'numpy') "
        "if m in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_nothing_of_the_jax_package():
    pkg = os.path.dirname(kyverno_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            for line in open(os.path.join(dirpath, f)):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    words = s.replace(",", " ").split()
                    assert "jax" not in words and not any(
                        w == "kyverno_tpu" or w.startswith("kyverno_tpu.")
                        for w in words), (f, s)


# a path under native/ or kyverno_tpu/ (kyverno_tpu_torch/ is not one),
# written with a slash or as a quoted path part ("native" / "x.cpp")
_JAX_PATH = re.compile(
    r"(?<![A-Za-z0-9_.-])(?:native|kyverno_tpu)/"
    r"|[\"'](?:native|kyverno_tpu)[\"']")
_SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".h")


def _jax_paths(text: str) -> list[str]:
    return [m.group(0) for m in _JAX_PATH.finditer(text)]


def test_sources_name_no_path_of_the_jax_package():
    # the scan sees what it must: each of these names such a path
    for bad in ('// built from native/ktpu_flatten.cpp',
                'ROOT / "native" / "ktpu_flatten.cpp"',
                "see kyverno_tpu/ops/eval.py:205",
                "Path('kyverno_tpu') / 'models'"):
        assert _jax_paths(bad), bad
    for fine in ("kyverno_tpu_torch/csrc/ktpu_flatten.cpp",
                 "the JAX package's ops/eval.py", "alternative/path"):
        assert not _jax_paths(fine), fine
    pkg = os.path.dirname(kyverno_tpu_torch.__file__)
    seen = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(_SOURCE_SUFFIXES):
                continue
            seen.add(os.path.splitext(f)[1])
            text = open(os.path.join(dirpath, f), encoding="utf-8").read()
            for n, line in enumerate(text.splitlines(), 1):
                assert not _jax_paths(line), (f, n, line)
    assert {".py", ".cu", ".cuh", ".cpp"} <= seen


SLICE_12_MODULES = ("server", "runtime.profiling", "runtime.stream_server",
                    "runtime.leaderelection", "runtime.webhookconfig",
                    "runtime.migrations", "runtime.generate_controller",
                    "runtime.featureplane", "models.flatten")


def test_controller_modules_are_checked():
    mods = _port_modules()
    for m in SLICE_12_MODULES:
        assert f"kyverno_tpu_torch.{m}" in mods


def _imported_names(module: str) -> set[str]:
    """Every module an import statement of ``module`` names, at any
    depth (inside functions too), relative names resolved."""
    pkg = os.path.dirname(kyverno_tpu_torch.__file__)
    rel = module.split(".")[1:]
    path = os.path.join(pkg, *rel) + ".py"
    parent = module.split(".")[:-1]
    out = set()
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = (parent[:len(parent) - node.level + 1] if node.level
                    else [])
            name = ".".join(base + ([node.module] if node.module else []))
            out.add(name)
            for a in node.names:
                out.add(f"{name}.{a.name}")
    return out


def test_controller_modules_function_imports_reach_no_jax():
    """Import everything the controller process's modules import, the
    imports inside their functions included (``stream_server``'s codec,
    ``profiling``'s torch.profiler, ``server``'s webhookconfig), in a
    fresh interpreter: neither jax nor the JAX package loads. ``grpc``
    is optional (the card's machine lacks it) and is skipped if absent."""
    names = set()
    for m in SLICE_12_MODULES:
        names |= _imported_names(f"kyverno_tpu_torch.{m}")
    assert "kyverno_tpu_torch.models.flatten" in names
    assert "torch.profiler" in names
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"for n in sorted({sorted(names)!r}):\n"
        "    try:\n"
        "        importlib.import_module(n)\n"
        "    except ModuleNotFoundError:\n"
        "        top = n.split('.')[0]\n"
        "        if top == 'grpc' and importlib.util.find_spec(top) is None:\n"
        "            continue\n"
        "        if '.' not in n or importlib.util.find_spec(\n"
        "                n.rsplit('.', 1)[0]) is None:\n"
        "            raise\n"
        "print(json.dumps([m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'kyverno_tpu')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
