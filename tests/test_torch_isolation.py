"""The port stands alone: importing every module of kyverno_tpu_torch
loads neither jax nor any module of the JAX package (kyverno_tpu), and the
package's sources name neither in an import."""

import json
import os
import pkgutil
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
