"""Launch counts stay exact under threads: the admission batcher launches
from its four flush threads at once, and every wrapper counts through
``ops/_build.note_launch``, which takes its lock. The plain versions
(the CPU route) launch nothing and count nothing, from any thread."""

import os
import re
import sys
import threading

import numpy as np

from kyverno_tpu_torch.ops import _build
from kyverno_tpu_torch.ops import eval as ev
from tests.torch_parity import (  # noqa: F401  (one_torch_thread: autouse)
    both_sets,
    corpus_docs,
    corpus_resources,
    one_torch_thread,
)

OPS = os.path.join(os.path.dirname(_build.__file__))


def _threads(n, fn):
    barrier = threading.Barrier(n)
    out = [None] * n

    def run(i):
        barrier.wait()
        out[i] = fn(i)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def test_note_launch_is_exact_under_threads():
    """More counting threads than cores, switching as often as the
    interpreter allows: not one count is lost."""
    n = max(4, 2 * (os.cpu_count() or 1))
    per = 5_000
    saved = dict(_build.LAUNCHES)
    interval = sys.getswitchinterval()
    try:
        _build.reset_launches()
        sys.setswitchinterval(1e-6)

        def count(i):
            for _ in range(per):
                _build.note_launch(("glob_nfa", "eval_rules")[i % 2])
        _threads(n, count)
        assert _build.LAUNCHES == {
            "glob_nfa": (n + 1) // 2 * per, "eval_rules": n // 2 * per,
            "eval_rules_scan": 0, "eval_rules_counts": 0, "scan_counts": 0}
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(saved)


def test_plain_path_from_four_threads_counts_nothing():
    _, tset = both_sets(corpus_docs("library250")[:30])
    resources = corpus_resources("library250", 32)
    blob, shp = tset.to_device(tset.flatten_packed(resources))
    want = ev.evaluate_blob(tset.plan, blob, *shp).numpy()
    saved = dict(_build.LAUNCHES)
    try:
        _build.reset_launches()
        got = _threads(4, lambda i: ev.evaluate_blob(
            tset.plan, blob, *shp).numpy())
        assert all(np.array_equal(g, want) for g in got)
        assert set(_build.LAUNCHES.values()) == {0}
    finally:
        _build.LAUNCHES.update(saved)


def test_every_wrapper_counts_through_note_launch():
    """No source of the port increments a launch count by hand."""
    pkg = os.path.dirname(OPS)
    seen = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "_build.py":
                text = open(os.path.join(dirpath, f)).read()
                assert not re.search(r"LAUNCHES\[[^\]]*\]\s*\+=", text), f
                seen += re.findall(r'note_launch\("(\w+)"\)', text)
    assert sorted(seen) == sorted(_build.LAUNCHES)


def test_libraries_keep_the_interpreter_lock(monkeypatch, tmp_path):
    """Every library loads with ctypes.PyDLL, so a launch keeps the
    interpreter lock: a call that gave it up would have to win it back
    from the threads running the oracle in Python, which is what made an
    admission dispatch take seconds on the card's host."""
    import ctypes

    loaded = []

    class Loader:
        def __init__(self, kind):
            self.kind = kind

        def __call__(self, path):
            loaded.append((self.kind, path))
            return object()

    monkeypatch.setattr(ctypes, "PyDLL", Loader("PyDLL"))
    monkeypatch.setattr(ctypes, "CDLL", Loader("CDLL"))
    monkeypatch.setattr(_build, "_start", lambda name: None)
    monkeypatch.setattr(_build, "_lib_path", lambda name: tmp_path / name)
    monkeypatch.setattr(_build, "_libs", {})
    for name in _build.LIBRARIES:
        _build.lib(name)
    assert loaded == [("PyDLL", str(tmp_path / n)) for n in _build.LIBRARIES]
    assert "dispatch" in _build.LIBRARIES


def test_every_binding_declares_its_entry_arguments():
    """Each ``_build.fn`` / ``_build.address`` binding names as many
    argument types as its C entry has parameters. ctypes passes an
    argument past the declared types as a 32-bit int: K1's stream, its
    twelfth, was cut to 32 bits until the binding named all twelve, so
    that K1 went to a wrong stream whenever the current one was not the
    default."""
    csrc = os.path.join(os.path.dirname(OPS), "csrc")
    entries = {}
    for f in os.listdir(csrc):
        if f.endswith(".cu"):
            text = open(os.path.join(csrc, f)).read()
            for name, params in re.findall(
                    r'extern "C" int (\w+)\(([^)]*)\)', text):
                entries[(f[:-3], name)] = len(params.split(","))
    pkg = os.path.dirname(OPS)
    seen = 0
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for lib, entry, n in re.findall(
                        r'_build\.(?:fn|address)\(\s*"(\w+)",\s*"(\w+)",'
                        r'\s*(\d+)\)', text):
                    assert entries[(lib, entry)] == int(n), (f, entry, n)
                    seen += 1
    assert seen >= 12
