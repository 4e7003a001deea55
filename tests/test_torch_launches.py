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
