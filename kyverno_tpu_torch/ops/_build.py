"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/torch_kernels/lib<name>-<hash>.so`` (a plain C interface, no
PyTorch headers, so a build takes seconds). The hash covers the source,
the shared header and the flags, so an edited source never loads a stale
library. Nothing builds at import: the first launch of a kernel builds
its library, and :func:`build_all` builds every library at once, one
``nvcc`` process per source, all started together.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on anything but 0. ``LAUNCHES`` counts, per kernel
(a source may hold more than one: ``eval_rules``, its scan form
``eval_rules_scan`` and its counts form ``eval_rules_counts``), the
wrapper calls that launched it on the card;
wrappers count through :func:`note_launch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("glob_nfa", "eval_rules", "scan_counts")
HEADERS = ("plan.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# eval_rules.cu holds three forms: the matrix, the scan and the counts form
LAUNCHES = {name: 0 for name in ("glob_nfa", "eval_rules", "eval_rules_scan",
                                 "eval_rules_counts", "scan_counts")}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_lock = threading.Lock()
# the admission batcher launches from several flush threads at once, and
# ``LAUNCHES[name] += 1`` is a read and a write a thread switch can split
_launch_lock = threading.Lock()


def note_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (exact under threads)."""
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in [CSRC / f"{name}.cu"] + [CSRC / hd for hd in HEADERS]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, float] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(BUILD_DIR / f"{name}.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, time.perf_counter()


def _finish(name: str, proc: subprocess.Popen, tmp: Path,
            t0: float) -> None:
    rc = proc.wait()
    log = (BUILD_DIR / f"{name}.log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={rc}):\n{log}")
    os.replace(tmp, _lib_path(name))
    # the build's wall time into the metrics registry, as the JAX
    # package records each XLA build; never raises
    try:
        from ..runtime import metrics as metrics_mod

        metrics_mod.record_xla_compile(metrics_mod.registry(),
                                       time.perf_counter() - t0, what=name)
    except Exception:
        pass


def build_all() -> float:
    """Build every kernel library that is not built yet, in parallel.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        started = {name: _start(name) for name in KERNELS}
        for name, job in started.items():
            if job is not None:
                _finish(name, *job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the last build of ``name`` in this build directory."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    handle = _libs.get(name)
    if handle is None:
        with _lock:
            handle = _libs.get(name)
            if handle is None:
                job = _start(name)
                if job is not None:
                    _finish(name, *job)
                handle = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = handle
    return handle


def fn(name: str, entry: str, n_args: int):
    """C entry ``entry`` of kernel ``name``; every argument is passed as
    a 64-bit integer (pointers, the stream and the scalars alike). Bound
    once, then cached: a launch spends no host time on it."""
    f = _fns.get((name, entry))
    if f is None:
        f = getattr(lib(name), entry)
        f.argtypes = [ctypes.c_int64] * n_args
        f.restype = ctypes.c_int
        _fns[(name, entry)] = f
    return f


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
