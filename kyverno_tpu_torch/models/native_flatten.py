"""ctypes loader for the native flattener (``csrc/ktpu_flatten.cpp``).

The C++ library is the byte-parity twin of :mod:`.flatten` — same slot
enumeration, interning order, and numeric decomposition — but parses the
batch as one JSON blob (or walks the Python dicts directly) instead of
visiting every slot in the interpreter.

Build on demand: the first use compiles the source with ``g++ -O3
-std=c++17 -shared -fPIC -pthread`` into
``build/torch_kernels/libktpu_flatten-<hash>.so``; the hash covers the
source and the flags, so an edited source never loads a stale library.
The build with the Python headers (which adds the direct dict-walk
entry) is tried first, then one with ``-DKTPU_NO_PYTHON``. If neither
builds and loads, the flatten raises: with ``KTPU_NATIVE`` on (the
default) the Python flattener is never used in its place.
``KTPU_NATIVE=0`` selects the Python flattener.

Inputs the native code cannot take still go to the Python flattener, as
in the JAX package (the verdicts are the same either way), and each
native attempt that gives up is counted by reason in :data:`FALLBACKS`
(a packed flatten may make two: the dict walk, then JSON):

- ``unserializable``: ``json.dumps`` refused a document (the JSON entry
  cannot read it);
- ``dict_overflow``: the batch's string dictionary outgrew
  :data:`DICT_CAP` entries;
- ``newline``: a path or kind of the compiled dictionary holds a newline,
  which the newline-joined C interface cannot carry;
- ``walk_rejected``: the dict-walk entry met an object it cannot convert
  (a non-finite float, an exotic type); the JSON entry is tried next;
- ``parse_error``: the native JSON parser refused the serialized batch
  (``NaN`` from ``json.dumps``, or bad ``json_docs`` bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from collections import OrderedDict

import numpy as np

from ..ops._build import BUILD_DIR, CSRC
from ..runtime import featureplane
from .compiler import STR_LEN, PolicyTensors
from .flatten import FlatBatch, PackedBatch, flatten_batch, merge_packed
from .ir import NSEFF_MARK, REQ_MARK

CPP = CSRC / "ktpu_flatten.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# the string dictionary's largest size before a batch falls back, and the
# smallest first guess of it
DICT_CAP = 1 << 24
STR_CAP_MIN = 1 << 14

FALLBACKS = {"unserializable": 0, "dict_overflow": 0, "newline": 0,
             "walk_rejected": 0, "parse_error": 0}
# what the loaded library is: its path, whether it has the dict-walk
# entry, and the seconds its build (when there was one) and load took
BUILT: dict = {}

_lib = None
_pylib = None          # PyDLL view of the same .so (GIL-holding entries)
# Guards ONLY the one-time library build/load and the fallback counts.
# Flatten calls themselves take no global lock: each NativeFlattener owns
# an independent C++ Ctx that is immutable after ktpu_create, so any
# number of threads can flatten concurrently on the same or different
# handles.
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _count(reason: str) -> None:
    with _count_lock:
        FALLBACKS[reason] += 1


def reset_fallbacks() -> None:
    with _count_lock:
        for k in FALLBACKS:
            FALLBACKS[k] = 0


def gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found: the native flattener cannot be "
                           "built (KTPU_NATIVE=0 selects the Python one)")
    return cand


def _variants() -> list[tuple[str, ...]]:
    """Extra flags of the candidate builds, tried in order: with the
    Python headers (enables the PyObject direct-walk entry), then
    without (KTPU_NO_PYTHON)."""
    out = []
    inc = sysconfig.get_paths().get("include")
    if inc and os.path.isfile(os.path.join(inc, "Python.h")):
        out.append((f"-I{inc}",))
    out.append(("-DKTPU_NO_PYTHON",))
    return out


def lib_path(extra: tuple[str, ...]):
    h = hashlib.sha256(CPP.read_bytes())
    h.update(" ".join(CXX_FLAGS + extra).encode())
    return BUILD_DIR / f"libktpu_flatten-{h.hexdigest()[:16]}.so"


def _build_and_load(extra: tuple[str, ...]):
    out = lib_path(extra)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a temp name, then atomic rename: a concurrent process
        # must never load a half-written .so
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx(), *CXX_FLAGS, *extra, str(CPP), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise OSError(f"{' '.join(cmd)} (rc={proc.returncode}):\n"
                          f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out, ctypes.CDLL(str(out))


def _load_lib():
    """The loaded library, built on first use. Raises RuntimeError when
    no candidate builds and loads."""
    global _lib, _pylib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        errors = []
        lib = path = None
        for extra in _variants():
            # a with-Python .so whose Py* symbols can't resolve at dlopen
            # falls through to the KTPU_NO_PYTHON build
            try:
                path, lib = _build_and_load(extra)
                break
            except (OSError, subprocess.SubprocessError) as e:
                errors.append(str(e))
        if lib is None:
            raise RuntimeError("the native flattener did not build or load "
                               f"from {CPP.name}:\n" + "\n".join(errors))

        lib.ktpu_create.restype = ctypes.c_void_p
        lib.ktpu_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.ktpu_destroy.argtypes = [ctypes.c_void_p]
        lib.ktpu_flatten_batch.restype = ctypes.c_int
        lib.ktpu_flatten_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_int64,       # docs
            ctypes.c_char_p, ctypes.c_int64,       # reqs (nullable)
            ctypes.c_int, ctypes.c_int,            # n_docs, max_slots
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),  # e_cap, e_needed
        ] + [ctypes.c_void_p] * 19 + [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # n_strings, str_cap
        ]
        lib.ktpu_flatten_packed.restype = ctypes.c_int
        lib.ktpu_flatten_packed.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_int64,       # docs
            ctypes.c_char_p, ctypes.c_int64,       # reqs (nullable)
            ctypes.c_int, ctypes.c_int,            # n_docs, max_slots
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),  # e_cap, e_needed
            ctypes.c_void_p, ctypes.c_void_p,      # cells, bmeta
            ctypes.c_void_p, ctypes.c_void_p,      # dictv, str_bytes
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # n_strings, str_cap
        ]
        # the PyObject walk entry needs the GIL held across the call:
        # load the same .so a second time as a PyDLL (no GIL release).
        # Absent when the build fell back to -DKTPU_NO_PYTHON.
        try:
            pl = ctypes.PyDLL(str(path))
            pl.ktpu_flatten_packed_py.restype = ctypes.c_int
            pl.ktpu_flatten_packed_py.argtypes = [
                ctypes.c_void_p,
                ctypes.py_object, ctypes.py_object,  # docs, reqs (py lists)
                ctypes.c_int, ctypes.c_int,          # n_docs, max_slots
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_void_p, ctypes.c_void_p,    # cells, bmeta
                ctypes.c_void_p, ctypes.c_void_p,    # dictv, str_bytes
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ]
        except (OSError, AttributeError):
            pl = None
        _pylib = pl
        _lib = lib
        BUILT.update(path=str(path), dict_walk=pl is not None,
                     seconds=time.perf_counter() - t0)
        return lib


def native_available() -> bool:
    """Whether flattens take the native path: ``KTPU_NATIVE`` on, and
    then the library must build and load (else this raises)."""
    return featureplane.enabled("KTPU_NATIVE") and _load_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _failure(code: int) -> str:
    """The fallback reason of a native call's negative return code."""
    if code == -1:
        return "dict_overflow"
    if code == -5:
        return "walk_rejected"
    return "parse_error"


class NativeFlattener:
    """Per-PolicyTensors native flatten context (path/kind dictionaries)."""

    def __init__(self, tensors: PolicyTensors):
        self.tensors = tensors
        lib = _load_lib()
        kinds = [""] * len(tensors.kind_index)
        for k, i in tensors.kind_index.items():
            kinds[i] = k
        if any("\n" in p for p in tensors.paths) or any("\n" in k for k in kinds):
            # the '\n'-joined C ABI can't carry them; caller falls back
            raise ValueError("newline in path/kind dictionary")
        self._handle = lib.ktpu_create(
            "\n".join(tensors.paths).encode("utf-8"),
            "\n".join(kinds).encode("utf-8"),
            STR_LEN, REQ_MARK.encode("utf-8"), NSEFF_MARK.encode("utf-8"),
        )
        self._lib = lib
        # sticky capacity guesses: a wrong guess costs a full re-flatten
        # pass, and scan chunks repeat the same shape chunk after chunk.
        # The dictionary guess is tracked per batch-size regime (log2
        # bucket): per-doc string density is highest at B=1 and amortizes
        # with batch size, so one regime's observation must not inflate
        # (or starve) another's allocation
        self._e_guess = 0
        self._str_by_bucket: dict[int, int] = {}
        # cap guesses are the only mutable state on a flattener — guard
        # them so concurrent flatten calls can't interleave a
        # read-modify-write
        self._caps_lock = threading.Lock()

    def _str_cap_guess(self, B: int) -> int:
        with self._caps_lock:
            seen = self._str_by_bucket.get(B.bit_length(), 0)
        return max(STR_CAP_MIN, 2 * B, int(seen * 1.25))

    def _record_caps(self, B: int, e_used: int, n_strings: int) -> None:
        with self._caps_lock:
            self._e_guess = max(self._e_guess, e_used)
            bucket = B.bit_length()
            self._str_by_bucket[bucket] = max(
                self._str_by_bucket.get(bucket, 0), n_strings)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ktpu_destroy(handle)
            self._handle = None

    def flatten(self, resources: list[dict], max_slots: int = 16,
                requests: list[dict] | None = None) -> FlatBatch | None:
        """FlatBatch identical to flatten_batch's, or None (counted in
        FALLBACKS) when the native code cannot take the batch."""
        B, P = len(resources), self.tensors.n_paths
        try:
            docs = json.dumps(resources).encode("utf-8")
            reqs = (json.dumps(requests).encode("utf-8")
                    if requests is not None else None)
        except (TypeError, ValueError):
            _count("unserializable")
            return None

        # most batches need 1-4 slots per path; retry with the full stride
        # when a document exceeds the initial guess (-4). The dictionary
        # guess scales with the batch.
        e_cap = min(max(4, self._e_guess), max_slots)
        str_cap = self._str_cap_guess(B)
        while True:
            E = e_cap
            mask = np.zeros((B, P, E), dtype=np.uint16)
            slot_valid = np.zeros((B, P, E), dtype=bool)
            null_break = np.zeros((B, P, E), dtype=bool)
            type_tag = np.zeros((B, P, E), dtype=np.int8)
            str_id = np.full((B, P, E), -1, dtype=np.int32)
            num_val = np.zeros((B, P, E), dtype=np.int64)
            num_ok = np.zeros((B, P, E), dtype=bool)
            num_plain = np.zeros((B, P, E), dtype=bool)
            num_int = np.zeros((B, P, E), dtype=bool)
            dur_val = np.zeros((B, P, E), dtype=np.int64)
            dur_ok = np.zeros((B, P, E), dtype=bool)
            dur_any = np.zeros((B, P, E), dtype=bool)
            bool_val = np.zeros((B, P, E), dtype=bool)
            elem0 = np.full((B, P, E), -1, dtype=np.int32)
            kind_id = np.full(B, -1, dtype=np.int32)
            host_flag = np.zeros(B, dtype=bool)
            str_bytes = np.zeros((str_cap, STR_LEN), dtype=np.uint8)
            str_len = np.zeros(str_cap, dtype=np.int32)
            str_glob = np.zeros(str_cap, dtype=bool)
            n_strings = ctypes.c_int32(0)
            e_needed = ctypes.c_int32(0)
            e_used = self._lib.ktpu_flatten_batch(
                self._handle, docs, len(docs), reqs,
                len(reqs) if reqs is not None else 0,
                B, max_slots, e_cap, ctypes.byref(e_needed),
                _ptr(mask), _ptr(slot_valid), _ptr(null_break),
                _ptr(type_tag), _ptr(str_id),
                _ptr(num_val), _ptr(num_ok), _ptr(num_plain), _ptr(num_int),
                _ptr(dur_val), _ptr(dur_ok), _ptr(dur_any),
                _ptr(bool_val), _ptr(elem0),
                _ptr(kind_id), _ptr(host_flag),
                _ptr(str_bytes), _ptr(str_len), _ptr(str_glob),
                ctypes.byref(n_strings), str_cap,
            )
            if e_used == -1:
                # n_strings reports the exact dictionary size needed
                str_cap = max(str_cap * 2, n_strings.value)
                if str_cap > DICT_CAP:
                    _count("dict_overflow")
                    return None
                continue
            if e_used == -4:
                # e_needed is already <= max_slots (slot lists are
                # truncated before the stride check)
                e_cap = max(e_cap + 1, e_needed.value)
                continue
            if e_used < 0:
                _count(_failure(e_used))
                return None
            break
        self._record_caps(B, e_used, n_strings.value)

        V = n_strings.value
        strings = [
            bytes(str_bytes[i, : str_len[i]]).decode("utf-8", "surrogateescape")
            for i in range(V)
        ]
        Vp = max(1, V)

        def cut(a):
            return np.ascontiguousarray(a[:, :, :e_used])

        nv = cut(num_val)
        dv = cut(dur_val)
        return FlatBatch(
            n=B, e=e_used,
            mask=cut(mask), slot_valid=cut(slot_valid),
            null_break=cut(null_break), type_tag=cut(type_tag),
            str_id=cut(str_id), num_val=nv,
            num_hi=(nv >> 31).astype(np.int32),
            num_lo=(nv & 0x7FFFFFFF).astype(np.int32),
            num_ok=cut(num_ok), num_plain=cut(num_plain), num_int=cut(num_int),
            dur_hi=(dv >> 31).astype(np.int32),
            dur_lo=(dv & 0x7FFFFFFF).astype(np.int32),
            dur_ok=cut(dur_ok), dur_any=cut(dur_any),
            bool_val=cut(bool_val), elem0=cut(elem0),
            kind_id=kind_id, host_flag=host_flag,
            live=np.ones(B, dtype=bool),
            # copies, not views: a view would pin the full str_cap buffer
            # for the FlatBatch's lifetime
            str_bytes=str_bytes[:Vp].copy(), str_len=str_len[:Vp].copy(),
            str_has_glob=str_glob[:Vp].copy(),
            strings=strings,
        )

    def _packed_retry_loop(self, B: int, max_slots: int, invoke):
        """The -1/-4 retry protocol shared by every packed entry:
        ``invoke(e_cap, e_needed, cells, bmeta, dictv, str_bytes,
        n_strings, str_cap)`` makes one native call and returns e_used.
        Returns a PackedBatch, or None (counted in FALLBACKS) on an
        unrecoverable failure."""
        P = self.tensors.n_paths
        e_cap = min(max(4, self._e_guess), max_slots)
        str_cap = self._str_cap_guess(B)
        while True:
            E = e_cap
            cells = np.zeros((B, P, E, 2), dtype=np.uint32)
            bmeta = np.zeros(B, dtype=np.uint32)
            dictv = np.zeros((str_cap, 5), dtype=np.uint32)
            str_bytes = np.zeros((str_cap, STR_LEN), dtype=np.uint8)
            n_strings = ctypes.c_int32(0)
            e_needed = ctypes.c_int32(0)
            e_used = invoke(e_cap, e_needed, cells, bmeta, dictv, str_bytes,
                            n_strings, str_cap)
            if e_used == -1:
                # n_strings reports the exact dictionary size needed
                str_cap = max(str_cap * 2, n_strings.value)
                if str_cap > DICT_CAP:
                    _count("dict_overflow")
                    return None
                continue
            if e_used == -4:
                # e_needed is already <= max_slots (slot lists are
                # truncated before the stride check)
                e_cap = max(e_cap + 1, e_needed.value)
                continue
            if e_used < 0:
                _count(_failure(e_used))
                return None
            break
        self._record_caps(B, e_used, n_strings.value)

        V = max(1, n_strings.value)
        if e_used < E:
            cells = np.ascontiguousarray(cells[:, :, :e_used, :])
        return PackedBatch(
            n=B, e=e_used, cells=cells, bmeta=bmeta,
            # copies, not views: a view pins the full str_cap buffers
            str_bytes=str_bytes[:V].copy(), dictv=dictv[:V].copy(),
        )

    def flatten_packed(self, resources: list[dict] | None = None,
                       max_slots: int = 16,
                       requests: list[dict] | None = None,
                       json_docs: bytes | None = None,
                       n_docs: int | None = None,
                       json_reqs: bytes | None = None):
        """Flatten straight into the packed transfer form (PackedBatch),
        or None (counted in FALLBACKS) when the native code cannot take
        the batch. ``json_docs`` (a JSON array of documents, e.g. the
        items of an apiserver list response) skips the Python
        json.dumps. Dict input takes the PyObject direct-walk entry when
        the library has it (no serialization at all), and serializes
        then parses when the walk rejects an object."""
        if json_docs is None and resources is not None and _pylib is not None:
            out = self._flatten_packed_py(resources, requests, max_slots)
            if out is not None:
                return out
            # fall through: serialize-then-parse handles what the direct
            # walk rejected where JSON can express it
        if json_docs is not None:
            docs, B = json_docs, int(n_docs)
            reqs = json_reqs
        else:
            B = len(resources)
            try:
                docs = json.dumps(resources).encode("utf-8")
                reqs = (json.dumps(requests).encode("utf-8")
                        if requests is not None else None)
            except (TypeError, ValueError):
                _count("unserializable")
                return None

        def invoke(e_cap, e_needed, cells, bmeta, dictv, str_bytes,
                   n_strings, str_cap):
            return self._lib.ktpu_flatten_packed(
                self._handle, docs, len(docs), reqs,
                len(reqs) if reqs is not None else 0,
                B, max_slots, e_cap, ctypes.byref(e_needed),
                _ptr(cells), _ptr(bmeta), _ptr(dictv), _ptr(str_bytes),
                ctypes.byref(n_strings), str_cap,
            )

        return self._packed_retry_loop(B, max_slots, invoke)

    def _flatten_packed_py(self, resources: list[dict],
                           requests: list[dict] | None,
                           max_slots: int):
        """PackedBatch via the PyObject direct-walk entry (GIL held,
        zero serialization), or None when the walk can't express the
        input (the caller then serializes)."""
        if not isinstance(resources, list):
            resources = list(resources)
        if requests is not None and not isinstance(requests, list):
            requests = list(requests)
        B = len(resources)

        def invoke(e_cap, e_needed, cells, bmeta, dictv, str_bytes,
                   n_strings, str_cap):
            return _pylib.ktpu_flatten_packed_py(
                self._handle, resources, requests,
                B, max_slots, e_cap, ctypes.byref(e_needed),
                _ptr(cells), _ptr(bmeta), _ptr(dictv), _ptr(str_bytes),
                ctypes.byref(n_strings), str_cap,
            )

        return self._packed_retry_loop(B, max_slots, invoke)


# Handle cache for _flattener_for, keyed by PolicyTensors.fingerprint
# (what ktpu_create consumes: paths + kind index), so recompiles that
# leave the dictionary unchanged share a handle, and LRU-bounded so
# native memory stays at a handful of live policy generations.
_FLATTENER_CACHE_CAP = 4
_flattener_cache: "OrderedDict[str, NativeFlattener | None]" = OrderedDict()
_flattener_lock = threading.Lock()


def _flattener_for(tensors: PolicyTensors):
    """Shared NativeFlattener for a compiled tensor set (None when its
    dictionary holds a newline). The returned handle is safe to use from
    many threads at once: the C++ Ctx is immutable after ktpu_create,
    every flatten call writes only into caller-owned output buffers, and
    the per-instance cap guesses take NativeFlattener._caps_lock."""
    fp = tensors.fingerprint
    with _flattener_lock:
        if fp in _flattener_cache:
            _flattener_cache.move_to_end(fp)
            return _flattener_cache[fp]
    try:
        ctx = NativeFlattener(tensors)
    except ValueError:
        ctx = None                  # cache the refusal: retry is hopeless
    with _flattener_lock:
        if fp not in _flattener_cache:
            _flattener_cache[fp] = ctx
        _flattener_cache.move_to_end(fp)
        while len(_flattener_cache) > _FLATTENER_CACHE_CAP:
            _flattener_cache.popitem(last=False)
        return _flattener_cache[fp]


def _native_for(tensors: PolicyTensors):
    """The tensors' NativeFlattener when flattens take the native path,
    else None (KTPU_NATIVE=0, or a counted newline fallback)."""
    if not native_available():
        return None
    ctx = _flattener_for(tensors)
    if ctx is None:
        _count("newline")
    return ctx


def flatten_batch_fast(resources: list[dict], tensors: PolicyTensors,
                       max_slots: int = 16,
                       requests: list[dict] | None = None) -> FlatBatch:
    """Native flatten, with the Python flattener for what it cannot take
    and under KTPU_NATIVE=0; the replacement for :func:`flatten_batch`
    used by CompiledPolicySet."""
    ctx = _native_for(tensors)
    if ctx is not None:
        out = ctx.flatten(resources, max_slots=max_slots, requests=requests)
        if out is not None:
            return out
    return flatten_batch(resources, tensors, max_slots=max_slots,
                         requests=requests)


def flatten_packed_fast(tensors: PolicyTensors,
                        resources: list[dict] | None = None,
                        max_slots: int = 16,
                        requests: list[dict] | None = None,
                        json_docs: bytes | None = None,
                        n_docs: int | None = None,
                        json_reqs: bytes | None = None) -> PackedBatch:
    """PackedBatch via the native packed flattener, with the Python
    flattener + pack_batch for what it cannot take and under
    KTPU_NATIVE=0 (still a PackedBatch)."""
    ctx = _native_for(tensors)
    if ctx is not None:
        out = ctx.flatten_packed(
            resources, max_slots=max_slots, requests=requests,
            json_docs=json_docs, n_docs=n_docs, json_reqs=json_reqs)
        if out is not None:
            return out
    if resources is None:
        resources = json.loads(json_docs)
        requests = json.loads(json_reqs) if json_reqs is not None else None
    fb = flatten_batch(resources, tensors, max_slots=max_slots,
                       requests=requests)
    cells, bmeta, str_bytes, dictv = fb.packed_args()
    pb = PackedBatch(n=fb.n, e=fb.e, cells=cells, bmeta=bmeta,
                     str_bytes=str_bytes, dictv=dictv)
    object.__setattr__(pb, "_flat", fb)
    object.__setattr__(pb, "_strings", fb.strings)
    return pb


# Shared worker pool for the chunked flatten: threads are cheap to keep
# and the scan regime calls this once per multi-thousand-row chunk.
_chunk_pool = None
_chunk_pool_lock = threading.Lock()
_CHUNK_MIN = 512                    # below this, chunking costs more than it saves


def _chunk_workers() -> int:
    try:
        n = featureplane.int_value("KTPU_FLATTEN_WORKERS")
    except ValueError:
        n = 0
    return n if n > 0 else min(4, os.cpu_count() or 1)


def flatten_packed_chunks(tensors: PolicyTensors, resources: list[dict],
                          max_slots: int = 16,
                          requests: list[dict] | None = None,
                          chunk: int | None = None) -> PackedBatch:
    """Flatten a large batch across threads: each worker serializes its
    own slice (json.dumps holds the GIL, but only for its slice) and runs
    the native parse with the GIL released, so a 4k+ batch flattens on
    every core; chunk outputs concatenate via merge_packed (shared
    re-interned string table). Single-chunk batches, KTPU_NATIVE=0 and
    KTPU_FLATTEN_WORKERS=1 take the direct path — the output is
    verdict-identical either way. The worker threads run the native
    flattener only."""
    global _chunk_pool
    B = len(resources)
    workers = _chunk_workers()
    if chunk is None:
        chunk = max(_CHUNK_MIN, -(-B // workers))
    n_chunks = -(-B // chunk) if B else 0
    if n_chunks <= 1 or workers <= 1 or not native_available() \
            or _flattener_for(tensors) is None:
        return flatten_packed_fast(tensors, resources, max_slots=max_slots,
                                   requests=requests)
    with _chunk_pool_lock:
        if _chunk_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _chunk_pool = ThreadPoolExecutor(
                max_workers=max(2, _chunk_workers()),
                thread_name_prefix="ktpu-flatten")
        pool = _chunk_pool

    def run(lo: int) -> PackedBatch:
        sl = resources[lo:lo + chunk]
        rq = requests[lo:lo + chunk] if requests is not None else None
        try:
            docs = json.dumps(sl).encode("utf-8")
            reqs = (json.dumps(rq).encode("utf-8")
                    if rq is not None else None)
        except (TypeError, ValueError):
            # unserializable chunk: the fast path's fallbacks handle it
            return flatten_packed_fast(tensors, sl, max_slots=max_slots,
                                       requests=rq)
        return flatten_packed_fast(tensors, max_slots=max_slots,
                                   json_docs=docs, n_docs=len(sl),
                                   json_reqs=reqs)

    chunks = list(pool.map(run, range(0, B, chunk)))
    return merge_packed(chunks)
