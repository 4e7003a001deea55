"""Sharding of the policy x resource evaluation matrix over a device mesh:
K7, the background scan's program.

The batch axis shards over the mesh's ``data`` axis, and with
``KTPU_MESH_SHAPE=PxD`` the *rule* axis shards too: the devices form a
2D ``(policy, data)`` grid. Each of the P policy shards holds only its
own segment-aligned slice of the policy tensors
(models/engine.ShardedPolicySet), scores the same flattened batch split
over its row's D devices, and the verdict columns gather back into the
host rule layout, so callers see bit-identical matrices whatever the
geometry. With the switch unset the 1D data mesh is used.

PyTorch has no mesh type and no partitioner, so both are written out
here. :class:`Mesh` is an array of ``torch.device`` shaped ``(D,)`` or
``(P, D)`` with its axis names, and it may name one device more than
once: ``[cuda:0] * 4`` is a 2D ``(4, 1)`` mesh on one card whose shards
run one after another, as ``["cpu"] * 8`` stands in for eight devices in
the tests. The verdicts and counts do not depend on it. A program
(:func:`sharded_eval_fn`, one per shard row in :func:`shard_eval_fns`)
pads nothing itself: the caller pads the packed batch to a multiple of D
(``pad_packed``; padded rows score NOT_APPLICABLE), the program cuts it
into D row ranges, runs K1 -> eval_rules' counts form, which writes
the verdicts and counts them (ops/eval.evaluate_live_counts, the
verdicts sliced to the live rules), on each range's device, gathers the
verdicts onto the row's first device and sums the count vectors there —
the all-reduce, an add on the device when the row is one card. Counts
are int32 on the device and int64 on the host.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..models.engine import (
    CompiledPolicySet,
    ShardedPolicySet,
    resolve_device,
)
from ..models.flatten import (
    BATCH_ARRAYS,
    FlatBatch,
    _assemble_blob,
    pad_fill,
    pad_packed,
)
from ..ops import eval as ops_eval
from ..ops.eval import V_FAIL, V_HOST, V_PASS
from ..runtime import featureplane

MESH_AXIS_POLICY = "policy"

DEFAULT_CHUNK = 65_536  # scan chunk size: bounds flatten + device memory


class Mesh:
    """A grid of devices and the names of its axes: ``devices`` is an
    object array of ``torch.device`` shaped ``(D,)`` (axes ``(data,)``)
    or ``(P, D)`` (axes ``(policy, data)``). A device may appear more
    than once."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {arr.shape} with axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def parse_mesh_shape(spec: str, n_devices: int) -> tuple[int, int] | None:
    """``KTPU_MESH_SHAPE`` grammar -> 2D ``(policy, data)`` shape or None
    for the 1D default. ``""``/``"1"``/``"1d"`` select 1D; ``"auto"``
    factors the device count (largest power-of-two policy axis p with
    p*p <= n); ``"PxD"`` is explicit and must multiply out to the device
    count."""
    spec = (spec or "").strip().lower()
    if spec in ("", "1", "1d"):
        return None
    if spec == "auto":
        p = 1
        while p * 2 * p * 2 <= n_devices and n_devices % (p * 2) == 0:
            p *= 2
        return (p, n_devices // p)
    try:
        ps, ds = spec.split("x")
        shape = (int(ps), int(ds))
    except ValueError:
        raise ValueError(
            f"KTPU_MESH_SHAPE={spec!r} is not 'PxD', 'auto' or '1d'")
    if shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"KTPU_MESH_SHAPE={spec!r}: axes must be >= 1")
    if shape[0] * shape[1] != n_devices:
        raise ValueError(
            f"KTPU_MESH_SHAPE={spec!r} needs {shape[0] * shape[1]} devices "
            f"but {n_devices} are visible")
    return shape


def mesh_shape_from_env(n_devices: int) -> tuple[int, int] | None:
    return parse_mesh_shape(featureplane.raw("KTPU_MESH_SHAPE"), n_devices)


def is_2d(mesh: Mesh) -> bool:
    return MESH_AXIS_POLICY in mesh.axis_names


def policy_axis_size(mesh: Mesh) -> int:
    return (mesh.devices.shape[list(mesh.axis_names)
                               .index(MESH_AXIS_POLICY)]
            if is_2d(mesh) else 1)


def data_axis_size(mesh: Mesh) -> int:
    """Devices along the batch axis — the padding multiple for the flat
    batch (the 1D mesh splits the batch over every device; a 2D mesh
    only over its data columns)."""
    return int(mesh.devices.shape[-1]) if is_2d(mesh) else int(
        mesh.devices.size)


def default_devices() -> list[torch.device]:
    """Every card of the host; raises with no card, as ``resolve_device``
    does (a CPU mesh is asked for by passing its devices)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices=None, axis: str = "data",
              shape: tuple[int, int] | None = None) -> Mesh:
    """Build the scan mesh over ``devices`` (default: every card).
    ``shape=None`` consults ``KTPU_MESH_SHAPE``: unset keeps the 1D
    ``(data,)`` mesh, ``PxD`` (or ``auto``) arranges the same devices as
    a 2D ``(policy, data)`` grid. An explicit ``shape`` tuple overrides
    the environment."""
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else default_devices())
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if shape is None:
        shape = mesh_shape_from_env(len(devices))
    try:
        from ..runtime import metrics as metrics_mod

        reg = metrics_mod.registry()
        metrics_mod.record_mesh_devices(reg, len(devices), devices[0].type)
        if shape is None:
            metrics_mod.record_mesh_shape(reg, (axis,), (len(devices),))
        else:
            metrics_mod.record_mesh_shape(
                reg, (MESH_AXIS_POLICY, axis), shape)
    except Exception:
        pass
    if shape is None:
        return Mesh(_device_array(devices), (axis,))
    p, d = shape
    if p * d != len(devices):
        raise ValueError(f"mesh shape {shape} needs {p * d} devices, "
                         f"got {len(devices)}")
    return Mesh(_device_array(devices).reshape(p, d),
                (MESH_AXIS_POLICY, axis))


def _device_array(devices: list) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr


def mesh_from_env(devices=None) -> Mesh | None:
    """Mesh selection plumbing for the runtime planes (BackgroundScanner):
    a Mesh when ``KTPU_MESH_SHAPE`` explicitly selects one (``1d`` gives
    the 1D mesh over all devices), else None — the caller keeps its
    single-device path."""
    if not featureplane.raw("KTPU_MESH_SHAPE").strip():
        return None
    devices = list(devices if devices is not None else default_devices())
    return make_mesh(devices, shape=mesh_shape_from_env(len(devices)))


def pad_batch(batch: FlatBatch, multiple: int) -> tuple[FlatBatch, int]:
    """Pad the batch axis to a multiple of the mesh size. Padded rows carry
    no valid slots, so the kernel reports NOT_APPLICABLE for them. Derives
    the field list from flatten.BATCH_ARRAYS and the per-field fill from
    flatten.PAD_FILL, the fill table every padding site shares."""
    from dataclasses import replace

    b = batch.n
    padded = (b + multiple - 1) // multiple * multiple
    if padded == b:
        return batch, b
    pad = padded - b

    updates = {"n": padded}
    for name in BATCH_ARRAYS + ("num_val",):
        x = getattr(batch, name)
        width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        updates[name] = np.pad(x, width, constant_values=pad_fill(name))
    return replace(batch, **updates), b


def _batch_multiple(mesh: Mesh) -> int:
    """The flat-batch padding multiple for this mesh, validated once per
    scan: every chunk pads its batch axis to a multiple of the data-axis
    device count so that it splits evenly."""
    multiple = data_axis_size(mesh)
    if multiple < 1 or mesh.devices.size % multiple:
        raise ValueError(
            f"mesh {tuple(mesh.devices.shape)} has no even data split "
            f"(data axis {multiple})")
    return multiple


def _row_program(cps: CompiledPolicySet, devices: list,
                 live: int | None = None):
    """K7 over one row of data devices: ``step(cells, bmeta, str_bytes,
    dictv)`` on a batch padded to a multiple of ``len(devices)`` returns
    (verdicts int8 [B, live], fails int32 [live], passes int32 [live]) on
    the row's first device, over the first ``live`` rule columns (the
    set's live rules unless given). Row range d runs on ``devices[d]``
    with the set's plan there (``cps.plan_on``)."""
    if live is None:
        live = cps.tensors.n_rules_live
    first = devices[0]

    def step(cells, bmeta, str_bytes, dictv):
        per, rest = divmod(int(cells.shape[0]), len(devices))
        if rest:
            raise ValueError(f"a batch of {cells.shape[0]} rows does not "
                             f"split over {len(devices)} devices")
        verdicts, fails, passes = [], None, None
        for d, dev in enumerate(devices):
            rows = slice(d * per, (d + 1) * per)
            blob, shp = _assemble_blob(cells[rows], bmeta[rows], str_bytes,
                                       dictv)
            # a kernel launches on the current card's stream
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                dblob = torch.from_numpy(blob.view(np.int32)).to(dev)
                v, f, p = ops_eval.evaluate_live_counts(
                    cps.plan_on(dev), dblob, *shp, live)
            verdicts.append(v.to(first))
            # the all-reduce: one add a data shard on the row's first device
            fails = f.to(first) if fails is None else fails + f.to(first)
            passes = p.to(first) if passes is None else passes + p.to(first)
        verdict = verdicts[0] if len(verdicts) == 1 else torch.cat(verdicts)
        return verdict, fails, passes

    return step


def sharded_eval_fn(cps: CompiledPolicySet, mesh: Mesh, axis: str = "data"):
    """The verdict computation over the packed transfer form with the
    batch axis split over the mesh: ``fn(cells, bmeta, str_bytes, dictv)``
    -> (verdicts [B, R], fails [R], passes [R]), the per-rule FAIL and
    PASS counts over the whole padded batch (K7's counts, summed over the
    data shards), over every column of the rule axis as the JAX package
    gives them: R is the plan's rule axis, padded past the live rules of
    an incremental or sharded set.

    1D meshes only — a 2D ``(policy, data)`` mesh needs per-shard
    programs: see :func:`shard_eval_fns` / :func:`sharded_scan`."""
    if is_2d(mesh):
        raise ValueError("sharded_eval_fn is the 1D program; use "
                         "shard_eval_fns(ShardedPolicySet, mesh) for a "
                         "2D (policy, data) mesh")
    return _row_program(cps, list(mesh.devices.reshape(-1)), cps.plan.R)


def shard_eval_fns(sps: ShardedPolicySet, mesh: Mesh, axis: str = "data"):
    """Per-policy-shard programs for a 2D ``(policy, data)`` mesh.

    Row ``p`` of the device grid evaluates shard ``p``'s tensors with the
    flat batch split over the row's data devices and the string
    dictionary sent whole to each. Verdicts come back already sliced to
    the shard's live rules (ops/eval.evaluate_live_counts), so the gather
    moves exactly the columns the host layout needs.

    Returns ``[(PolicyShard, fn), ...]``. Programs cache on the shard
    object keyed by the row's devices: a shard the partitioner didn't
    touch across a refresh keeps its program and plans."""
    if not is_2d(mesh):
        raise ValueError("shard_eval_fns needs a 2D (policy, data) mesh")
    rows = mesh.devices
    n_rows = rows.shape[0]
    if sps.n_shards != n_rows:
        raise ValueError(
            f"ShardedPolicySet has {sps.n_shards} shards but the mesh "
            f"policy axis is {n_rows}")
    out = []
    for shard in sps.shards:
        row = list(rows[shard.index])
        key = (axis, tuple(str(d) for d in row))
        fn = shard._mesh_fn_cache.get(key)
        if fn is None:
            fn = shard._mesh_fn_cache[key] = _row_program(shard.cps, row)
        out.append((shard, fn))
    return out


def _host_rules(tensors) -> bool:
    return bool(np.asarray(
        tensors.rule_host_only[:tensors.n_rules_live]).any())


def _resolve_chunk(cps, chunk, v, fails, passes, pf, rec, tr):
    """The chunk's host-lane post-pass: HOST cells resolve through the
    CPU oracle (joining the dispatch-time prefetch), and each resolved
    cell adds to the counts (the device counted it as neither)."""
    host = v == V_HOST
    if host.any() or pf is not None:
        h0 = time.perf_counter()
        bb, rr = np.nonzero(host)
        cps.resolve_host_cells(chunk, v, prefetch=pf)
        if bb.size:
            vals = v[bb, rr]
            np.add.at(fails, rr[vals == V_FAIL], 1)
            np.add.at(passes, rr[vals == V_PASS], 1)
        rec.add_span(tr, "host_resolve", h0, time.perf_counter(),
                     cells=int(bb.size),
                     lane=("prefetch" if pf is not None else "post_pass"))
    try:
        from ..runtime import metrics as metrics_mod

        metrics_mod.record_policy_verdict_matrix(
            metrics_mod.registry(), cps.rule_refs, v, lane="mesh")
    except Exception:
        pass


def sharded_scan(cps, resources: list[dict], mesh: Mesh,
                 axis: str = "data", chunk_size: int = DEFAULT_CHUNK,
                 flatten_workers: int = 6):
    """Background-scan entry: flatten, pad to the mesh, evaluate sharded.

    Returns (verdicts [B, R] numpy int8, fails [R], passes [R] int64) —
    the mesh-scale replay of the reference's processExistingResources.
    The per-rule counts come from K7's counts on the device, summed over
    the data shards; host-lane cells (Verdict.HOST) resolve through the
    CPU oracle exactly like CompiledPolicySet.evaluate, and each resolved
    cell adds to the counts, so precondition/context rules are reported,
    not dropped.

    On a 1D mesh ``cps`` is a CompiledPolicySet and every device scores
    the full rule axis. On a 2D ``(policy, data)`` mesh ``cps`` should be
    a models/engine.ShardedPolicySet — each policy shard's tensors are
    scored on its row of devices, every row scores the same batch chunks,
    and the shard verdict columns scatter back into the host rule layout
    (bit-identical to the 1D result). A plain CompiledPolicySet passed
    with a 2D mesh is wrapped on the fly (a full recompile — long-lived
    callers should hold the ShardedPolicySet themselves).

    Host-cell resolution is per chunk, inside the chunk's own worker
    thread: each worker starts a host-lane prefetch for its chunk's
    statically host-only cells at dispatch time (runtime/hostlane), joins
    it after reading the device verdicts back, and resolves any remaining
    HOST cells in the post-pass.

    Snapshots larger than ``chunk_size`` stream through a pool of
    ``flatten_workers`` threads, each flattening its chunk (the native
    flattener releases the GIL), dispatching it and blocking on its own
    result — so at most ``flatten_workers`` chunks are on the device at
    once, while copies and launches still overlap across workers."""
    from ..runtime import tracing
    from ..runtime.hostlane import resolver

    if is_2d(mesh):
        if isinstance(cps, ShardedPolicySet):
            sps = cps
        else:
            sps = ShardedPolicySet(policy_axis_size(mesh),
                                   device=cps.device).refresh(cps.policies)
        return _sharded_scan_2d(sps, resources, mesh, axis, chunk_size,
                                flatten_workers)

    # sharded_eval_fn's program over the live columns only: the scan
    # slices them, so the inert ones are neither counted nor copied back
    fn = _row_program(cps, list(mesh.devices.reshape(-1)))
    rec = tracing.recorder()
    multiple = _batch_multiple(mesh)
    has_host_rules = _host_rules(cps.tensors)

    def eval_chunk(chunk: list[dict]):
        # each chunk is one trace: chunks run on pool worker threads, so
        # the trace is created (and bound for hostlane attribution) here
        tr = rec.start("scan_chunk", rows=len(chunk), lane="mesh")
        tok = tracing.bind(tr) if tr is not None else None
        try:
            f0 = time.perf_counter()
            pb = cps.flatten_packed(chunk)
            cells, bmeta, n = pad_packed(pb.cells, pb.bmeta, multiple)
            rec.add_span(tr, "flatten", f0, time.perf_counter(),
                         rows=len(chunk), lane="worker")
            # dispatch first, then start this chunk's host prefetch: the
            # statically host-only cells resolve in the device's shadow
            d0 = time.perf_counter()
            verdict, fails, passes = fn(cells, bmeta, pb.str_bytes, pb.dictv)
            pf = resolver().prefetch(cps, chunk) if has_host_rules else None
            # read back here: the worker owns its chunk until the device
            # is done with it
            v = np.ascontiguousarray(verdict.cpu().numpy()[:n])
            fails = fails.cpu().numpy().astype(np.int64)
            passes = passes.cpu().numpy().astype(np.int64)
            rec.add_span(tr, "device_dispatch", d0, time.perf_counter(),
                         lane="mesh", rows=len(chunk))
            _resolve_chunk(cps, chunk, v, fails, passes, pf, rec, tr)
            return v, fails, passes
        finally:
            if tok is not None:
                tracing.unbind(tok)
            rec.finish(tr)

    return _run_chunks(eval_chunk, resources, chunk_size, flatten_workers)


def _run_chunks(eval_chunk, resources: list[dict], chunk_size: int,
                flatten_workers: int):
    """Shared chunk pipeline for both mesh geometries: one chunk inline,
    otherwise the bounded flatten/dispatch worker pool."""
    if len(resources) <= chunk_size:
        verdicts, fails, passes = eval_chunk(resources)
    else:
        import concurrent.futures

        chunks = [resources[i:i + chunk_size]
                  for i in range(0, len(resources), chunk_size)]
        with concurrent.futures.ThreadPoolExecutor(flatten_workers) as ex:
            outs = list(ex.map(eval_chunk, chunks))
        verdicts = np.concatenate([v for v, _, _ in outs])
        fails = np.sum([f for _, f, _ in outs], axis=0)
        passes = np.sum([p for _, _, p in outs], axis=0)
    return verdicts, np.asarray(fails), np.asarray(passes)


def _sharded_scan_2d(sps: ShardedPolicySet, resources: list[dict],
                     mesh: Mesh, axis: str, chunk_size: int,
                     flatten_workers: int):
    """2D scan body: one flatten per chunk against the full dictionary,
    every policy-shard program run on the same padded batch, shard verdict
    columns scattered back into the host rule layout, then the ordinary
    host-lane post-pass over the full set. Counts reduce on the device per
    shard and scatter with the same column maps."""
    from ..runtime import tracing
    from ..runtime.hostlane import resolver

    full = sps.full
    fns = shard_eval_fns(sps, mesh, axis)
    rec = tracing.recorder()
    multiple = _batch_multiple(mesh)
    n_live = full.tensors.n_rules_live
    has_host_rules = _host_rules(full.tensors)

    def eval_chunk(chunk: list[dict]):
        tr = rec.start("scan_chunk", rows=len(chunk), lane="mesh2d")
        tok = tracing.bind(tr) if tr is not None else None
        try:
            f0 = time.perf_counter()
            pb = full.flatten_packed(chunk)
            cells, bmeta, n = pad_packed(pb.cells, pb.bmeta, multiple)
            rec.add_span(tr, "flatten", f0, time.perf_counter(),
                         rows=len(chunk), lane="worker")
            d0 = time.perf_counter()
            # launch every shard before reading any back: the card queues
            # the P rows' programs behind one another
            outs = [(shard, fn(cells, bmeta, pb.str_bytes, pb.dictv))
                    for shard, fn in fns]
            pf = (resolver().prefetch(full, chunk)
                  if has_host_rules else None)
            v = np.full((n, n_live), 0, dtype=np.int8)  # NOT_APPLICABLE
            fails = np.zeros(n_live, dtype=np.int64)
            passes = np.zeros(n_live, dtype=np.int64)
            for shard, (sv, sf, sp) in outs:
                cols = shard.col_map
                v[:, cols] = sv.cpu().numpy()[:n]
                fails[cols] = sf.cpu().numpy().astype(np.int64)
                passes[cols] = sp.cpu().numpy().astype(np.int64)
            rec.add_span(tr, "device_dispatch", d0, time.perf_counter(),
                         lane="mesh2d", rows=len(chunk), shards=len(fns))
            _resolve_chunk(full, chunk, v, fails, passes, pf, rec, tr)
            return v, fails, passes
        finally:
            if tok is not None:
                tracing.unbind(tok)
            rec.finish(tr)

    return _run_chunks(eval_chunk, resources, chunk_size, flatten_workers)
