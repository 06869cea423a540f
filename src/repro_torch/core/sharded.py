"""Distributed exact kNN over a device mesh — multi-device FQ-SD / FD-SQ.

The paper runs on one FPGA and lists "multiple FPGAs within a single
system" as future work. Here the partition axis of both dataflows becomes
mesh axes (:class:`~repro_torch.core.mesh.Mesh`). One process drives every
position of the mesh, as the reference's single controller does: each
builder returns a function that loops over the positions, runs each
position's step on its device, and moves queues and blocks with
``Tensor.to``. On a mesh of distinct cards those copies are peer copies;
on logical devices (one card named several times) every position still
holds its own block and runs its own step.

* :func:`fdsq_sharded` — FD-SQ scaled out. Dataset row-sharded over the
  mesh axes; the query (micro-batch) replicated; every position scans only
  its block; the per-block queues merge exactly, innermost axis first.
* :func:`fqsd_sharded` — FQ-SD scaled out, small corpora. Queries shard
  over ``query_axis``, the dataset over ``dataset_axis`` (replicated over
  the other); one merge stage over ``dataset_axis``.
* :func:`fqsd_ring` — FQ-SD scaled out, large corpora. Queries shard over
  ``query_axis``; the dataset over both axes jointly; the blocks rotate
  around the ``query_axis`` ring, the next block shipped on a copy stream
  while the current one scans.
* :func:`fqsd_ring_queries` — the same layout with the dataset stationary
  and the (query block, queue) pair rotating instead.
* :func:`fdsq_sharded_int8` — the certified int8 first pass on the mesh:
  per-position widened (m, r+1) lower-bound queues, merged like FD-SQ's.

Each function's per-position step follows ``backend``: ``"torch"`` is
:func:`~repro_torch.core.fqsd.chunk_step` (int8: ``int8_lower_bounds`` +
``topk_smallest``) and :func:`~repro_torch.core.topk.tree_merge_sorted`;
``"cuda"`` is the card's kernels: ``kernels/knn/ops.py::knn_shard``
(``knn_scan`` then ``knn_merge`` into the position's queue; int8:
``knn_int8_shard``), and one ``knn_merge`` per merge group — the group's
sorted (m, P, w) queues copied to its first position. A CPU tensor takes
the kernels' plain versions. Queues stay in the kernel's score form until
the end (the ip form for cos), so cos gets its +1 once. Merging sorted
queues is exact, so every function answers as a single-device scan of the
same rows, bit for bit wherever the per-pair scores are the same.

Results (replicated in the reference, or sharded over ``query_axis``) are
gathered onto the mesh's first device. Every function also takes
``shards=`` (a sequence of PaddedDataset: the engine's delta shards, on
that device), merged into the final queue before it is finished; where the
queries are sharded, into each query block's queue on its position. A
pair's score has the same bits in any batch (the scan's query norms are
summed in one fixed order), so a query block answers as the whole batch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.distance import Metric, validate_metric
from repro_torch.core.fqsd import PartitionStep
from repro_torch.core.mesh import Mesh
from repro_torch.core.partition import next_pow2
from repro_torch.core.quantized import int8_lower_bounds
from repro_torch.core.streaming import CopyStreams
from repro_torch.core.topk import TopK, topk_smallest, tree_merge_sorted


# --------------------------------------------------------- sharded rows
class ShardedRows(NamedTuple):
    """A tensor row-sharded over mesh axes: ``local[p]`` is the row block
    the position at flat index p (``mesh.devices.flat`` order) holds, on its
    device. Blocks are laid row-major over ``axes`` (the first axis major),
    and positions that differ only on other axes hold the same block."""

    local: tuple
    mesh: Mesh
    axes: tuple

    @property
    def n_blocks(self) -> int:
        return _n_blocks(self.mesh, self.axes)

    @property
    def rows(self) -> int:
        """Rows a block holds."""
        return int(self.local[0].shape[0])

    @property
    def shape(self) -> tuple:
        return (self.rows * self.n_blocks, *self.local[0].shape[1:])

    def element_size(self) -> int:
        return self.local[0].element_size()

    def block(self, b: int) -> torch.Tensor:
        """Block b on its home position (0 on every axis outside ``axes``)."""
        return self.local[_home(self.mesh, self.axes, b)]

    def full(self) -> torch.Tensor:
        """Every block, in row order, on the mesh's first device."""
        return torch.cat([self.block(b).to(self.mesh.first) for b in range(self.n_blocks)])


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis(mesh: Mesh, name: str) -> int:
    try:
        return mesh.axis_names.index(name)
    except ValueError:
        raise ValueError(f"mesh axes {mesh.axis_names} have no axis {name!r}") from None


def _n_blocks(mesh: Mesh, axes: tuple) -> int:
    return math.prod(mesh.shape[ax] for ax in axes)


def _block_id(mesh: Mesh, coord: tuple, axes: tuple) -> int:
    """The block of the position at `coord`: row-major over `axes`."""
    b = 0
    for ax in axes:
        b = b * mesh.shape[ax] + coord[_axis(mesh, ax)]
    return b


def _home(mesh: Mesh, axes: tuple, b: int) -> int:
    """Flat index of block b's home: its coordinates on `axes`, 0 elsewhere."""
    coord = [0] * len(mesh.axis_names)
    for ax in reversed(axes):
        coord[_axis(mesh, ax)] = b % mesh.shape[ax]
        b //= mesh.shape[ax]
    return int(np.ravel_multi_index(coord, mesh.devices.shape))


def _coords(mesh: Mesh, axes: tuple) -> list[tuple]:
    """The positions that work: every coordinate on `axes`, 0 elsewhere (a
    block replicated over another axis is scanned once)."""
    idx = {_axis(mesh, ax) for ax in axes}
    return [c for c in np.ndindex(mesh.devices.shape)
            if all(v == 0 for i, v in enumerate(c) if i not in idx)]


def place_blocks(mesh: Mesh, axes, blocks: Sequence[torch.Tensor]) -> ShardedRows:
    """Put `blocks` (row-major over `axes`) on their positions; a replica on
    the device of its home shares the home's tensor."""
    axes = _axes(axes)
    for ax in axes:
        _axis(mesh, ax)
    if len(blocks) != _n_blocks(mesh, axes):
        raise ValueError(f"{len(blocks)} blocks for {_n_blocks(mesh, axes)} over {axes}")
    local: list[torch.Tensor] = []
    for p, coord in enumerate(np.ndindex(mesh.devices.shape)):
        dev = mesh.devices[coord]
        b = _block_id(mesh, coord, axes)
        home = _home(mesh, axes, b)
        # flat order visits a block's home before its replicas
        local.append(blocks[b].to(dev) if home == p else local[home].to(dev))
    return ShardedRows(tuple(local), mesh, axes)


def shard_rows(mesh: Mesh, t: torch.Tensor, axes) -> ShardedRows:
    """Row-shard one tensor over `axes`: equal contiguous row blocks, block
    b holding rows [b·rows, (b+1)·rows). The row count must divide evenly
    (pad via ``repro_torch.core.partition`` first)."""
    axes = _axes(axes)
    for ax in axes:
        _axis(mesh, ax)
    nb = _n_blocks(mesh, axes)
    if t.shape[0] % nb:
        raise ValueError(f"{t.shape[0]} rows do not split over {nb} blocks of {axes}")
    return place_blocks(mesh, axes, t.split(t.shape[0] // nb))


def shard_dataset(mesh: Mesh, dataset, norms, axes: Sequence[str] | str):
    """Place a padded dataset and its norms row-sharded over mesh axes:
    (ShardedRows, ShardedRows). Each block is a view of the source where it
    already lies on the block's device (no copy), else a copy there."""
    return shard_rows(mesh, torch.as_tensor(dataset), axes), shard_rows(
        mesh, torch.as_tensor(norms), axes)


def map_blocks(fn, *sharded: ShardedRows) -> ShardedRows:
    """``fn`` over the blocks of tensors sharded alike (one call a block, on
    its home device), placed as the first."""
    first = sharded[0]
    for s in sharded[1:]:
        if s.mesh != first.mesh or s.axes != first.axes:
            raise ValueError("map_blocks needs tensors sharded alike")
    return place_blocks(first.mesh, first.axes,
                        [fn(*(s.block(b) for s in sharded)) for b in range(first.n_blocks)])


def _as_sharded(mesh: Mesh, t, axes: tuple) -> ShardedRows:
    """`t` row-sharded over `axes`: a ShardedRows of that layout as it is,
    a tensor sharded here (as a jit'd shard_map shards its inputs)."""
    if isinstance(t, ShardedRows):
        if t.mesh != mesh or t.axes != axes:
            raise ValueError(f"rows sharded over {t.axes} of {t.mesh}; this function "
                             f"reads them over {axes} of {mesh}")
        return t
    return shard_rows(mesh, torch.as_tensor(t), axes)


def _split_queries(queries: torch.Tensor, parts: int) -> tuple:
    if queries.shape[0] % parts:
        raise ValueError(f"{queries.shape[0]} queries do not split over {parts} positions")
    return queries.split(queries.shape[0] // parts)


# ---------------------------------------------------------------- steps
def _local_scan(step: PartitionStep, state: TopK, queries, vectors, norms, base: int,
                chunk_rows: int | None) -> TopK:
    """One position's scan of its local rows into its queue. The plain
    step walks them in chunks of ``chunk_rows`` (None: one chunk); the
    kernel tiles the block itself."""
    n = int(vectors.shape[0])
    chunk = n if (step.backend == "cuda" or not chunk_rows) else int(chunk_rows)
    if n % chunk:
        raise ValueError(f"local rows {n} not divisible by chunk {chunk}")
    for off in range(0, n, chunk):
        state = step(state, queries, vectors[off: off + chunk], norms[off: off + chunk],
                     base + off, chunk)
    return state


def merge_queues(states: Sequence[TopK], device: torch.device, backend: str) -> TopK:
    """Exact merge of sorted queues of one width on `device`: one
    ``knn_merge`` of the stacked (m, P, w) queues on ``cuda`` (widths that
    are not a power of two padded with (+inf, -1) and cut back after),
    ``tree_merge_sorted`` otherwise. A single queue passes as it is."""
    states = [TopK(s.scores.to(device, non_blocking=True),
                   s.indices.to(device, non_blocking=True)) for s in states]
    if len(states) == 1:
        return states[0]
    v = torch.stack([s.scores for s in states])
    i = torch.stack([s.indices for s in states])
    if backend != "cuda":
        return tree_merge_sorted(v, i)
    from repro_torch.kernels.knn.kernel import knn_merge

    w = v.shape[-1]
    wp = next_pow2(w)
    if wp != w:
        v = torch.cat([v, v.new_full((*v.shape[:-1], wp - w), torch.inf)], -1)
        i = torch.cat([i, i.new_full((*i.shape[:-1], wp - w), -1)], -1)
    mv, mi = knn_merge(v.permute(1, 0, 2).contiguous(), i.permute(1, 0, 2).contiguous())
    return TopK(mv[:, :w], mi[:, :w])


def _gather_merge(states: dict, mesh: Mesh, axis: str, backend: str) -> dict:
    """Merge the queues of positions that differ only along `axis` onto the
    group's first position (coordinate 0 on `axis`): {coord: queue}."""
    ai = _axis(mesh, axis)
    groups: dict[tuple, list] = {}
    for c, st in states.items():
        groups.setdefault(c[:ai] + (0,) + c[ai + 1:], []).append((c[ai], st))
    return {key: merge_queues([st for _, st in sorted(members, key=lambda e: e[0])],
                        mesh.devices[key], backend)
            for key, members in groups.items()}


def _finish(step: PartitionStep, state: TopK, queries, shards) -> TopK:
    for p in shards:
        state = step(state, queries, p.vectors, p.norms, p.base_index, p.n_valid)
    return step.finish(state)


def _finish_blocks(mesh: Mesh, step: PartitionStep, states: dict, query_axis: str,
                   qblocks: Sequence[torch.Tensor], shards) -> TopK:
    """Finish each query block's queue on its position (the shards merged
    there) and concatenate the blocks in query order on the mesh's first
    device."""
    qi = _axis(mesh, query_axis)
    outs = []
    for c in sorted(states, key=lambda c: c[qi]):
        dev = mesh.devices[c]
        local = [p._replace(vectors=p.vectors.to(dev), norms=p.norms.to(dev)) for p in shards]
        out = _finish(step, states[c], qblocks[c[qi]].to(dev), local)
        outs.append(TopK(out.scores.to(mesh.first), out.indices.to(mesh.first)))
    return TopK(torch.cat([o.scores for o in outs]), torch.cat([o.indices for o in outs]))


def _ship(copies: CopyStreams, tensors: tuple, dev: torch.device) -> tuple:
    """A ring step's block on the next position, in memory of its own (a
    block never aliases another position's): on CUDA on `dev`'s copy
    stream (:class:`~repro_torch.core.streaming.CopyStreams`), which the
    next step joins before it reads them."""
    if dev.type != "cuda":
        return tuple(t.to(dev, copy=True) for t in tensors)
    return tuple(copies.put(t, dev, copy=True) for t in tensors)


# ------------------------------------------------------------- functions
def fdsq_sharded(
    mesh: Mesh,
    k: int,
    metric: Metric = "l2",
    data_axes: Sequence[str] = ("data", "model"),
    chunk_rows: int | None = None,
    backend: str = "torch",
):
    """Build the distributed FD-SQ function for `mesh`.

    Returns fn(query (m, d), dataset (N, d) and norms (N,) row-sharded over
    ``data_axes`` (ShardedRows, or tensors sharded here), shards=()) ->
    TopK on the mesh's first device. N must divide evenly over the product
    of the ``data_axes`` sizes (pad via repro_torch.core.partition first).

    Schedule, with P = prod(sizes of data_axes) blocks: every block's
    position scans it into its queue (``cuda``: ``knn_shard``, one
    ``knn_scan`` — two when the block's rows are not a multiple of the
    scan's row tile: the aligned rows in place, the tail padded — and one
    ``knn_merge``), then the queues merge along each axis, innermost first,
    one ``knn_merge`` per group of more than one position: for sizes
    (a_1, ..., a_n), a_1·...·a_{n-1} merges over the last axis, then
    a_1·...·a_{n-2}, ..., 1 (a 2 x 2 mesh: 2 + 1). Each delta shard adds
    one ``knn_scan`` and one ``knn_merge`` on the first device.
    """
    validate_metric(metric)
    axes = _axes(data_axes)
    coords = _coords(mesh, axes)
    step = PartitionStep(k, metric, backend)

    def fn(query, dataset, norms, shards=()):
        x, xn = _as_sharded(mesh, dataset, axes), _as_sharded(mesh, norms, axes)
        states = {}
        for c in coords:
            p = int(np.ravel_multi_index(c, mesh.devices.shape))
            q = query.to(mesh.devices[c], non_blocking=True)
            states[c] = _local_scan(step, step.init(q.shape[0], q.device), q, x.local[p],
                                    xn.local[p], _block_id(mesh, c, axes) * x.rows, chunk_rows)
        for ax in reversed(axes):
            states = _gather_merge(states, mesh, ax, backend)
        (state,) = states.values()
        return _finish(step, state, query.to(mesh.first), shards)

    return fn


def fqsd_sharded(
    mesh: Mesh,
    k: int,
    metric: Metric = "l2",
    query_axis: str = "data",
    dataset_axis: str = "model",
    chunk_rows: int | None = None,
    backend: str = "torch",
):
    """Distributed FQ-SD for corpora small enough to replicate over
    ``query_axis``.

    fn(queries (M, d), dataset (N, d), norms (N,), shards=()): the queries
    shard over ``query_axis`` (M must divide evenly), the dataset over
    ``dataset_axis``; every position scans its query block against its
    dataset block; one merge stage over ``dataset_axis`` per query block;
    the blocks' answers concatenate on the mesh's first device.
    """
    validate_metric(metric)
    qi, coords = _axis(mesh, query_axis), _coords(mesh, (query_axis, dataset_axis))
    step = PartitionStep(k, metric, backend)

    def fn(queries, dataset, norms, shards=()):
        axes = (dataset_axis,)
        x, xn = _as_sharded(mesh, dataset, axes), _as_sharded(mesh, norms, axes)
        qb = _split_queries(queries, mesh.shape[query_axis])
        states = {}
        for c in coords:
            p = int(np.ravel_multi_index(c, mesh.devices.shape))
            q = qb[c[qi]].to(mesh.devices[c], non_blocking=True)
            states[c] = _local_scan(step, step.init(q.shape[0], q.device), q, x.local[p],
                                    xn.local[p], _block_id(mesh, c, axes) * x.rows, chunk_rows)
        states = _gather_merge(states, mesh, dataset_axis, backend)
        return _finish_blocks(mesh, step, states, query_axis, qb, shards)

    return fn


def _ring_layout(mesh: Mesh, query_axis: str, model_axis: str | None):
    """(D, T, axes the dataset shards over, coordinate of ring position
    (d, t)) of a ring over `query_axis`; no `model_axis` means T = 1."""
    qi = _axis(mesh, query_axis)
    mi = None if model_axis is None else _axis(mesh, model_axis)
    d_sz = mesh.shape[query_axis]
    t_sz = 1 if model_axis is None else mesh.shape[model_axis]
    axes = (query_axis,) if model_axis is None else (query_axis, model_axis)

    def coord(d: int, t: int) -> tuple:
        c = [0] * len(mesh.axis_names)
        c[qi] = d
        if mi is not None:
            c[mi] = t
        return tuple(c)

    return d_sz, t_sz, axes, coord


def _ring_finish(mesh, step, states, model_axis, query_axis, qblocks, backend, shards):
    """Merge over ``model_axis``, then finish each query block
    (:func:`_finish_blocks`)."""
    if model_axis is not None:
        states = _gather_merge(states, mesh, model_axis, backend)
    return _finish_blocks(mesh, step, states, query_axis, qblocks, shards)


def fqsd_ring(
    mesh: Mesh,
    k: int,
    metric: Metric = "l2",
    query_axis: str = "data",
    model_axis: str | None = "model",
    chunk_rows: int | None = None,
    backend: str = "torch",
):
    """Ring-streamed FQ-SD: fully partitioned dataset, copies overlapped
    with scans.

    Layout: queries over ``query_axis`` (D blocks); the dataset over
    (query_axis, model_axis) jointly, block d·T + t at position (d, t).
    ``model_axis=None`` is a ring over a one-axis mesh (T = 1). At ring
    step s every position scans the block it holds, first held by position
    ((d - s) mod D, t), so its rows start at ((d - s) mod D · T + t)·rows;
    before the step's scans are queued, each block is shipped to position
    ((d + 1) mod D, t) on that device's copy stream, into memory of its
    own, and the step after waits for the copies — the double-buffering
    schedule of paper section 3.3 on the ring (the copy of step s + 1's
    blocks overlaps step s's scans; on one card both share its memory
    bandwidth). After D steps every query block has seen every block of
    its model column; one merge over ``model_axis`` completes the exact
    result. The transfer after the last step is skipped: the result does
    not read it.

    Launches on ``cuda``: D·D·T block scans of m/D queries (every position
    at every step: ``knn_shard`` each, as in :func:`fdsq_sharded`), then D
    groups of T merged over ``model_axis`` (D ``knn_merge`` when T > 1);
    D - 1 ring steps of D·T block copies.
    """
    validate_metric(metric)
    d_sz, t_sz, axes, coord = _ring_layout(mesh, query_axis, model_axis)
    step = PartitionStep(k, metric, backend)
    ring = [(d, t) for d in range(d_sz) for t in range(t_sz)]

    def fn(queries, dataset, norms, shards=()):
        x, xn = _as_sharded(mesh, dataset, axes), _as_sharded(mesh, norms, axes)
        rows = x.rows
        qb = _split_queries(queries, d_sz)
        flat = {dt: int(np.ravel_multi_index(coord(*dt), mesh.devices.shape)) for dt in ring}
        dev = {dt: mesh.devices[coord(*dt)] for dt in ring}
        cur = {dt: (x.local[flat[dt]], xn.local[flat[dt]]) for dt in ring}
        qs = {dt: qb[dt[0]].to(dev[dt], non_blocking=True) for dt in ring}
        states = {dt: step.init(qs[dt].shape[0], dev[dt]) for dt in ring}
        copies = CopyStreams()
        for s in range(d_sz):
            nxt = None
            if s < d_sz - 1:  # ship first, then queue the scans: they overlap
                nxt = {((d + 1) % d_sz, t): _ship(copies, cur[d, t], dev[(d + 1) % d_sz, t])
                       for d, t in ring}
            for d, t in ring:
                base = (((d - s) % d_sz) * t_sz + t) * rows
                states[d, t] = _local_scan(step, states[d, t], qs[d, t], *cur[d, t], base,
                                           chunk_rows)
            if nxt is not None:
                copies.join()
                cur = nxt
        return _ring_finish(mesh, step, {coord(*dt): st for dt, st in states.items()},
                            model_axis, query_axis, qb, backend, shards)

    return fn


def fqsd_ring_queries(
    mesh: Mesh,
    k: int,
    metric: Metric = "l2",
    query_axis: str = "data",
    model_axis: str | None = "model",
    backend: str = "torch",
):
    """Query-direction ring (the reference's optimisation of
    :func:`fqsd_ring`).

    The same layout as :func:`fqsd_ring`, but the DATASET stays stationary
    and the (query block, running queue) pair rotates around the
    ``query_axis`` ring: each step moves m/D·(d + 2k) values a position
    instead of a dataset block. After D steps every pair has visited every
    block of its model column and is back at its home position; one merge
    over ``model_axis`` finishes. A pair moves with ``Tensor.to`` (a no-op
    between logical positions of one device: the queue is fresh every
    step, so nothing is aliased that a later step writes).
    """
    validate_metric(metric)
    d_sz, t_sz, axes, coord = _ring_layout(mesh, query_axis, model_axis)
    step = PartitionStep(k, metric, backend)
    ring = [(d, t) for d in range(d_sz) for t in range(t_sz)]

    def fn(queries, dataset, norms, shards=()):
        x, xn = _as_sharded(mesh, dataset, axes), _as_sharded(mesh, norms, axes)
        rows = x.rows
        qb = _split_queries(queries, d_sz)
        dev = {dt: mesh.devices[coord(*dt)] for dt in ring}
        flat = {dt: int(np.ravel_multi_index(coord(*dt), mesh.devices.shape)) for dt in ring}
        qs = {dt: qb[dt[0]].to(dev[dt], non_blocking=True) for dt in ring}
        states = {dt: step.init(qs[dt].shape[0], dev[dt]) for dt in ring}
        for _ in range(d_sz):
            for d, t in ring:
                states[d, t] = _local_scan(step, states[d, t], qs[d, t], x.local[flat[d, t]],
                                           xn.local[flat[d, t]], (d * t_sz + t) * rows, None)
            moved = {((d + 1) % d_sz, t): (qs[d, t], states[d, t]) for d, t in ring}
            qs = {dt: q.to(dev[dt], non_blocking=True) for dt, (q, _) in moved.items()}
            states = {dt: TopK(st.scores.to(dev[dt], non_blocking=True),
                               st.indices.to(dev[dt], non_blocking=True))
                      for dt, (_, st) in moved.items()}
        return _ring_finish(mesh, step, {coord(*dt): st for dt, st in states.items()},
                            model_axis, query_axis, qb, backend, shards)

    return fn


def fdsq_sharded_int8(
    mesh: Mesh,
    r: int,
    data_axes: Sequence[str] = ("data", "model"),
    backend: str = "torch",
):
    """Distributed certified-int8 first pass: the mesh analogue of
    :func:`repro_torch.core.quantized.make_int8_bound_step`.

    Returns fn(queries (m, d), codes (N, d) int8 and scales / err / qnorm
    (N,) row-sharded over ``data_axes``) -> TopK of (m, r+1) certified
    lower-bound queues on the mesh's first device, globally exact: every
    position computes reverse-triangle lower bounds of its rows only and
    keeps a widened (m, r+1) queue (``cuda``: ``knn_int8_shard``, one
    ``knn_int8_scan`` and one ``knn_merge``), and the queues merge along the
    axes as in :func:`fdsq_sharded` (one ``knn_merge`` a group, at width
    next_pow2(r + 1)). ``qnorm`` carries validity (+inf = excluded). The
    caller rescores the candidate ids in f32 and certifies (``lb[:, r]`` is
    the best lower bound OUTSIDE the candidate set).
    """
    if r < 1:
        raise ValueError(f"rescore budget r must be >= 1, got {r}")
    axes = _axes(data_axes)
    coords = _coords(mesh, axes)

    def local_queue(q, codes, scales, err, qnorm, base):
        if backend == "cuda":
            from repro_torch.kernels.knn.ops import knn_int8_shard

            m = q.shape[0]
            lb = torch.full((m, r + 1), torch.inf, dtype=torch.float32, device=q.device)
            li = torch.full((m, r + 1), -1, dtype=torch.int32, device=q.device)
            return TopK(*knn_int8_shard(lb, li, q, codes, scales, err, qnorm, base, r))
        lower, idx = int8_lower_bounds(q, codes, scales, err, qnorm, base)
        return TopK(*topk_smallest(lower, idx.expand(lower.shape), r + 1))

    def fn(queries, codes, scales, err, qnorm):
        ch = [_as_sharded(mesh, t, axes) for t in (codes, scales, err, qnorm)]
        rows = ch[0].rows
        states = {}
        for c in coords:
            p = int(np.ravel_multi_index(c, mesh.devices.shape))
            q = queries.to(mesh.devices[c], non_blocking=True)
            states[c] = local_queue(q, *(t.local[p] for t in ch),
                                    _block_id(mesh, c, axes) * rows)
        for ax in reversed(axes):
            states = _gather_merge(states, mesh, ax, backend)
        (state,) = states.values()
        return state

    return fn


__all__ = ["ShardedRows", "fdsq_sharded", "fdsq_sharded_int8", "fqsd_ring",
           "fqsd_ring_queries", "fqsd_sharded", "map_blocks", "merge_queues",
           "place_blocks", "shard_dataset", "shard_rows"]
