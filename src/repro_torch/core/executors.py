"""Executor registry — the uniform "run the plan" layer of the engine.

Each executor is a callable ``execute(plan, queries, dataset, ctx) -> TopK``
registered under the name the planner selects
(``repro_torch.core.planner``). Executors wrap the entry points of
``fdsq.py`` / ``fqsd.py`` / ``quantized.py`` / ``sharded.py`` /
``kernels.knn`` and add no numerics of their own. The streamed executors
read host shards through the double buffer (``streaming.py``), the mesh
executors run the functions of ``sharded.py`` over ``ExecContext.mesh``;
the per-shard and per-device steps of both run on the plan's backend: the
kernels on ``cuda``, plain ops on ``torch``.

The module also owns the **executable cache**: every executor resolves
its callable through :func:`_cached`, keyed by ``plan.cache_key()`` plus
the concrete tensor shapes, dtypes and device. PyTorch compiles nothing
per shape, so an entry is the plan's bound callable; the cache keeps the
paper's "no reflashing" invariant observable — switching FD-SQ <-> FQ-SD
for shapes already seen adds no entry (:func:`cache_info`). It is a
bounded LRU (:func:`set_executable_cache_limit`); evictions are counted.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from collections import OrderedDict
from typing import Callable, Iterable, NamedTuple

import torch

from repro_torch.core import partition as part
from repro_torch.core import sharded as sh
from repro_torch.core.distance import direct_l2_sq
from repro_torch.core.fdsq import fdsq_search
from repro_torch.core.fqsd import (
    PartitionStep,
    fqsd_scan,
    fqsd_streamed,
    make_direct_partition_step,
    streamed_direct_scan,
)
from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.quantized import (
    QuantizedDataset,
    knn_quantized,
    make_int8_bound_step,
)
from repro_torch.core.streaming import (
    DoubleBufferedStream,
    ResilientShardSource,
    SpeculativeGather,
    _fresh_health,
    make_ring_put,
)
from repro_torch.core.topk import TopK, sort_pairs

#: Default speculation trigger for the streamed int8 executors: start the
#: background candidate gather once this fraction of shards has merged.
#: 1.0 disables speculation (gather strictly after the scan).
DEFAULT_SPEC_TRIGGER = 0.5


@dataclasses.dataclass
class ExecContext:
    """Runtime state a plan cannot carry (plans are pure data): the mesh,
    its axis names and the streaming knobs. Executors may write run
    observability back here (the int8 certificate)."""

    #: the device mesh of the sharded executors (repro_torch.core.mesh.Mesh)
    mesh: object = None
    #: the mesh axes the dataset rows shard over
    mesh_axes: tuple = ("data", "model")

    #: set by the int8 executors: (m,) bool, True where the on-chip
    #: candidates provably held the exact top-k
    certificate: torch.Tensor | None = None
    #: set by the fused-kernel executors: {"prune_skip_rate": 0-d tensor,
    #: "blocks": (bm, bn, bd)}. The skip rate stays a device scalar so
    #: publishing stats never forces a host sync; float() it lazily.
    kernel_stats: dict | None = None
    #: the resident dataset rows were L2-normalised at fit time (cos metric
    #: via the fused kernel, which then skips its own dataset pass)
    cos_prenormalized: bool = False
    #: streamed-scan double-buffer depth (2 = one shard in flight)
    prefetch_depth: int = 2
    #: set by the streamed executors: {"transfers": n, "restarts": n} from
    #: the double buffer
    stream_stats: dict | None = None
    #: set by executors whose traffic the plan geometry cannot predict
    #: (streamed int8: codes + per-row channels + candidate-row rescore
    #: reads); None = the engine derives bytes from the plan
    bytes_scanned: int | None = None
    #: speculation trigger override for the streamed int8 executors; None
    #: defers to the plan's value, then DEFAULT_SPEC_TRIGGER
    spec_trigger: float | None = None
    #: set by the streamed int8 executors: {"scan_ms", "gather_ms",
    #: "rescore_ms"}, the wall-time split of the pipelined search
    phase_ms: dict | None = None
    #: set by the streamed int8 executors: {"trigger", "rows_speculated",
    #: "rows_topped_up", "rows_wasted", "failed"}; wasted speculative
    #: fetches are also charged to bytes_scanned
    speculation: dict | None = None
    #: set by the mesh int8 executors: scan bytes each device moved (one
    #: entry a mesh position); the total still lands on bytes_scanned,
    #: which also carries the host-side gather, delta and fallback traffic
    device_bytes: list | None = None
    #: a resident engine's delta shards on the device (PaddedDataset, a
    #: filter mask folded into their norms); fdsq-cuda merges them into its
    #: kernel queue, and the engine merges them after any other executor
    delta: tuple = ()
    #: set by executors that merge the delta shards themselves (fdsq-cuda
    #: merges ``delta``; the streamed int8 rescore tail merges the store's),
    #: so the engine never scores them twice
    delta_folded: bool = False
    #: bounded-retry budget for shard reads, candidate gathers and
    #: transfers (exponential backoff from retry_backoff_s)
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    #: the request opted into partial results: a shard unrecoverable on
    #: every tier is skipped and listed in health["failed_shards"]
    allow_partial: bool = False
    #: resilience accounting of this run ({"retries", "degraded",
    #: "failed_shards", "slow_shards"}); made lazily by the streamed
    #: executors, surfaced by the engine as stats["health"]
    health: dict | None = None


class TieredResident(NamedTuple):
    """Resident dataset carrying both tiers: the exact f32 base and the
    1 B/element int8 scan tier (what the int8 executors consume)."""

    f32: part.PaddedDataset
    quant: QuantizedDataset


class MeshTiered(NamedTuple):
    """Mesh-resident int8 tier (what fdsq-sharded-int8 reads): the quantised
    channels row-sharded over the mesh axes (``sharded.ShardedRows``), plus
    the backing store for the candidate-only f32 rescore (``gather_rows``)
    and the exact streamed fallback. The f32 tier never lives on the mesh:
    only candidate rows of it are read."""

    quant: QuantizedDataset
    store: object


Executor = Callable[[ExecutionPlan, torch.Tensor, object, ExecContext], TopK]

_REGISTRY: dict[str, Executor] = {}
_EXECUTABLE_CACHE: "OrderedDict[tuple, Callable]" = OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
#: LRU bound on cached callables (None = unbounded).
_CACHE_MAX_ENTRIES: int | None = 256


# ----------------------------------------------------------------- registry
def register_executor(name: str):
    """Decorator: ``@register_executor("fdsq-torch")``."""

    def deco(fn: Executor) -> Executor:
        if name in _REGISTRY:
            raise ValueError(f"executor {name!r} already registered")
        fn.executor_name = name
        _REGISTRY[name] = fn
        return fn

    return deco


def get_executor(name: str) -> Executor:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown executor {name!r}; registered: {list_executors()}"
        ) from None


def list_executors() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def execute(plan: ExecutionPlan, queries: torch.Tensor, dataset,
            ctx: ExecContext | None = None) -> TopK:
    """Dispatch `plan` to its registered executor."""
    return get_executor(plan.executor)(plan, queries, dataset, ctx or ExecContext())


# ------------------------------------------------------- executable cache
def _cached(key: tuple, build: Callable[[], Callable]) -> Callable:
    try:
        fn = _EXECUTABLE_CACHE[key]
        _EXECUTABLE_CACHE.move_to_end(key)  # LRU: reads refresh recency
        _CACHE_STATS["hits"] += 1
        return fn
    except KeyError:
        fn = _EXECUTABLE_CACHE[key] = build()
        _CACHE_STATS["misses"] += 1
        _evict_over_limit()
        return fn


def _evict_over_limit() -> None:
    if _CACHE_MAX_ENTRIES is None:
        return
    while len(_EXECUTABLE_CACHE) > _CACHE_MAX_ENTRIES:
        _EXECUTABLE_CACHE.popitem(last=False)  # least recently used
        _CACHE_STATS["evictions"] += 1


def set_executable_cache_limit(max_entries: int | None) -> None:
    """Bound the cache (None = unbounded). Shrinking evicts the
    least-recently-used entries immediately (counted in cache_info)."""
    global _CACHE_MAX_ENTRIES
    if max_entries is not None and max_entries < 1:
        raise ValueError(f"max_entries must be >= 1 or None, got {max_entries}")
    _CACHE_MAX_ENTRIES = max_entries
    _evict_over_limit()


def cache_info() -> dict:
    """{"hits", "misses", "evictions", "size", "max_entries"}."""
    return {
        **_CACHE_STATS,
        "size": len(_EXECUTABLE_CACHE),
        "max_entries": _CACHE_MAX_ENTRIES,
    }


def clear_executable_cache() -> None:
    _EXECUTABLE_CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0
    _CACHE_STATS["evictions"] = 0


def _arr_key(a: torch.Tensor) -> tuple:
    return (tuple(a.shape), str(a.dtype), str(a.device))


def cached_partition_step(k: int, metric: str, backend: str = "torch") -> PartitionStep:
    """The shared streamed-scan step (one partition into the queues) of
    (k, metric) on `backend`; PyTorch compiles nothing per shape, so one
    entry serves every shard shape, streamed shards and the engine's delta
    shards alike."""
    return _cached(("partition-step", k, metric, backend),
                   lambda: PartitionStep(k, metric, backend))


def cached_direct_step(k: int):
    """The shared direct-form step (:func:`make_direct_partition_step`) of
    width k: the streamed int8 oracle and fallback, and the exact merge of
    delta rows into an int8 result."""
    return _cached(("direct-step", k), lambda: make_direct_partition_step(k))


# ------------------------------------------------------------- executors
@register_executor("fdsq-torch")
def _fdsq_torch(plan, queries, dataset: part.PaddedDataset, ctx) -> TopK:
    """Partition fan-out + tree merge (latency path, fig. 2)."""
    key = (plan.cache_key(), _arr_key(queries), _arr_key(dataset.vectors))
    fn = _cached(key, lambda: functools.partial(
        fdsq_search, k=plan.k, metric=plan.metric, n_partitions=plan.n_partitions))
    return fn(queries, dataset.vectors, dataset.norms)


@register_executor("fqsd-torch")
def _fqsd_torch(plan, queries, dataset: part.PaddedDataset, ctx) -> TopK:
    """Chunked queue scan over resident data (throughput path, fig. 1)."""
    key = (plan.cache_key(), _arr_key(queries), _arr_key(dataset.vectors))
    fn = _cached(key, lambda: functools.partial(
        fqsd_scan, k=plan.k, metric=plan.metric, chunk_rows=plan.chunk_rows))
    return fn(queries, dataset.vectors, dataset.norms)


def _plan_blocks(plan) -> tuple[int, int, int]:
    """A plan's kernel tile shapes; 0 = the kernel defaults."""
    from repro_torch.kernels.knn.ops import DEFAULT_BLOCKS

    return (plan.block_m or DEFAULT_BLOCKS[0],
            plan.block_n or DEFAULT_BLOCKS[1],
            plan.block_d or DEFAULT_BLOCKS[2])


@register_executor("fdsq-cuda")
def _fdsq_cuda(plan, queries, dataset: part.PaddedDataset, ctx) -> TopK:
    """The fused distance + queue kernel; one entry serves both logical
    modes. A resident engine's delta shards (ctx.delta) merge into the
    kernel's queue, one ``knn_scan`` + ``knn_merge`` each, before it is
    finished once. The pruning skip rate (of the main scan) and the
    resolved tile shapes land on ctx.kernel_stats."""
    from repro_torch.kernels.knn import ops as knn_ops

    bm, bn, bd = _plan_blocks(plan)
    pre = bool(ctx.cos_prenormalized) and plan.metric == "cos"
    key = (plan.cache_key(), _arr_key(queries), _arr_key(dataset.vectors), pre)
    fn = _cached(key, lambda: functools.partial(
        knn_ops.knn, k=plan.k, metric=plan.metric, block_m=bm, block_n=bn,
        block_d=bd, return_stats=True, x_prenormalized=pre))
    out, skip_rate = fn(queries, dataset.vectors, x_norms=dataset.norms,
                        shards=[(p.vectors, p.norms, p.base_index) for p in ctx.delta])
    ctx.delta_folded = bool(ctx.delta)
    ctx.kernel_stats = {
        "prune_skip_rate": skip_rate,
        "blocks": knn_ops.resolved_blocks(plan.k, plan.padded_dim, bm, bn, bd,
                                          m=plan.m),
    }
    return out


def _exact_uncertified(plan, queries, dataset: TieredResident, out: TopK,
                       cert: torch.Tensor, exact_fn) -> TopK:
    """Recompute the rows the certificate cannot cover over the f32 tier
    with ``exact_fn`` (``knn_exact_direct``, or ``knn_exact_rescored``: the
    same bits through the f32 kernel), so every returned row is exact and
    carries the bits the rescore gives a pair. Only those query rows are
    rescanned: each row's answer is independent of the others."""
    bad = ~cert
    if not bool(bad.any()):
        return out
    f32 = dataset.f32
    key = ("int8-fallback", exact_fn.__name__, plan.cache_key(), _arr_key(f32.vectors))
    fn = _cached(key, lambda: functools.partial(exact_fn, k=plan.k,
                                                chunk_rows=plan.chunk_rows))
    exact = fn(queries[bad], f32.vectors, f32.norms)
    scores, indices = out.scores.clone(), out.indices.clone()
    scores[bad], indices[bad] = exact.scores, exact.indices
    return TopK(scores, indices)


@register_executor("fqsd-int8-torch")
def _fqsd_int8_torch(plan, queries, dataset: TieredResident, ctx) -> TopK:
    """Quantised FQ-SD in plain ops: int8 first pass + exact f32 rescore
    (``knn_quantized``). The per-query certificate lands on
    ctx.certificate; uncertified rows are recomputed exactly. The reference's
    ``fqsd-int8`` recomputes them in the cancellation form (``fqsd_scan``);
    both int8 executors here use the direct form, so every row carries the
    bits of ``knn_exact_direct``."""
    from repro_torch.kernels.knn.ops import knn_exact_direct

    q8 = dataset.quant
    key = (plan.cache_key(), _arr_key(queries), _arr_key(q8.q))
    fn = _cached(key, lambda: functools.partial(
        knn_quantized, k=plan.k, rescore_factor=plan.rescore_factor))
    out, cert = fn(queries, q8, dataset.f32.vectors)
    ctx.certificate = cert
    return _exact_uncertified(plan, queries, dataset, out, cert, knn_exact_direct)


@register_executor("fqsd-int8-cuda")
def _fqsd_int8_cuda(plan, queries, dataset: TieredResident, ctx) -> TopK:
    """Fused quantised FQ-SD: the int8 scan kernel reads the codes at
    1 B/element and keeps the widened candidate queue on chip; the exact
    rescore reads only the candidate rows of the f32 tier. The certificate
    lands on ctx.certificate; uncertified rows are recomputed exactly by
    ``knn_exact_rescored`` (the f32 kernel's candidates, rescored in the
    direct form). The skip rate and tile shapes land on ctx.kernel_stats."""
    from repro_torch.kernels.knn import ops as knn_ops

    q8 = dataset.quant
    bm, bn, bd = _plan_blocks(plan)
    key = (plan.cache_key(), _arr_key(queries), _arr_key(q8.q))
    fn = _cached(key, lambda: functools.partial(
        knn_ops.knn_int8, k=plan.k, rescore_factor=plan.rescore_factor, block_m=bm,
        block_n=bn, block_d=bd, return_stats=True))
    out, cert, skip_rate = fn(queries, q8, dataset.f32.vectors)
    ctx.certificate = cert
    ctx.kernel_stats = {
        "prune_skip_rate": skip_rate,
        "blocks": knn_ops.resolved_blocks(plan.k, plan.padded_dim, bm, bn, bd, m=plan.m,
                                          rescore_factor=plan.rescore_factor),
    }
    return _exact_uncertified(plan, queries, dataset, out, cert, knn_ops.knn_exact_rescored)


# ------------------------------------------------------ streamed executors
def _ctx_health(ctx: ExecContext) -> dict:
    if ctx.health is None:
        ctx.health = _fresh_health()
    return ctx.health


def _with_retries(fn: Callable, ctx: ExecContext):
    """Bounded retry with exponential backoff for host-side store reads
    (candidate gathers, delta transfers). Every failed attempt counts into
    ``ctx.health["retries"]``; the last failure propagates."""
    delay = ctx.retry_backoff_s
    for attempt in range(ctx.max_retries + 1):
        try:
            return fn()
        except Exception:
            _ctx_health(ctx)["retries"] += 1
            if attempt == ctx.max_retries:
                raise
            if delay > 0:
                time.sleep(delay)
                delay *= 2


def _resilient_source(store, tier: str, ctx: ExecContext):
    """The shard source of a streamed scan: self-healing when the dataset
    exposes per-shard reads (``read_shard``: DatasetStore and the engine's
    masked view), the store's plain restartable source otherwise."""
    if hasattr(store, "read_shard"):
        return ResilientShardSource(
            store, tier, max_retries=ctx.max_retries, backoff_s=ctx.retry_backoff_s,
            allow_partial=ctx.allow_partial, health=_ctx_health(ctx))
    return store.shard_source(tier)


def _stream_f32(plan, queries, source, ctx) -> TopK:
    ctx.stream_stats = {}
    return fqsd_streamed(
        queries, source, plan.k, plan.metric, prefetch_depth=ctx.prefetch_depth,
        step_fn=cached_partition_step(plan.k, plan.metric, plan.backend),
        stream_stats=ctx.stream_stats, put_retries=ctx.max_retries,
        retry_backoff_s=ctx.retry_backoff_s, health=_ctx_health(ctx))


@register_executor("fqsd-streamed")
def _fqsd_streamed(plan, queries, dataset: Iterable[part.PaddedDataset], ctx) -> TopK:
    """Host-streamed FQ-SD over an iterable of equal padded partitions,
    through the double buffer; each partition is one step on the plan's
    backend (``knn_scan`` + ``knn_merge`` on ``cuda``)."""
    return _stream_f32(plan, queries, dataset, ctx)


@register_executor("fqsd-mmap-streamed")
def _fqsd_mmap_streamed(plan, queries, dataset, ctx) -> TopK:
    """Store-driven FQ-SD over a DatasetStore kept off the device: its
    shards stream through the double buffer, overlapped with the step on
    the previous shard (paper section 3.3), read through the self-healing
    source (retries, ``allow_partial``). Shares the cached step with
    fqsd-streamed."""
    source = (_resilient_source(dataset, "f32", ctx) if hasattr(dataset, "read_shard")
              else dataset.iter_shards())
    return _stream_f32(plan, queries, source, ctx)


def _rescore_budget(plan) -> int:
    """The candidate budget r of a streamed int8 plan: rescore_factor · k,
    clamped to the dataset and >= 1 (the reference's budget, not the
    resident kernel's power of two, so the certificate reads the same
    queue entry)."""
    return max(1, min(int(plan.padded_rows), int(plan.rescore_factor) * plan.k))


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _rescore_certify(plan, queries, store, ctx, lb, li, scan_bytes, spec=None,
                     t_start=None, trigger=1.0) -> TopK:
    """Epilogue of the streamed int8 executors: given the final (m, r+1)
    lower-bound queue, gather the candidate f32 rows from the host store
    (reusing a speculative gather when one ran), rescore them in the direct
    form, merge the live delta shards, certify, and fall back to the
    streamed f32 oracle for uncertified queries. Plain ops, as in the
    reference; every distance sums over d in the fixed order of
    ``direct_l2_sq``, so certified rows equal the oracle bit for bit."""
    if t_start is None:
        t_start = time.perf_counter()
    m = int(queries.shape[0])
    r = _rescore_budget(plan)
    dev = queries.device
    direct_step = cached_direct_step(plan.k)
    if ctx.stream_stats is None:
        ctx.stream_stats = {"transfers": 0, "restarts": 0}

    # pull ONLY the candidate indices to the host, dedup across queries
    cand_idx = li[:, :r].to("cpu", torch.int64)
    lb_r1 = lb[:, r]  # best lower bound OUTSIDE the candidate set
    t_scan = time.perf_counter()
    uniq, inv = torch.unique(cand_idx, return_inverse=True)
    rows_speculated = rows_topped = rows_wasted = 0
    spec_res = spec.result() if spec is not None else None
    # a failed speculation degrades to the synchronous gather of the final
    # ids: the speculation only ever rescheduled reads
    spec_failed = int(spec is not None and spec_res is None)
    if spec_res is not None:
        spec_ids, spec_rows = spec_res
        # diff the final queue against the snapshot: reuse hits by id, top
        # up only the ids the late shards added; the unique rows are put
        # together on the device from the two host gathers
        pos = torch.searchsorted(spec_ids, uniq)
        pos_c = pos.clamp(max=max(0, spec_ids.numel() - 1))
        hit = ((spec_ids[pos_c] == uniq) if spec_ids.numel()
               else torch.zeros(uniq.shape, dtype=torch.bool))
        rows = spec_rows.to(dev, non_blocking=True)[pos_c.to(dev)]
        missing = uniq[~hit]
        if missing.numel():
            rows[(~hit).to(dev)] = _with_retries(lambda: store.gather_rows(missing),
                                                 ctx).to(dev, non_blocking=True)
        rows_speculated = int((spec_ids >= 0).sum())
        rows_topped = int((missing >= 0).sum())
        rows_wasted = rows_speculated - int((uniq[hit] >= 0).sum())
        # every fetched row is traffic, used or not
        scan_bytes += (rows_speculated + rows_topped) * int(rows.shape[1]) * 4
    else:
        rows = _with_retries(lambda: store.gather_rows(uniq), ctx).to(dev, non_blocking=True)
        scan_bytes += int((uniq >= 0).sum()) * int(rows.shape[1]) * 4
    ctx.speculation = {"trigger": trigger, "rows_speculated": rows_speculated,
                       "rows_topped_up": rows_topped, "rows_wasted": rows_wasted,
                       "failed": spec_failed}
    # the unique rows went to the device once; (m, r, d) is indexed there
    cand_vecs = rows[inv.to(dev)]
    t_gather = time.perf_counter()
    idx = cand_idx.to(dev, torch.int32)
    exact = torch.where(idx >= 0, direct_l2_sq(queries, cand_vecs), torch.inf)
    s, i = sort_pairs(exact, idx)
    s, i = s[:, :plan.k], i[:, :plan.k]

    # live delta rows have no int8 representation: merge them exactly
    # through the direct-form step the oracle uses (order-invariant). They
    # reach the card through a double buffer of their own, whose
    # page-locked banks stage a pageable delta block: a copy from pageable
    # memory is not asynchronous, and no block is pinned for a search
    deltas = DoubleBufferedStream(store.delta_shards(), depth=ctx.prefetch_depth,
                                  put_retries=ctx.max_retries,
                                  retry_backoff_s=ctx.retry_backoff_s,
                                  health=_ctx_health(ctx), device=dev)
    for dp in deltas:
        s, i = direct_step(s, i, queries, dp.vectors, dp.norms, dp.base_index)
        scan_bytes += int(dp.vectors.shape[0]) * int(dp.vectors.shape[1]) * 4
    ctx.delta_folded = True

    cert = (lb_r1 > s[:, plan.k - 1]) | ~torch.isfinite(lb_r1)
    ctx.certificate = cert
    out = TopK(s, torch.where(torch.isfinite(s), i, -1))
    bad = ~cert
    if bool(bad.any()):
        fb_stats: dict = {}
        exact_rows = streamed_direct_scan(
            queries[bad], _resilient_source(store, "f32", ctx), plan.k,
            prefetch_depth=ctx.prefetch_depth, step_fn=direct_step, stream_stats=fb_stats,
            put_retries=ctx.max_retries, retry_backoff_s=ctx.retry_backoff_s,
            health=_ctx_health(ctx))
        # the fallback is a second full pass: its shipped partitions join
        # the transfer account
        for key in ("transfers", "restarts"):
            ctx.stream_stats[key] += fb_stats.get(key, 0)
        scan_bytes += int(plan.padded_rows) * int(plan.padded_dim) * 4
        scores, indices = out.scores.clone(), out.indices.clone()
        scores[bad], indices[bad] = exact_rows.scores, exact_rows.indices
        out = TopK(scores, indices)
    _sync(out.scores)
    ctx.phase_ms = {"scan_ms": (t_scan - t_start) * 1e3,
                    "gather_ms": (t_gather - t_scan) * 1e3,
                    "rescore_ms": (time.perf_counter() - t_gather) * 1e3}
    ctx.bytes_scanned = scan_bytes
    return out


def _int8_streamed(plan, queries, store, ctx) -> TopK:
    """Shared body of the streamed int8 executors (host-RAM and mmap shards
    run the same schedule; the plan label tells them apart).

    1. **1 B/element scan**: the int8 tier streams shard by shard through
       the double buffer as multi-array partitions (codes + scales + err +
       validity-folded exact quantised norms in one slot), each merged into
       a global (m, r+1) queue of certified lower bounds (r = rescore_factor
       · k; entry r is the certificate's view of the best row outside the
       candidates) by the step of the plan's backend: ``knn_int8_scan`` +
       ``knn_merge`` on ``cuda``. Once a fraction ``trigger`` of the shards
       has merged, a snapshot of the queue goes to a background
       :class:`SpeculativeGather` that reads its f32 rows while the card
       drains the remaining shards.
    2. **candidate-only rescore** and 3. **certify or fall back**:
       :func:`_rescore_certify`.

    The certificate lands on ``ctx.certificate``, the transfer counters on
    ``ctx.stream_stats``, the traffic (codes + per-row channels + candidate
    reads incl. wasted speculation + delta/fallback bytes) on
    ``ctx.bytes_scanned``, the wall-time split on ``ctx.phase_ms`` and the
    speculation counters on ``ctx.speculation``. The pipeline knobs (depth,
    trigger) are absent from every cache key: they reschedule host work and
    never build a new step.
    """
    t_start = time.perf_counter()
    m = int(queries.shape[0])
    r = _rescore_budget(plan)
    bound_step = _cached(("int8-bound-step", r, plan.backend),
                         lambda: make_int8_bound_step(r, plan.backend))
    trigger = ctx.spec_trigger
    if trigger is None:
        trigger = plan.spec_trigger if plan.spec_trigger >= 0.0 else DEFAULT_SPEC_TRIGGER
    trigger = float(trigger)

    lb = torch.full((m, r + 1), torch.inf, dtype=torch.float32, device=queries.device)
    li = torch.full((m, r + 1), -1, dtype=torch.int32, device=queries.device)
    stream = DoubleBufferedStream(_resilient_source(store, "int8", ctx),
                                  depth=ctx.prefetch_depth, put_retries=ctx.max_retries,
                                  retry_backoff_s=ctx.retry_backoff_s,
                                  health=_ctx_health(ctx), device=queries.device)
    n_shards = int(getattr(store, "n_shards", 0) or 0)
    trigger_after = None
    if trigger < 1.0 and n_shards > 1:
        # first shard count at which speculation may launch; it must stay
        # below n_shards (after the last shard it is the serial schedule)
        trigger_after = max(1, math.ceil(trigger * n_shards))
    spec = None
    shards_done = 0
    scan_bytes = 0
    direct_r1 = None
    for p in stream:
        if isinstance(p, part.PaddedDataset):
            # a quarantined int8 shard degraded to its f32 rows: exact
            # distances are valid lower bounds of themselves, so merging
            # them through the direct-form step keeps the certificate sound
            # and the result bit-identical to the f32 oracle
            if direct_r1 is None:
                direct_r1 = cached_direct_step(r + 1)
            lb, li = direct_r1(lb, li, queries, p.vectors, p.norms, p.base_index)
            scan_bytes += int(p.vectors.shape[0]) * int(p.vectors.shape[1]) * 4
        else:
            lb, li = bound_step(lb, li, queries, p.q, p.scales, p.err, p.qnorm, p.base_index)
            scan_bytes += p.scan_bytes()
        shards_done += 1
        if spec is None and trigger_after is not None and trigger_after <= shards_done < n_shards:
            spec = SpeculativeGather(li[:, :r], store)
    ctx.stream_stats = {"transfers": stream.transfers, "restarts": stream.restarts}
    return _rescore_certify(plan, queries, store, ctx, lb, li, scan_bytes, spec=spec,
                            t_start=t_start, trigger=trigger)


@register_executor("fqsd-int8-streamed")
def _fqsd_int8_streamed(plan, queries, store, ctx) -> TopK:
    """Streamed quantised FQ-SD over host-RAM shards: 1 B/element scan,
    global widened candidate queue, exact rescore of candidate rows only
    (see :func:`_int8_streamed`)."""
    return _int8_streamed(plan, queries, store, ctx)


@register_executor("fqsd-int8-mmap-streamed")
def _fqsd_int8_mmap_streamed(plan, queries, store, ctx) -> TopK:
    """Streamed quantised FQ-SD over the mapped shards of a store in files:
    the same body as fqsd-int8-streamed (see :func:`_int8_streamed`); the
    candidate gather reads its rows through the store's ``gather_rows``."""
    return _int8_streamed(plan, queries, store, ctx)


# ---------------------------------------------------------- mesh executors
def _mesh(ctx: ExecContext):
    if ctx.mesh is None:
        raise ValueError("plan requires a mesh but ExecContext.mesh is None")
    return ctx.mesh, tuple(ctx.mesh_axes)


@register_executor("fdsq-sharded")
def _fdsq_sharded(plan, queries, dataset: part.PaddedDataset, ctx) -> TopK:
    """Mesh-distributed FD-SQ: replicated query, row-sharded dataset,
    hierarchical exact merge (``sharded.fdsq_sharded``, its schedule stated
    there); a resident engine's delta shards merge into the final queue on
    the mesh's first device."""
    mesh, axes = _mesh(ctx)
    key = (plan.cache_key(), plan.backend, mesh, axes)
    fn = _cached(key, lambda: sh.fdsq_sharded(mesh, plan.k, plan.metric, axes,
                                              backend=plan.backend))
    out = fn(queries, dataset.vectors, dataset.norms, shards=ctx.delta)
    ctx.delta_folded = bool(ctx.delta)
    return out


@register_executor("fqsd-sharded")
def _fqsd_sharded(plan, queries, dataset: part.PaddedDataset, ctx) -> TopK:
    """Mesh-distributed FQ-SD through the ring with copies overlapped
    (``sharded.fqsd_ring``, its schedule stated there): queries over the
    first mesh axis, the dataset over the engine's mesh axes jointly. A
    one-axis mesh (the Router's ``("data",)``) is a ring with no model axis;
    the reference's ring reads a "model" axis there and raises. A batch
    that does not split over the ring's positions is padded with zero rows,
    whose answers are dropped."""
    mesh, axes = _mesh(ctx)
    if len(axes) > 2:
        raise ValueError(f"the ring shards over (query, model) axes, got {axes}")
    key = (plan.cache_key(), plan.backend, mesh, axes)
    fn = _cached(key, lambda: sh.fqsd_ring(mesh, plan.k, plan.metric, axes[0],
                                           axes[1] if len(axes) > 1 else None,
                                           backend=plan.backend))
    m = int(queries.shape[0])
    pad = -m % mesh.shape[axes[0]]
    if pad:
        queries = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
    out = fn(queries, dataset.vectors, dataset.norms, shards=ctx.delta)
    ctx.delta_folded = bool(ctx.delta)
    return TopK(out.scores[:m], out.indices[:m]) if pad else out


@register_executor("fdsq-sharded-int8")
def _fdsq_sharded_int8(plan, queries, dataset: MeshTiered, ctx) -> TopK:
    """Mesh-resident certified int8: the quantised channels live row-sharded
    over the mesh, every device bounds its rows only (1 B/element local
    traffic) into a widened (m, r+1) queue, the queues merge hierarchically
    (``sharded.fdsq_sharded_int8``), and the shared epilogue
    (:func:`_rescore_certify`) gathers and rescores only candidate f32 rows
    from the backing store: certified or recomputed, bit-identical to the
    streamed f32 oracle either way. Per-device scan bytes land on
    ctx.device_bytes."""
    mesh, axes = _mesh(ctx)
    t_start = time.perf_counter()
    r = _rescore_budget(plan)
    key = (plan.cache_key(), plan.backend, mesh, axes)
    fn = _cached(key, lambda: sh.fdsq_sharded_int8(mesh, r, axes, backend=plan.backend))
    q8 = dataset.quant
    # validity (padding, tombstones, a filter mask) rides the exact-norms
    # channel; fold it into qnorm so the scan reads a single channel
    qnorm = sh.map_blocks(lambda nsq, qn: torch.where(torch.isfinite(nsq), qn, torch.inf),
                          q8.norms_sq, q8.qnorm_sq)
    state = fn(queries, q8.q, q8.scales, q8.err, qnorm)
    rows, d = q8.q.rows, int(q8.q.shape[1])
    per_dev = rows * d + 12 * rows
    ctx.device_bytes = [per_dev] * q8.q.n_blocks
    return _rescore_certify(plan, queries, dataset.store, ctx, state.scores, state.indices,
                            per_dev * q8.q.n_blocks, t_start=t_start)


def _int8_mesh_streamed(plan, queries, store, ctx) -> TopK:
    """Shared body of the ring-streamed mesh int8 executors (host-RAM and
    mapped shard sources run the same schedule).

    The paper's FQ-SD stream fanned out over the mesh's P positions: shard
    i of the store's int8 source is put on position i mod P
    (:func:`~repro_torch.core.streaming.make_ring_put`) and merged into that
    position's widened (m, r+1) bound queue by the single-device streamed
    step (the same cached step: ``knn_int8_scan`` + ``knn_merge`` on
    ``cuda``). The stream prefetches at least one shard a position. The P
    queues then merge once on the first device (one ``knn_merge`` on
    ``cuda``, a lexicographic sort otherwise: every position's top r+1
    holds its rows' share of the global top r+1), and the shared epilogue
    rescores candidate f32 rows as on the single-device path. A store
    larger than every device's memory together serves: at most the
    stream's depth of shards is in flight.

    Per-device scan bytes land on ``ctx.device_bytes``; speculation stays
    off on mesh paths."""
    mesh, _ = _mesh(ctx)
    t_start = time.perf_counter()
    m = int(queries.shape[0])
    r = _rescore_budget(plan)
    # the single-device streamed step's key: a mesh adds no cache entry
    bound_step = _cached(("int8-bound-step", r, plan.backend),
                         lambda: make_int8_bound_step(r, plan.backend))
    devices = list(mesh.devices.flat)
    n_dev = len(devices)
    qs = [queries.to(d) for d in devices]
    lbs = [torch.full((m, r + 1), torch.inf, dtype=torch.float32, device=d) for d in devices]
    lis = [torch.full((m, r + 1), -1, dtype=torch.int32, device=d) for d in devices]
    stream = DoubleBufferedStream(_resilient_source(store, "int8", ctx),
                                  depth=max(ctx.prefetch_depth, n_dev),
                                  put_fn=make_ring_put(devices), put_retries=ctx.max_retries,
                                  retry_backoff_s=ctx.retry_backoff_s,
                                  health=_ctx_health(ctx), device=mesh.first)
    dev_bytes = [0] * n_dev
    direct_r1 = None
    for shard_i, p in enumerate(stream):
        d = shard_i % n_dev  # consumption order is the ring's put order
        if isinstance(p, part.PaddedDataset):
            # a quarantined shard's f32 rows (the source yields them before
            # the ring put, so put and consume order stay in step): exact
            # distances merge as their own lower bounds (see _int8_streamed)
            if direct_r1 is None:
                direct_r1 = cached_direct_step(r + 1)
            lbs[d], lis[d] = direct_r1(lbs[d], lis[d], qs[d], p.vectors, p.norms,
                                       p.base_index)
            dev_bytes[d] += int(p.vectors.shape[0]) * int(p.vectors.shape[1]) * 4
        else:
            lbs[d], lis[d] = bound_step(lbs[d], lis[d], qs[d], p.q, p.scales, p.err,
                                        p.qnorm, p.base_index)
            dev_bytes[d] += p.scan_bytes()
    ctx.stream_stats = {"transfers": stream.transfers, "restarts": stream.restarts}
    ctx.device_bytes = dev_bytes
    state = sh.merge_queues([TopK(s, i) for s, i in zip(lbs, lis)], mesh.first, plan.backend)
    return _rescore_certify(plan, queries, store, ctx, state.scores, state.indices,
                            sum(dev_bytes), t_start=t_start)


@register_executor("fqsd-sharded-int8")
def _fqsd_sharded_int8(plan, queries, store, ctx) -> TopK:
    """Ring-streamed mesh int8 over host-RAM shards: shard i scans on
    position i mod P, per-position widened queues, one global merge,
    candidate-only f32 rescore (see :func:`_int8_mesh_streamed`)."""
    return _int8_mesh_streamed(plan, queries, store, ctx)


@register_executor("fqsd-sharded-int8-streamed")
def _fqsd_sharded_int8_streamed(plan, queries, store, ctx) -> TopK:
    """Ring-streamed mesh int8 over a store in files: the codes leave the
    mapping inside each ring put at 1 B/element, so one store can exceed
    the memory of every device together (see :func:`_int8_mesh_streamed`)."""
    return _int8_mesh_streamed(plan, queries, store, ctx)
