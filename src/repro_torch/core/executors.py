"""Executor registry — the uniform "run the plan" layer of the engine.

Each executor is a callable ``execute(plan, queries, dataset, ctx) -> TopK``
registered under the name the planner selects
(``repro_torch.core.planner``). Executors wrap the entry points of
``fdsq.py`` / ``fqsd.py`` / ``quantized.py`` / ``kernels.knn`` and add no
numerics of their own. The streamed executors read host shards through the
double buffer (``streaming.py``); their per-shard steps run on the plan's
backend: the kernels on ``cuda``, plain ops on ``torch``.

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
    device_put_partition,
)
from repro_torch.core.topk import TopK, sort_pairs

#: Default speculation trigger for the streamed int8 executors: start the
#: background candidate gather once this fraction of shards has merged.
#: 1.0 disables speculation (gather strictly after the scan).
DEFAULT_SPEC_TRIGGER = 0.5


@dataclasses.dataclass
class ExecContext:
    """Runtime state a plan cannot carry (plans are pure data). Executors
    may write run observability back here (the int8 certificate)."""

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
    #: set by executors that merge the store's delta shards themselves (the
    #: int8 rescore tail does), so the engine never scores them twice
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
    entry serves every shard shape."""
    return _cached(("partition-step", k, metric, backend),
                   lambda: PartitionStep(k, metric, backend))


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
    modes. The pruning skip rate and the resolved tile shapes land on
    ctx.kernel_stats."""
    from repro_torch.kernels.knn import ops as knn_ops

    bm, bn, bd = _plan_blocks(plan)
    pre = bool(ctx.cos_prenormalized) and plan.metric == "cos"
    key = (plan.cache_key(), _arr_key(queries), _arr_key(dataset.vectors), pre)
    fn = _cached(key, lambda: functools.partial(
        knn_ops.knn, k=plan.k, metric=plan.metric, block_m=bm, block_n=bn,
        block_d=bd, return_stats=True, x_prenormalized=pre))
    out, skip_rate = fn(queries, dataset.vectors, x_norms=dataset.norms)
    ctx.kernel_stats = {
        "prune_skip_rate": skip_rate,
        "blocks": knn_ops.resolved_blocks(plan.k, plan.padded_dim, bm, bn, bd,
                                          m=plan.m),
    }
    return out


def _exact_uncertified(plan, queries, dataset: TieredResident, out: TopK,
                       cert: torch.Tensor) -> TopK:
    """Recompute the rows the certificate cannot cover with the direct-form
    exact scan over the f32 tier (the same bits the rescore gives a pair),
    so every returned row is exact. Only those query rows are rescanned:
    each row's answer is independent of the others."""
    from repro_torch.kernels.knn.ops import knn_exact_direct

    bad = ~cert
    if not bool(bad.any()):
        return out
    f32 = dataset.f32
    key = ("int8-fallback", plan.cache_key(), _arr_key(f32.vectors))
    fn = _cached(key, lambda: functools.partial(knn_exact_direct, k=plan.k,
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
    q8 = dataset.quant
    key = (plan.cache_key(), _arr_key(queries), _arr_key(q8.q))
    fn = _cached(key, lambda: functools.partial(
        knn_quantized, k=plan.k, rescore_factor=plan.rescore_factor))
    out, cert = fn(queries, q8, dataset.f32.vectors)
    ctx.certificate = cert
    return _exact_uncertified(plan, queries, dataset, out, cert)


@register_executor("fqsd-int8-cuda")
def _fqsd_int8_cuda(plan, queries, dataset: TieredResident, ctx) -> TopK:
    """Fused quantised FQ-SD: the int8 scan kernel reads the codes at
    1 B/element and keeps the widened candidate queue on chip; the exact
    rescore reads only the candidate rows of the f32 tier. The certificate
    lands on ctx.certificate (uncertified rows are recomputed exactly), the
    skip rate and tile shapes on ctx.kernel_stats."""
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
    return _exact_uncertified(plan, queries, dataset, out, cert)


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
    direct_step = _cached(("direct-step", plan.k), lambda: make_direct_partition_step(plan.k))
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
    # through the direct-form step the oracle uses (order-invariant)
    for p in store.delta_shards():
        dp = _with_retries(lambda: device_put_partition(p, dev), ctx)
        s, i = direct_step(s, i, queries, dp.vectors, dp.norms, p.base_index)
        scan_bytes += int(p.vectors.shape[0]) * int(p.vectors.shape[1]) * 4
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
                direct_r1 = _cached(("direct-step", r + 1),
                                    lambda: make_direct_partition_step(r + 1))
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
