"""Executor registry — the uniform "run the plan" layer of the engine.

Each executor is a callable ``execute(plan, queries, dataset, ctx) -> TopK``
registered under the name the planner selects
(``repro_torch.core.planner``). Executors wrap the entry points of
``fdsq.py`` / ``fqsd.py`` / ``quantized.py`` / ``kernels.knn`` and add no
numerics of their own.

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
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from repro_torch.core import partition as part
from repro_torch.core.fdsq import fdsq_search
from repro_torch.core.fqsd import fqsd_scan
from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.quantized import QuantizedDataset, knn_quantized
from repro_torch.core.topk import TopK


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
