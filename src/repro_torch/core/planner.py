"""Query planning — the pure "decide the plan" layer of the engine.

FD-SQ (latency) and FQ-SD (throughput) are two *logical* configurations of
one physical configuration; choosing between them is a scheduling
decision. This module is that decision, as a pure function:

    plan(query_shape, dataset_meta, engine_cfg, mode) -> ExecutionPlan

An :class:`ExecutionPlan` is frozen, hashable data naming the executor
(``repro_torch.core.executors``), the chunking and the padding geometry.
Executors key their cached callables on plans, so planning the same
shapes twice hits the same cache entry however many mode switches
happened in between.

Names, against the JAX package this port mirrors:

    backend "torch"  <->  "xla"     plain tensor ops
    backend "cuda"   <->  "pallas"  the hand-written fused kernel
    executor "fdsq-torch"  <->  "fdsq-xla"
    executor "fqsd-torch"  <->  "fqsd-xla"
    executor "fdsq-cuda"   <->  "fdsq-pallas"
    executor "fqsd-int8-torch"  <->  "fqsd-int8"
    executor "fqsd-int8-cuda"   <->  "fqsd-int8-pallas"

The streamed executors keep the reference's names ("fqsd-streamed",
"fqsd-mmap-streamed", "fqsd-int8-streamed", "fqsd-int8-mmap-streamed");
their per-shard steps run on the plan's backend. This port plans resident
and streamed single-device search over the f32 tier and the certified int8
tier. Sharded plans raise ``NotImplementedError`` naming the slice of the
port that brings them.

The one external fact a plan may carry is per-device tuning
(``repro_torch.tuning``, a pure read of a JSON cache): the autotuned blocks
of the fused executors ("fdsq-cuda", "fqsd-int8-cuda") and the pipeline
knobs of the streamed int8 executors. A cold cache leaves blocks at 0 (the
kernel's ``DEFAULT_BLOCKS``) and knobs unset (0 / -1.0); tuned values ride
``cache_key()``, so a tuned plan hits the same executable forever after.
A persisted negative CUDA capability verdict makes every ``backend="cuda"``
plan raise: no verdict ever swaps the kernels for a plain path (the
reference falls back to its XLA scan instead).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

from repro_torch.tuning.autotune import (
    default_cache,
    lookup_blocks,
    lookup_cuda_capability,
    lookup_pipeline,
)

Backend = Literal["torch", "cuda"]
ModeHint = Literal["fdsq", "fqsd", "fqsd-streamed"]

#: Executors the planner may select (must match the executor registry).
PLANNABLE_EXECUTORS = ("fdsq-torch", "fqsd-torch", "fdsq-cuda", "fqsd-streamed",
                       "fqsd-mmap-streamed", "fqsd-int8-torch", "fqsd-int8-cuda",
                       "fqsd-int8-streamed", "fqsd-int8-mmap-streamed")

#: Executors whose block shapes the per-device autotuner may override.
TUNABLE_EXECUTORS = ("fdsq-cuda", "fqsd-int8-cuda")

#: Streamed executors whose pipeline knobs (prefetch depth, speculation
#: trigger, rescore budget) the end-to-end autotuner may override.
PIPELINE_TUNABLE_EXECUTORS = ("fqsd-int8-streamed", "fqsd-int8-mmap-streamed")

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """Resolved logical configuration — logged for observability / tests."""

    mode: str  # "fdsq" | "fqsd"
    backend: str
    m: int
    k: int
    metric: str
    chunk_rows: int
    n_partitions: int


@dataclasses.dataclass(frozen=True)
class ExecutionPlan(EnginePlan):
    """EnginePlan + the physical decisions: executor, chunking, padding and
    the storage tier the scan reads."""

    executor: str = "fdsq-torch"
    padded_rows: int = 0
    padded_dim: int = 0
    n_valid: int = 0
    sharded: bool = False
    tier: str = "f32"
    rescore_factor: int = 4
    n_shards: int = 1
    #: kernel tile shapes; 0 means the kernel defaults (DEFAULT_BLOCKS)
    block_m: int = 0
    block_n: int = 0
    block_d: int = 0
    #: streamed-pipeline knobs; unset (0 / -1.0) for resident plans
    prefetch_depth: int = 0
    spec_trigger: float = -1.0

    def cache_key(self) -> tuple:
        """Everything that determines the cached callable for this plan
        (query batch m and padding geometry included; log-only fields not)."""
        return (
            self.executor, self.m, self.k, self.metric, self.chunk_rows,
            self.n_partitions, self.padded_rows, self.padded_dim,
            self.tier, self.rescore_factor,
            self.block_m, self.block_n, self.block_d,
            self.prefetch_depth, self.spec_trigger,
        )


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    """Shape facts about the (padded) dataset a plan will run against."""

    padded_rows: int
    padded_dim: int
    n_valid: int
    sharded: bool = False
    resident: bool = True


@dataclasses.dataclass(frozen=True)
class DatasetStoreMeta(DatasetMeta):
    """DatasetMeta + what a DatasetStore knows: tier, shard layout and
    whether shards are files (pure data; the store never reaches the
    planner)."""

    tier: str = "f32"
    n_shards: int = 1
    rows_per_shard: int = 0
    mmap: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The engine's constructor knobs as pure data (planner input)."""

    k: int
    metric: str = "l2"
    backend: str = "torch"
    chunk_rows: int = 8192
    n_partitions: int = 8
    sharded: bool = False
    mesh_axes: Sequence[str] = ("data", "model")
    rescore_factor: int = 4
    dtype: str = "float32"
    #: the caller set rescore_factor: a tuned pipeline budget never replaces it
    rescore_pinned: bool = False


def largest_divisor_at_most(n: int, cap: int) -> int:
    """Largest divisor of `n` that is <= `cap` (>= 1 for any n >= 1);
    an O(sqrt n) divisor walk."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    cap = min(cap, n)
    if cap < 1:
        return 1
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= cap:
                best = max(best, d)
            co = n // d
            if co <= cap:
                best = max(best, co)
        d += 1
    return best


def plan(
    query_shape: Sequence[int],
    dataset_meta: DatasetMeta,
    engine_cfg: EngineConfig,
    mode: ModeHint = "fdsq",
    stream_rows: int | None = None,
    k: int | None = None,
    metric: str | None = None,
    **unknown,
) -> ExecutionPlan:
    """Pure planning function: shapes + config in, ExecutionPlan out.

    ``k`` and ``metric`` are per-request overrides of the engine config;
    they ride ``ExecutionPlan.cache_key()``. Unknown keyword arguments are
    rejected loudly.

    * non-resident dataset -> the streamed executors: "fqsd-mmap-streamed"
      when the meta is a DatasetStoreMeta (store shards, host RAM or mmap
      files), "fqsd-streamed" over a bare iterable of partitions otherwise.
      A store-backed non-resident plan with tier="int8" (l2 only) keeps the
      quantised tier: "fqsd-int8-mmap-streamed" for mmap shards,
      "fqsd-int8-streamed" for host-RAM shards. chunk_rows is the shard
      (``stream_rows``, else the store's rows per shard);
    * tier="int8", mode="fqsd", l2 -> "fqsd-int8-cuda" (backend "cuda",
      the int8 scan kernel) or "fqsd-int8-torch"; chunk_rows, a divisor of
      the padded rows, is the geometry of the exact fallback scan;
    * backend="cuda"  -> "fdsq-cuda", the fused kernel, for both logical
      modes and all three metrics (cos through pre-normalised rows);
    * mode="fqsd"     -> "fqsd-torch", a chunked scan whose chunk size is
      a real divisor of the padded row count;
    * mode="fdsq"     -> "fdsq-torch", a partition fan-out whose partition
      count divides the padded rows.
    """
    if unknown:
        raise TypeError(
            "plan() got unexpected keyword argument(s): "
            + ", ".join(repr(key) for key in sorted(unknown))
        )
    if mode not in ("fdsq", "fqsd", "fqsd-streamed"):
        raise ValueError(f"unknown mode hint {mode!r}")
    if len(query_shape) == 2:
        m = int(query_shape[0])
    elif len(query_shape) == 1:
        m = 1
    else:
        raise ValueError(f"query_shape must be (m, d) or (d,), got {query_shape}")

    cfg = engine_cfg
    if cfg.backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {cfg.backend!r}")
    k = int(cfg.k) if k is None else int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    metric = cfg.metric if metric is None else metric
    rows = int(dataset_meta.padded_rows)
    chunk = int(cfg.chunk_rows)
    n_parts = int(cfg.n_partitions)
    store_backed = isinstance(dataset_meta, DatasetStoreMeta)
    tier = dataset_meta.tier if store_backed else "f32"

    if cfg.sharded or dataset_meta.sharded:
        raise NotImplementedError("sharded (mesh) search is ported in the mesh slice")
    if mode == "fqsd-streamed" or not dataset_meta.resident:
        if store_backed and tier == "int8" and metric == "l2":
            # the paper's throughput deployment: out-of-core scan at
            # 1 B/element with certified rescore reads of candidate rows
            executor = ("fqsd-int8-mmap-streamed" if dataset_meta.mmap
                        else "fqsd-int8-streamed")
            mode = "fqsd-int8-streamed"
        else:
            executor = "fqsd-mmap-streamed" if store_backed else "fqsd-streamed"
            mode = "fqsd-streamed"
            tier = "f32"  # exact base tier (int8 needs a store + l2)
        if stream_rows is not None:
            chunk = int(stream_rows)
        elif store_backed and dataset_meta.rows_per_shard:
            chunk = int(dataset_meta.rows_per_shard)
    # the int8 tier serves l2 FQ-SD only; every other resident plan reads f32
    elif tier == "int8" and mode == "fqsd" and metric == "l2":
        executor = "fqsd-int8-cuda" if cfg.backend == "cuda" else "fqsd-int8-torch"
        mode = "fqsd-int8"
        # chunking doubles as the f32 fallback geometry for uncertified rows
        chunk = largest_divisor_at_most(rows, max(1, chunk))
    elif cfg.backend == "cuda":
        executor, tier = "fdsq-cuda", "f32"
    elif mode == "fdsq":
        executor, tier = "fdsq-torch", "f32"
        n_parts = largest_divisor_at_most(rows, max(1, n_parts))
    else:
        executor, tier = "fqsd-torch", "f32"
        chunk = largest_divisor_at_most(rows, max(1, chunk))

    if cfg.backend == "cuda" and lookup_cuda_capability() is False:
        raise RuntimeError(
            f"plan(): {executor} needs the card's kernels, and the CUDA capability verdict "
            f"persisted in {default_cache().path or 'the in-memory autotune cache'} is "
            "false (probe_cuda_capability() failed on this device); nothing falls back "
            "to plain ops: repair the build and probe again")

    # tuned end-to-end pipeline knobs for the streamed int8 executors (a
    # pure cache read); a budget the caller pinned is never replaced
    rescore_factor = int(cfg.rescore_factor)
    prefetch_depth = 0
    spec_trigger = -1.0
    if executor in PIPELINE_TUNABLE_EXECUTORS:
        knobs = lookup_pipeline(executor, m, rows, int(dataset_meta.padded_dim),
                                cfg.dtype, metric, k)
        if knobs is not None:
            prefetch_depth = int(knobs.prefetch_depth)
            spec_trigger = float(knobs.spec_trigger)
            if not cfg.rescore_pinned:
                rescore_factor = int(knobs.rescore_factor)

    # per-device autotuned tile shapes of the fused kernels (0 = kernel
    # defaults); the int8 queue width depends on the rescore budget too, so
    # its blocks are keyed per rescore_factor
    block_m = block_n = block_d = 0
    if executor in TUNABLE_EXECUTORS:
        tuned = lookup_blocks(executor, m, rows, int(dataset_meta.padded_dim), cfg.dtype,
                              metric, k,
                              int(cfg.rescore_factor) if executor == "fqsd-int8-cuda"
                              else None)
        if tuned is not None:
            block_m, block_n, block_d = tuned

    return ExecutionPlan(
        mode=mode,
        backend=cfg.backend,
        m=m,
        k=k,
        metric=metric,
        chunk_rows=chunk,
        n_partitions=n_parts,
        executor=executor,
        padded_rows=rows,
        padded_dim=int(dataset_meta.padded_dim),
        n_valid=int(dataset_meta.n_valid),
        sharded=False,
        tier=tier,
        rescore_factor=rescore_factor,
        n_shards=int(getattr(dataset_meta, "n_shards", 1)),
        block_m=block_m,
        block_n=block_n,
        block_d=block_d,
        prefetch_depth=prefetch_depth,
        spec_trigger=spec_trigger,
    )
