"""Typed request/response model — the public face of the search engine.

The paper's central idea is that one physical configuration ("bitstream")
serves two deployment plans selected per workload. The API analogue: every
option that used to be frozen at engine construction (k, metric) or
scattered across entry points (``query`` vs ``query_batch`` vs
``query_batch_int8``) and scheduler knobs (tier, deadline) is a *per-request
fact* carried by one frozen :class:`SearchRequest`. The engine normalizes
the request, the planner turns it into an :class:`ExecutionPlan`, and the
answer comes back as one :class:`SearchResult` carrying the top-k, the
exactness certificate, and the plan/kernel stats that served it.

This module is deliberately dependency-free (stdlib + numpy only): it is
imported by ``repro_torch.core.engine`` and by ``repro_torch.api`` without
creating an import cycle. Field types referencing core objects (TopK,
ExecutionPlan) are annotations only. ``queries`` may be a numpy array, a
nested list or a torch tensor on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, Mapping

import numpy as np

Tier = Literal["auto", "f32", "int8"]
ModeHint = Literal["auto", "fdsq", "fqsd"]

#: mode_hint="auto": batches at most this deep take the FD-SQ latency plan,
#: deeper ones the FQ-SD throughput plan (matches the scheduler's default
#: fdsq_max_batch, so direct calls and served calls agree).
AUTO_FDSQ_MAX_BATCH = 4


@dataclasses.dataclass(frozen=True, eq=False)
class SearchRequest:
    """One search call, fully described: queries + every per-request option.

    queries      (d,) or (m, d) array — the only required field.
    k            neighbors per query; None = the engine's configured k.
    metric       "l2" | "ip" | "cos"; None = the engine's configured metric.
    tier         storage tier the scan reads: "f32" (exact base tier),
                 "int8" (1 B/element certified-rescore tier; requires
                 ``enable_int8()`` and the l2 metric), or "auto" — the
                 engine serves f32 and the serving layer's bandwidth-aware
                 policy (``AdaptiveScheduler.choose_tier``) may upgrade
                 deep backlogs to int8.
    mode_hint    logical configuration: "fdsq" (latency), "fqsd"
                 (throughput), or "auto" (micro-batches of at most
                 ``AUTO_FDSQ_MAX_BATCH`` rows go FD-SQ, deeper ones FQ-SD).
                 Non-resident stores stream regardless of the hint.
    deadline_ms  latency budget. The engine threads it into
                 ``SearchResult.stats``; the scheduler uses it for urgency
                 routing and deadline-miss accounting.
    filter_mask  optional per-request validity filter: boolean array over
                 the engine's global row-id space (True = row eligible).
                 Folded onto the executors' existing +inf-norm masking
                 path, so filtering is runtime data — same shapes, no
                 recompilation.
    prefetch_depth
                 streamed-scan double-buffer depth for this request;
                 None = the plan's tuned value, else the engine's default.
                 Must be >= 1 (validated here, not deep in the stream).
    spec_trigger streamed-int8 speculation trigger: the shard fraction
                 after which the candidate gather starts on a background
                 thread. Must be in [0, 1]; 1.0 disables speculation;
                 None = the plan's tuned value, else the executor default.
                 Results are bit-identical at every setting — the trigger
                 only reschedules reads.
    allow_partial
                 False (default): an unrecoverable shard failure raises —
                 never a silently wrong top-k. True: the scan skips dead
                 shards after retries + quarantine are exhausted and
                 returns a result flagged ``stats["partial"]`` with the
                 missing shards in ``stats["health"]["failed_shards"]``.
    max_retries  bounded retry budget (exponential backoff) for streamed
                 shard reads / candidate gathers / device transfers on
                 this request; None = the engine's configured budget.
                 0 disables retry. Retries are counted in
                 ``stats["health"]["retries"]``.
    rid          caller's request id (serving envelope; echoed on results).
    arrival_s    simulated arrival stamp for the discrete-event scheduler.
    """

    queries: Any
    k: int | None = None
    metric: str | None = None
    tier: Tier = "auto"
    mode_hint: ModeHint = "auto"
    deadline_ms: float | None = None
    filter_mask: Any | None = None
    prefetch_depth: int | None = None
    spec_trigger: float | None = None
    allow_partial: bool = False
    max_retries: int | None = None
    rid: int | None = None
    arrival_s: float = 0.0

    def __post_init__(self):
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.tier not in ("auto", "f32", "int8"):
            raise ValueError(
                f"tier must be 'auto', 'f32' or 'int8', got {self.tier!r}"
            )
        if self.mode_hint not in ("auto", "fdsq", "fqsd"):
            raise ValueError(
                "mode_hint must be 'auto', 'fdsq' or 'fqsd', "
                f"got {self.mode_hint!r}"
            )
        if self.prefetch_depth is not None and self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}"
            )
        if self.spec_trigger is not None and not (
                0.0 <= self.spec_trigger <= 1.0):
            raise ValueError(
                "spec_trigger must be a shard fraction in [0, 1] "
                f"(1 disables speculation), got {self.spec_trigger}"
            )
        if self.max_retries is not None and self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )

    @property
    def vector(self):
        """Back-compat alias for single-vector serving requests (the old
        ``serving.Request.vector`` field)."""
        return self.queries

    def n_queries(self) -> int:
        q = self.queries
        if not hasattr(q, "shape"):
            q = np.asarray(q)
        return 1 if q.ndim == 1 else int(q.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class SearchResult:
    """One answered request: TopK + certificate + plan/kernel stats.

    topk          the engine's TopK (scores + global indices). (m, k)-shaped
                  for direct ``ExactKNN.search`` calls; 1-D per-request
                  slices when yielded by the serving layer.
    plan          the ExecutionPlan that served it (mode, executor, tier,
                  chunking, tuned blocks — pure data, usable as cache key).
    tier          storage tier the scan actually read ("f32" | "int8").
    certified     per-query exactness certificate of the int8 tier (bool
                  array / bool). Exact paths are trivially True — results
                  are exact on every path; on the int8 tier uncertified
                  rows were recomputed in f32 by the executor.
    kernel_stats  fused-kernel observability (pruning skip rate, resolved
                  tile shapes); None for non-Pallas executors.
    stats         per-request accounting: bytes_scanned, dispatch_ms,
                  batched, deadline_ms/latency_ms (serving), k, metric;
                  streamed int8 adds the wall-time split (scan_ms /
                  gather_ms / rescore_ms) and a "speculation" block
                  (trigger, rows_speculated, rows_topped_up, rows_wasted —
                  wasted fetches are charged to bytes_scanned; failed = 1
                  when the background gather died and the executor degraded
                  to a synchronous gather). Every engine-served result also
                  carries a "health" block — retries, failed_shards,
                  degraded (int8 shards quarantined to their f32 rows —
                  still exact), slow_shards, shed — and a "partial" flag
                  (True only under ``allow_partial`` with dead shards).
    rid           echo of the request id (serving envelope).
    """

    topk: Any
    plan: Any
    tier: str = "f32"
    certified: Any = True
    kernel_stats: Mapping[str, Any] | None = None
    stats: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    rid: int | None = None

    # ------------------------------------------------ convenience accessors
    @property
    def scores(self):
        return self.topk.scores

    @property
    def indices(self):
        return self.topk.indices

    @property
    def mode(self) -> str:
        """Logical configuration label ("fdsq" | "fqsd" | "fqsd-int8" |
        "fqsd-streamed" | ...). The serving layer stamps its dispatch label
        into ``stats`` (an FD-SQ dispatch against a non-resident store still
        *plans* a streamed scan); direct calls read the plan's label."""
        return self.stats.get("mode", self.plan.mode)

    @property
    def executor(self) -> str:
        return self.plan.executor

    @property
    def exact(self) -> bool:
        """Every row of this result certified exact (always True on f32
        paths; int8 uncertified rows were recomputed exactly anyway)."""
        return bool(np.all(np.asarray(self.certified)))

    @property
    def partial(self) -> bool:
        """True iff shards are missing from this result (only possible
        under ``SearchRequest.allow_partial=True``; default-strict
        requests raise instead of going partial)."""
        return bool(self.stats.get("partial", False))

    @property
    def health(self) -> Mapping[str, Any]:
        """The result's resilience accounting (retries, failed_shards,
        degraded, slow_shards, shed); empty for shims that bypass the
        engine's stats assembly."""
        return self.stats.get("health", {})

    @property
    def latency_ms(self) -> float | None:
        return self.stats.get("latency_ms")

    @property
    def batched(self) -> int:
        return int(self.stats.get("batched", self.topk.scores.shape[0]
                                  if np.ndim(self.topk.scores) > 1 else 1))


__all__ = ["SearchRequest", "SearchResult", "AUTO_FDSQ_MAX_BATCH"]
