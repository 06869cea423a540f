"""Online kNN retrieval service — one adaptive FD-SQ / FQ-SD scheduler.

The paper's RQ3 trade-off (FD-SQ keeps per-query latency flat, FQ-SD
maximizes queries/s) used to be a constructor argument of the engine; here
it is a *runtime policy*. :class:`AdaptiveScheduler` watches queue depth
and per-request deadline budget and routes every batch through a plan from
the engine's planner:

    small / urgent batches  -> FD-SQ plan (partition fan-out, low latency)
    deep backlogs           -> FQ-SD plan (streaming queue scan, throughput)
    deepest backlogs        -> FQ-SD over the int8 storage tier (1 B/elem
                               scan, 4x less memory traffic, certified
                               exact rescore) when the engine has one

The scheduler speaks the request-first API (``repro_torch.api``): it consumes
:class:`SearchRequest` objects and yields per-request
:class:`SearchResult` objects — the same types ``ExactKNN.search`` takes
and returns — so routing policy, tier choice, and deadline budget all read
from one object. Per-request pins are honored: an explicit ``mode_hint``
overrides the policy decision, an explicit ``tier`` overrides the
bandwidth hook, and per-request ``k``/``metric``/``filter_mask`` group
batches by compatibility (a dispatch never mixes options that would plan
differently).

The tier decision is the *bandwidth-aware policy hook* (:meth:`choose_tier`):
the scan is memory-bandwidth-bound, so at sufficient batch depth the
dominant cost is bytes moved per dataset pass, and the int8 tier moves a
quarter of them. Subclasses can override the hook with measured-GB/s
policies; stats() reports tier, certified fraction, and bytes scanned for
every served plan so the trade is visible uniformly.

Because the executor layer caches its callables per plan (see
``repro_torch.core.executors``), flipping between the two logical
configurations per batch adds no cache entry after the first of each — the
paper's "two logical configurations, one physical configuration, no
reflashing".

Requests arrive as a stream (paper fig. 2 arrow 3) carrying simulated
``arrival_s`` stamps; ``serve`` runs a discrete-event loop: admission by
arrival time, one scheduling decision per dispatch, real measured service
times. A real cluster fronts this with an RPC layer, but admission,
scheduling, deadline accounting, and the engine calls are exactly these.

A dispatch's service time ends when its answers are on the host: scores,
indices and the int8 certificate are copied off the card with ``.cpu()``
inside the timed window (a search on the card only enqueues its kernels),
so the EMAs, percentiles and deadlines read the card's real time.
Per-request results hold CPU tensors.

Multi-collection serving goes through ``repro_torch.api.Router``: construct the
scheduler with ``router=`` + ``collection=`` and every dispatch routes
through ``Router.search`` (shared executable cache, per-collection stats).

:class:`RetrievalServer` (the previous FD-SQ-only micro-batching server)
remains as the latency-policy specialization with its historical
window/max-batch semantics. The old ``serving.Request``/``Result`` pair is
deprecated: ``Request(...)`` builds a SearchRequest, ``Result`` *is*
SearchResult.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Iterable, Iterator, Literal

import numpy as np
import torch

from repro_torch.api.types import SearchRequest, SearchResult
from repro_torch.core.engine import ExactKNN
from repro_torch.core.partition import next_pow2
from repro_torch.core.topk import TopK
from repro_torch.faults import FaultError
from repro_torch.runtime import tracing

Policy = Literal["latency", "throughput", "adaptive"]

#: request latencies per dispatch label that ``AdaptiveScheduler.stats()``'s
#: percentiles read (the oldest fall out)
LATENCY_SAMPLES = 4096

#: Deprecated alias — the serving layer produces plain SearchResults.
Result = SearchResult


def Request(rid: int, vector, arrival_s: float = 0.0,
            deadline_ms: float | None = None) -> SearchRequest:
    """Deprecated constructor for the scheduler's old private request type;
    builds the equivalent :class:`repro_torch.api.SearchRequest`."""
    warnings.warn(
        "repro_torch.serving.Request is deprecated; construct "
        "repro_torch.api.SearchRequest(queries=vector, rid=..., arrival_s=..., "
        "deadline_ms=...) directly",
        DeprecationWarning, stacklevel=2,
    )
    return SearchRequest(queries=vector, rid=rid, arrival_s=arrival_s,
                         deadline_ms=deadline_ms)


def bursty_requests(
    vectors,
    burst_size: int = 64,
    trickle: int = 8,
    burst_gap_s: float = 0.25,
    trickle_gap_s: float = 0.02,
    **request_options,
):
    """Deterministic bursty arrival trace over `vectors` (one SearchRequest
    per row): a dense burst (all requests stamped with one arrival time),
    then `trickle` sparse arrivals, repeated — the workload shape the
    adaptive policy exists for. Extra kwargs (k, metric, tier, deadline_ms,
    ...) are stamped onto every request."""
    if burst_size < 1 and trickle < 1:
        raise ValueError("burst_size and trickle cannot both be < 1")
    m = len(vectors)
    t, i = 0.0, 0
    while i < m:
        for _ in range(min(burst_size, m - i)):
            yield SearchRequest(queries=vectors[i], rid=i, arrival_s=t,
                                **request_options)
            i += 1
        t += burst_gap_s
        for _ in range(min(trickle, m - i)):
            yield SearchRequest(queries=vectors[i], rid=i, arrival_s=t,
                                **request_options)
            i += 1
            t += trickle_gap_s
        t += trickle_gap_s


class AdaptiveScheduler:
    """Route batches of SearchRequests through FD-SQ or FQ-SD plans.

    policy:
        "latency"     every dispatch is an FD-SQ plan (micro-batches of at
                      most `fdsq_max_batch`);
        "throughput"  every dispatch is an FQ-SD plan (batches up to
                      `max_batch`);
        "adaptive"    FQ-SD when the backlog is at least `fqsd_min_depth`
                      deep AND no pending request's remaining deadline
                      budget is tighter than the expected FQ-SD service
                      time x `deadline_slack`; FD-SQ otherwise.

    Per-request pins always win: ``mode_hint`` overrides the policy for its
    dispatch, ``tier`` overrides :meth:`choose_tier`.

    Resilience: ``shed_expired`` (default True) answers requests whose
    deadline has already expired at dispatch time with an empty shed
    result (``stats["mode"] == "shed"``) instead of serving them late; a
    per-collection circuit breaker opens after ``breaker_threshold``
    consecutive failed/degraded dispatches, then serves degraded
    (``allow_partial`` stamped onto dispatches) until a probe read of the
    implicated shard succeeds. ``stats()["health"]`` aggregates every
    dispatch's resilience accounting.

    Construct with either ``engine=...`` (single collection) or
    ``router=...`` + ``collection=...`` (multi-collection; dispatches go
    through ``Router.search`` so per-collection stats accumulate).
    """

    #: dispatch labels stats are bucketed by ("fqsd-int8" = the FQ-SD
    #: logical configuration served from the int8 storage tier)
    MODES = ("fdsq", "fqsd", "fqsd-int8")

    def __init__(
        self,
        engine: ExactKNN | None = None,
        policy: Policy = "adaptive",
        fdsq_max_batch: int = 4,
        fqsd_min_depth: int = 32,
        max_batch: int = 256,
        deadline_slack: float = 2.0,
        int8_min_depth: int | None = None,
        router=None,
        collection: str | None = None,
        shed_expired: bool = True,
        breaker_threshold: int = 3,
    ):
        if router is not None:
            if collection is None:
                raise ValueError("router serving requires a collection name")
            engine = router.engine(collection)
        elif engine is None:
            raise ValueError("pass an engine, or router= with collection=")
        if not engine.is_fitted:
            raise ValueError("engine must be fit() before serving")
        if policy not in ("latency", "throughput", "adaptive"):
            raise ValueError(f"unknown policy {policy!r}")
        self.engine = engine
        self.router = router
        self.collection = collection
        self.policy: Policy = policy
        self.fdsq_max_batch = int(fdsq_max_batch)
        self.fqsd_min_depth = int(fqsd_min_depth)
        self.max_batch = int(max_batch)
        self.deadline_slack = float(deadline_slack)
        self.int8_min_depth = None if int8_min_depth is None else int(int8_min_depth)
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}"
            )
        #: deadline-aware load shedding (discrete-event serve only): a
        #: request whose deadline has ALREADY expired at dispatch time is
        #: answered with an empty shed result instead of burning a scan on
        #: an answer nobody can use.
        self.shed_expired = bool(shed_expired)
        self.breaker_threshold = int(breaker_threshold)
        self.served = 0
        self.deadline_misses = 0
        self.shed = 0
        #: live backpressure gauge: what the queue feeding this scheduler
        #: currently holds. The discrete-event loop maintains it itself;
        #: a live front end calls :meth:`note_queue_depth`
        #: on every enqueue/dequeue so admission control and the stats
        #: stream read depth from the same place choose_* does.
        self.queue_depth = 0
        #: per-collection dispatch counter (one per `_execute` call) — with
        #: `shed`, the backpressure counters the serving front end exports
        self.dispatches = 0
        # cross-dispatch resilience accounting (mirrors per-result
        # stats["health"], aggregated) + the per-collection circuit breaker
        self._health_agg = {"retries": 0, "failed_shards": set(),
                            "degraded": set(), "slow_shards": set()}
        self._breaker_failures = 0   # consecutive failed/degraded dispatches
        self._breaker_open = False
        self._breaker_trips = 0
        self._breaker_probes = 0
        self._breaker_shards: set[int] = set()  # shards implicated so far
        #: the last LATENCY_SAMPLES request latencies of each label, for
        #: stats()'s percentiles
        self._lat_ms: dict[str, deque[float]] = {
            m: deque(maxlen=LATENCY_SAMPLES) for m in self.MODES}
        self._svc_s: dict[str, float] = {m: 0.0 for m in self.MODES}
        self._count: dict[str, int] = {m: 0 for m in self.MODES}
        self._ema_s: dict[str, float | None] = {m: None for m in self.MODES}
        self._switches = 0
        self._last_mode: str | None = None
        self._executors: dict[str, set] = {m: set() for m in self.MODES}
        # uniform per-dispatch-label accounting: every served request has a
        # tier, a certificate status, and a bytes-scanned cost — not just
        # the int8 path (tier/certified used to be int8-only)
        self._tiers: dict[str, set] = {m: set() for m in self.MODES}
        self._mode_bytes: dict[str, int] = {m: 0 for m in self.MODES}
        self._cert: dict[str, dict] = {m: {"total": 0, "true": 0}
                                       for m in self.MODES}
        self._bytes_scanned: dict[str, int] = {"f32": 0, "int8": 0}
        # fused-kernel pruning skip rates: running sum + count (O(1) memory
        # for long-lived servers, like the certificate counters)
        self._skip_rate_sum = 0.0
        self._skip_rate_n = 0
        # streamed-plan double-buffer counters (0 while every dispatch is
        # resident): partitions shipped host->device and stream restarts
        self._transfers = 0
        self._restarts = 0
        # streamed-int8 pipeline observability: summed wall-time split and
        # speculation counters across dispatches that reported them
        self._phase_ms = {"scan_ms": 0.0, "gather_ms": 0.0, "rescore_ms": 0.0}
        self._phase_n = 0
        # mesh dispatches: per-device scan bytes summed element-wise across
        # the dispatches that reported them (the mesh int8 executors)
        self._device_bytes: list[int] = []
        self._speculation = {"dispatches": 0, "rows_speculated": 0,
                             "rows_topped_up": 0, "rows_wasted": 0}

    # ------------------------------------------------------------ decisions
    def _expected_service_s(self, mode: str) -> float:
        est = self._ema_s[mode]
        return est if est is not None else 1e-3

    def choose_mode(self, pending: "deque[SearchRequest]", clock_s: float) -> str:
        """One scheduling decision — pure function of queue state + policy."""
        if self.policy == "latency":
            return "fdsq"
        if self.policy == "throughput":
            return "fqsd"
        budget_s = self._expected_service_s("fqsd") * self.deadline_slack
        for r in pending:
            if r.deadline_ms is None:
                continue
            remaining_s = r.deadline_ms / 1e3 - (clock_s - r.arrival_s)
            if remaining_s < budget_s:
                return "fdsq"  # urgent: the deep scan would blow the deadline
        if len(pending) >= self.fqsd_min_depth:
            return "fqsd"  # deep backlog: amortize over the streaming scan
        return "fdsq"

    def choose_tier(self, mode: str, depth: int) -> str:
        """Bandwidth-aware policy hook: pick the storage tier a dispatch
        scans. Default: once the backlog is deep enough that a full dataset
        pass is amortized over >= `int8_min_depth` queries, the scan is
        memory-bound and the int8 tier (1 B/element, 4x less traffic than
        f32, certified exact rescore) wins. This covers streamed plans too:
        a non-resident engine whose store carries the int8 tier reports
        ``has_int8``, so deep backlogs route out-of-core scans through the
        fqsd-int8-*streamed executors (disk bytes are the bound there, and
        the quantized pass moves ~1/4 of them). Override with a
        measured-GB/s policy for smarter routing; `stats()["bytes_scanned"]`
        exposes the traffic either way. Requests with an explicit ``tier``
        never reach this hook — per-request pins always win.
        """
        if (
            mode == "fqsd"
            and self.int8_min_depth is not None
            and depth >= self.int8_min_depth
            and self.engine.has_int8
        ):
            return "int8"
        return "f32"

    @staticmethod
    def batch_signature(r: SearchRequest) -> tuple:
        """Batch-compatibility key: a dispatch never mixes requests whose
        options would plan differently (k, metric, tier/mode pins) or whose
        filter masks differ (masks fold into the scanned norms). Public so
        live front ends group their queues by
        exactly the compatibility rule the dispatch path enforces."""
        return (
            r.k, r.metric, r.tier,
            r.mode_hint if r.mode_hint != "auto" else None,
            id(r.filter_mask) if r.filter_mask is not None else None,
            r.allow_partial, r.max_retries,
        )

    def note_queue_depth(self, depth: int) -> None:
        """Record the feeding queue's current depth (live-serving gauge)."""
        self.queue_depth = int(depth)

    # ------------------------------------------------------------ execution
    def _search(self, request: SearchRequest) -> SearchResult:
        if self.router is not None:
            return self.router.search(self.collection, request)
        return self.engine.search(request)

    # ------------------------------------------------------- circuit breaker
    def _probe_store(self) -> bool:
        """Breaker probe: can the implicated shard (or shard 0) be read on
        every tier again? Success closes the breaker; a failure keeps
        serving degraded (allow_partial stamped on dispatches)."""
        self._breaker_probes += 1
        store = getattr(self.engine, "store", None)
        if store is None or not hasattr(store, "read_shard"):
            return True  # nothing probeable: assume recovered
        shard = min(self._breaker_shards) if self._breaker_shards else 0
        try:
            store.read_shard(shard, "f32")
            if store.has_tier("int8"):
                store.read_shard(shard, "int8")
        except Exception:
            return False
        return True

    def _breaker_note(self, health: dict | None) -> None:
        """Count one dispatch toward the breaker: failed or degraded shards
        open it after `breaker_threshold` consecutive dirty dispatches; a
        clean dispatch resets the streak and closes an open breaker."""
        dirty = bool(health and (health.get("failed_shards")
                                 or health.get("degraded")))
        if not dirty:
            self._breaker_failures = 0
            self._breaker_open = False
            return
        self._breaker_shards.update(
            s for key in ("failed_shards", "degraded")
            for s in health.get(key, ()) if s >= 0)
        self._breaker_failures += 1
        if (not self._breaker_open
                and self._breaker_failures >= self.breaker_threshold):
            self._breaker_open = True
            self._breaker_trips += 1

    def _stack(self, reqs: list[SearchRequest]):
        """One row per request, stacked and zero-padded to
        ``next_pow2(len(reqs))`` rows, so arbitrary queue depths resolve to
        at most log2(max_batch) plans: numpy rows stay a numpy batch (the
        engine puts it on its device), tensor rows become a tensor batch on
        the engine's device. Padding rows are scored like any other and
        sliced off; the kernels keep every query row's queue apart."""
        rows = []
        for r in reqs:
            v = r.queries
            v = v.to(torch.float32) if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
            if v.ndim == 2 and v.shape[0] == 1:
                v = v[0]
            if v.ndim != 1:
                raise ValueError(
                    "the scheduler serves single-query requests (batching is "
                    "its job); send one SearchRequest per query, got queries "
                    f"of shape {tuple(v.shape)}")
            rows.append(v)
        b = len(rows)
        pad = next_pow2(b) - b
        tracing.count("scheduler.rows", b)
        tracing.count("scheduler.padded_rows", pad)
        if not any(isinstance(v, torch.Tensor) for v in rows):
            q = np.stack(rows)
            return np.concatenate([q, np.zeros((pad, q.shape[1]), q.dtype)]) if pad else q
        dev = self.engine.device
        q = torch.stack([torch.as_tensor(v).to(dev) for v in rows])
        return torch.cat([q, q.new_zeros((pad, q.shape[1]))]) if pad else q

    def _execute(
        self,
        reqs: list[SearchRequest],
        mode: str,
        clock_s: float | None,
        tier: str = "f32",
    ) -> tuple[list[SearchResult], float]:
        """Run one batch through the chosen plan; returns results + svc time.

        `clock_s=None` means wall-clock mode (no simulated arrival times):
        per-request latency is the service time alone, matching the
        historical RetrievalServer accounting.

        The stacked batch is padded up to the next power of two before it
        reaches the engine (:meth:`_stack`): without it every new depth
        would add an executable in the serving hot path, against the
        no-reflashing property the scheduler exists to exploit.
        """
        self.dispatches += 1
        t0 = time.perf_counter()
        b = len(reqs)
        label = "fqsd-int8" if tier == "int8" else mode
        with tracing.span("scheduler.dispatch", t0) as span:
            if span:
                span.attrs.update(rows=b, padded_rows=next_pow2(b) - b, mode=label, tier=tier)
            q = self._stack(reqs)
            head = reqs[0]
            if self._breaker_open and self._probe_store():
                # the probe read succeeded: the storage fault cleared — close
                # the breaker and serve strict again
                self._breaker_open = False
                self._breaker_failures = 0
            allow_partial = head.allow_partial or self._breaker_open

            def dispatch(partial_ok: bool) -> SearchResult:
                return self._search(SearchRequest(
                    queries=q, k=head.k, metric=head.metric,
                    tier="int8" if tier == "int8" else "f32",
                    mode_hint="fqsd" if tier == "int8" else mode,
                    filter_mask=head.filter_mask,
                    allow_partial=partial_ok, max_retries=head.max_retries,
                ))

            try:
                batch = dispatch(allow_partial)
            except FaultError as e:
                # unrecoverable storage fault under strict semantics: count it
                # toward the breaker; once open, retry this dispatch degraded
                # (partial allowed) instead of failing the serve loop — below
                # the threshold, stay loud.
                self._breaker_note(
                    {"failed_shards": [getattr(e, "shard_id", -1)]})
                if allow_partial or not self._breaker_open:
                    raise
                batch = dispatch(True)
            else:
                self._breaker_note(batch.stats.get("health"))
            # the answers reach the host inside the window: .cpu() waits for the
            # card, so dt_s is the service time, not the time to enqueue
            with tracing.span("scheduler.device_wait") as wait:
                if wait and batch.scores.is_cuda:
                    # traced only: the wait apart from the scheduler's host time
                    torch.cuda.current_stream(batch.scores.device).synchronize()
            scores = batch.scores[:b].cpu()
            indices = batch.indices[:b].cpu()
            if batch.tier == "int8":
                cert = torch.as_tensor(batch.certified)[:b].cpu()
            else:
                cert = None  # exact path: trivially certified
            ks = batch.kernel_stats
            skip_rate = (float(ks["prune_skip_rate"])
                         if ks is not None and "prune_skip_rate" in ks else None)
            dt_s = time.perf_counter() - t0

            plan = batch.plan
            self._executors[label].add(plan.executor)
            # dataset bytes one scan of this plan moved (the bandwidth account
            # choose_tier optimizes), reported per tier AND per dispatch label
            self._bytes_scanned[batch.tier if batch.tier == "int8" else "f32"] += (
                batch.stats["bytes_scanned"]
            )
            self._tiers[label].add(batch.tier)
            self._mode_bytes[label] += batch.stats["bytes_scanned"]
            n_true = b if cert is None else int(cert.sum())
            self._cert[label]["total"] += b
            self._cert[label]["true"] += n_true
            if skip_rate is not None:
                self._skip_rate_sum += skip_rate
                self._skip_rate_n += 1
            self._transfers += int(batch.stats.get("transfers", 0))
            self._restarts += int(batch.stats.get("restarts", 0))
            if "scan_ms" in batch.stats:  # streamed and sharded int8 plans:
                # the scan/gather/rescore wall-time split
                self._phase_n += 1
                for key in self._phase_ms:
                    self._phase_ms[key] += float(batch.stats.get(key, 0.0))
            per_dev = batch.stats.get("bytes_per_device")
            if per_dev is not None:
                if len(per_dev) > len(self._device_bytes):
                    self._device_bytes.extend([0] * (len(per_dev) - len(self._device_bytes)))
                for di, nbytes in enumerate(per_dev):
                    self._device_bytes[di] += int(nbytes)
            spec = batch.stats.get("speculation")
            if spec is not None:
                self._speculation["dispatches"] += 1
                for key in ("rows_speculated", "rows_topped_up", "rows_wasted"):
                    self._speculation[key] += int(spec.get(key, 0))
            health = batch.stats.get("health")
            if health is not None:
                self._health_agg["retries"] += int(health.get("retries", 0))
                for key in ("failed_shards", "degraded", "slow_shards"):
                    self._health_agg[key].update(health.get(key, ()))
            partial = bool(batch.stats.get("partial", False))
            if self._last_mode is not None and label != self._last_mode:
                self._switches += 1
            self._last_mode = label
            ema = self._ema_s[label]
            self._ema_s[label] = dt_s if ema is None else 0.7 * ema + 0.3 * dt_s
            self._svc_s[label] += dt_s
            self._count[label] += len(reqs)

            results = []
            for i, r in enumerate(reqs):
                if clock_s is None:  # wall-clock mode: service time only
                    lat_ms = dt_s * 1e3
                else:
                    lat_ms = (clock_s + dt_s - r.arrival_s) * 1e3  # queueing + service
                if r.deadline_ms is not None and lat_ms > r.deadline_ms:
                    self.deadline_misses += 1
                self._lat_ms[label].append(lat_ms)
                results.append(SearchResult(
                    topk=TopK(scores[i], indices[i]),
                    plan=plan,
                    tier=batch.tier,
                    certified=bool(cert[i]) if cert is not None else True,
                    kernel_stats=batch.kernel_stats,
                    stats={"latency_ms": lat_ms, "batched": len(reqs),
                           "mode": label, "deadline_ms": r.deadline_ms,
                           "health": dict(health) if health is not None else {},
                           "partial": partial},
                    rid=r.rid,
                ))
        self.served += len(reqs)
        return results, dt_s

    def _shed_result(self, r: SearchRequest, clock_s: float) -> SearchResult:
        """An expired request's answer: empty top-k (inf scores, -1 ids),
        loudly flagged — never a late scan dressed up as service."""
        k = r.k if r.k is not None else self.engine.k
        lat_ms = (clock_s - r.arrival_s) * 1e3
        return SearchResult(
            topk=TopK(torch.full((k,), torch.inf, dtype=torch.float32),
                      torch.full((k,), -1, dtype=torch.int32)),
            plan=None, tier="f32", certified=False,
            stats={"latency_ms": lat_ms, "batched": 0, "mode": "shed",
                   "shed": True, "deadline_ms": r.deadline_ms,
                   "partial": False,
                   "health": {"retries": 0, "failed_shards": [],
                              "degraded": [], "slow_shards": [],
                              "shed": True}},
            rid=r.rid,
        )

    def dispatch_batch(
        self,
        reqs: list[SearchRequest],
        clock_s: float | None = None,
    ) -> list[SearchResult]:
        """One live dispatch — the continuous-batching entry point.

        The discrete-event loop (:meth:`serve`) owns its own clock; a live
        front end instead hands over one
        option-compatible batch at a time with ``clock_s`` from its event
        loop (same time base as the requests' ``arrival_s`` stamps, so
        latency accounting covers queueing + service). Applies the same
        ladder as ``serve``: shed already-expired requests
        (``shed_expired``), one mode/tier decision for the survivors
        (per-request pins win), one batched execution. Results come back
        in request order; ``clock_s=None`` preserves the wall-clock
        (service-time-only) latency semantics of :class:`RetrievalServer`.
        """
        out: dict[int, SearchResult] = {}
        live: list[tuple[int, SearchRequest]] = []
        for i, r in enumerate(reqs):
            expired = (
                self.shed_expired and clock_s is not None
                and r.deadline_ms is not None
                and (clock_s - r.arrival_s) * 1e3 > r.deadline_ms
            )
            if expired:
                self.shed += 1
                self.deadline_misses += 1
                out[i] = self._shed_result(r, clock_s)
            else:
                live.append((i, r))
        if live:
            batch = [r for _, r in live]
            mode = self.choose_mode(deque(batch),
                                    clock_s if clock_s is not None else 0.0)
            head = batch[0]
            if head.mode_hint != "auto":
                mode = head.mode_hint  # per-request pin beats policy
            tier = head.tier
            if tier == "auto":
                tier = self.choose_tier(mode, len(batch))
            if tier == "int8":
                mode = "fqsd"
            results, _ = self._execute(batch, mode, clock_s, tier=tier)
            for (i, _), res in zip(live, results):
                out[i] = res
        return [out[i] for i in range(len(reqs))]

    # -------------------------------------------------------------- serving
    def serve(self, requests: Iterable[SearchRequest]) -> Iterator[SearchResult]:
        """Discrete-event loop over an arrival stream (sorted by arrival_s).

        The clock starts at the first arrival, advances by measured service
        time per dispatch, and jumps forward over idle gaps. Each iteration
        admits everything that has arrived, makes ONE mode decision
        (per-request pins override it), sheds requests whose deadline has
        already expired (``shed_expired``), and dispatches one batch of
        option-compatible requests.
        """
        stream = iter(requests)
        pending: deque[SearchRequest] = deque()
        nxt = next(stream, None)
        clock = nxt.arrival_s if nxt is not None else 0.0
        while nxt is not None or pending:
            while nxt is not None and nxt.arrival_s <= clock + 1e-12:
                if nxt.tier == "int8" and nxt.mode_hint == "fdsq":
                    # same contract as ExactKNN.search: refuse the invalid
                    # pin combination instead of silently rewriting it
                    raise ValueError(
                        "tier='int8' is a throughput (FQ-SD) tier and cannot "
                        f"serve mode_hint='fdsq' (request rid={nxt.rid})"
                    )
                pending.append(nxt)
                nxt = next(stream, None)
            self.note_queue_depth(len(pending))
            if not pending:
                clock = nxt.arrival_s  # idle until the next arrival
                continue
            if self.shed_expired:
                kept: deque[SearchRequest] = deque()
                for r in pending:
                    expired = (r.deadline_ms is not None
                               and (clock - r.arrival_s) * 1e3 > r.deadline_ms)
                    if expired:
                        self.shed += 1
                        self.deadline_misses += 1
                        yield self._shed_result(r, clock)
                    else:
                        kept.append(r)
                pending = kept
                if not pending:
                    if nxt is None:
                        break  # everything left was shed
                    clock = nxt.arrival_s
                    continue
            mode = self.choose_mode(pending, clock)
            head = pending[0]
            if head.mode_hint != "auto":
                mode = head.mode_hint  # per-request pin beats policy
            tier = head.tier
            if tier == "auto":
                tier = self.choose_tier(mode, len(pending))
            if tier == "int8":
                mode = "fqsd"
            take = self.fdsq_max_batch if mode == "fdsq" else self.max_batch
            sig = self.batch_signature(head)
            reqs = [pending.popleft()]
            while (pending and len(reqs) < take
                   and self.batch_signature(pending[0]) == sig):
                reqs.append(pending.popleft())
            self.note_queue_depth(len(pending))
            results, dt_s = self._execute(reqs, mode, clock, tier=tier)
            clock += dt_s
            yield from results

    def _compaction_health(self) -> dict | None:
        """Compaction/generation status of the served collection's store,
        or None when there is no compactable DatasetStore behind it."""
        if self.router is None or self.collection is None:
            return None
        try:
            return self.router.compaction_status(self.collection)
        except (KeyError, ValueError):
            return None

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Uniform per-plan accounting: every served dispatch label reports
        count, latency percentiles (over its last ``LATENCY_SAMPLES``
        requests), qps, executors, tier(s), certified fraction, and bytes
        scanned — the f32 paths included (exact scans are trivially
        certified)."""
        per_plan = {}
        for mode in self.MODES:
            lat = np.asarray(self._lat_ms[mode])
            if len(lat) == 0:
                continue
            svc = self._svc_s[mode]
            cert = self._cert[mode]
            per_plan[mode] = {
                "count": int(self._count[mode]),
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "qps": float(self._count[mode] / svc) if svc > 0 else float("inf"),
                "executors": sorted(self._executors[mode]),
                "tier": sorted(self._tiers[mode]),
                "certified_exact": (cert["true"] / cert["total"]
                                    if cert["total"] else 1.0),
                "bytes_scanned": int(self._mode_bytes[mode]),
            }
        out = {
            "served": self.served,
            "deadline_misses": self.deadline_misses,
            "shed": self.shed,
            # live backpressure: feeding-queue depth (gauge) + dispatch
            # count — what admission control and the stats stream read
            "queue_depth": self.queue_depth,
            "dispatches": self.dispatches,
            "policy": self.policy,
            "mode_switches": self._switches,
            "per_plan": per_plan,
            "bytes_scanned": dict(self._bytes_scanned),
            # streamed-plan prefetcher counters (0 for resident serving)
            "transfers": self._transfers,
            "restarts": self._restarts,
            # aggregated resilience accounting across every dispatch (the
            # per-result stats["health"] blocks, merged) + breaker state
            "health": {
                "retries": int(self._health_agg["retries"]),
                "failed_shards": sorted(self._health_agg["failed_shards"]),
                "degraded": sorted(self._health_agg["degraded"]),
                "slow_shards": sorted(self._health_agg["slow_shards"]),
                "shed": self.shed,
                # store lifecycle: generation + compactor state of the
                # served collection (None when the engine is array-backed
                # or the scheduler runs without a Router)
                "compaction": self._compaction_health(),
            },
            "circuit_breaker": {
                "open": self._breaker_open,
                "trips": self._breaker_trips,
                "probes": self._breaker_probes,
                "consecutive_failures": self._breaker_failures,
            },
        }
        if self.collection is not None:
            out["collection"] = self.collection
        if self._skip_rate_n:  # fused-kernel plans only
            out["prune_skip_rate"] = self._skip_rate_sum / self._skip_rate_n
        if self._phase_n:  # streamed and sharded int8 plans: pipeline
            # wall-time split (summed across dispatches) + speculation counters
            out["phase_ms"] = dict(self._phase_ms)
            out["speculation"] = dict(self._speculation)
        if self._device_bytes:  # mesh dispatches: per-device scan traffic
            out["bytes_per_device"] = list(self._device_bytes)
        return out


class RetrievalServer(AdaptiveScheduler):
    """Historical FD-SQ-only micro-batching server (latency policy).

    Preserves the original semantics: requests are taken in arrival order,
    flushed when `max_batch` pile up or the batching window expires, and
    every flush runs the engine's FD-SQ latency path. New deployments
    should construct :class:`AdaptiveScheduler` directly.
    """

    def __init__(
        self,
        engine: ExactKNN,
        batch_window_s: float = 0.0,
        max_batch: int = 16,
    ):
        super().__init__(
            engine, policy="latency", fdsq_max_batch=max_batch,
            max_batch=max_batch,
        )
        self.batch_window_s = batch_window_s

    def _flush(self, pending: list[SearchRequest]) -> list[SearchResult]:
        """Flush one window in option-compatible runs: the legacy server
        predates per-request options, so a window may now mix requests
        whose k/metric/tier/mask would plan differently — each run
        dispatches separately rather than silently taking the head's."""
        results: list[SearchResult] = []
        i = 0
        while i < len(pending):
            sig = self.batch_signature(pending[i])
            j = i + 1
            while j < len(pending) and self.batch_signature(pending[j]) == sig:
                j += 1
            batch, _ = self._execute(pending[i:j], "fdsq", clock_s=None)
            results.extend(batch)
            i = j
        return results

    def serve(self, requests: Iterable[SearchRequest]) -> Iterator[SearchResult]:
        """Consume an arrival stream; flush on window expiry or max_batch."""
        pending: list[SearchRequest] = []
        window_open = None
        for r in requests:
            if r.tier == "int8" or r.mode_hint == "fqsd":
                # this server's contract IS the FD-SQ/f32 latency path; a
                # request pinning anything else must fail loudly, not be
                # silently served on the wrong tier/plan
                raise ValueError(
                    "RetrievalServer serves the FD-SQ f32 latency path only; "
                    f"request rid={r.rid} pins tier={r.tier!r} / "
                    f"mode_hint={r.mode_hint!r} — use AdaptiveScheduler"
                )
            pending.append(r)
            window_open = window_open or time.perf_counter()
            window_expired = (
                self.batch_window_s == 0.0
                or (time.perf_counter() - window_open) >= self.batch_window_s
            )
            if len(pending) >= self.max_batch or window_expired:
                yield from self._flush(pending)
                pending, window_open = [], None
        if pending:
            yield from self._flush(pending)
