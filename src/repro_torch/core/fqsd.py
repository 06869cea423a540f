"""FQ-SD — Fixed Queries, Streamed Dataset (throughput; paper fig. 1).

A fixed batch of M queries is resident; the dataset flows past it in equal
chunks. Each chunk step computes an (M, chunk) score tile and inserts it
into the M running kNN queues, so scores never exist beyond one tile. This
is the plain path (``backend="torch"``); the fused kernel serves the same
requests with ``backend="cuda"``.

Out of core, the dataset lives in host memory and streams past the queries
shard by shard through the double buffer (:func:`fqsd_streamed`, paper
section 3.3), each shard folded into the queues by a :class:`PartitionStep`
on the plan's backend.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.core.distance import Metric, direct_l2_sq, pairwise_scores, validate_metric
from repro_torch.core.partition import PaddedDataset
from repro_torch.core.topk import TopK, empty_topk, merge_topk, sort_pairs


def _masked_scores(
    queries: torch.Tensor,
    chunk: torch.Tensor,
    chunk_norms: torch.Tensor | None,
    n_valid: int,
    metric: Metric,
) -> torch.Tensor:
    """Score tile with padded rows forced to +inf.

    Validity is carried by BOTH the n_valid count and +inf norms: the norm
    channel poisons l2 scores arithmetically, but for ip/cos a zero-padded
    row scores 0 / 1, so the explicit mask is authoritative for every
    metric.
    """
    s = pairwise_scores(queries, chunk, metric, x_norms=chunk_norms)
    mask = torch.arange(chunk.shape[0], device=chunk.device) < n_valid
    if chunk_norms is not None:
        mask = mask & torch.isfinite(chunk_norms)
    return torch.where(mask[None, :], s, torch.inf)


def chunk_step(
    state: TopK,
    queries: torch.Tensor,
    chunk: torch.Tensor,
    chunk_norms: torch.Tensor | None,
    base_index: int,
    n_valid: int,
    metric: Metric = "l2",
) -> TopK:
    """Insert one dataset chunk into the running queues (exact)."""
    s = _masked_scores(queries, chunk, chunk_norms, n_valid, metric)
    idx = base_index + torch.arange(chunk.shape[0], dtype=torch.int32,
                                    device=chunk.device)
    return merge_topk(state, s, idx.expand(s.shape))


def fqsd_scan(
    queries: torch.Tensor,
    dataset: torch.Tensor,
    dataset_norms: torch.Tensor,
    k: int,
    metric: Metric = "l2",
    chunk_rows: int = 8192,
) -> TopK:
    """Exact kNN of M resident queries over a device-resident dataset.

    dataset : (N, d) padded; dataset_norms carry +inf on padded rows. N
    must be a multiple of chunk_rows.
    """
    validate_metric(metric)
    n = dataset.shape[0]
    if n % chunk_rows:
        raise ValueError(f"N={n} not a multiple of chunk_rows={chunk_rows}")
    state = empty_topk((queries.shape[0],), k, device=queries.device)
    for base in range(0, n, chunk_rows):
        state = chunk_step(state, queries, dataset[base: base + chunk_rows],
                           dataset_norms[base: base + chunk_rows], base,
                           chunk_rows, metric)
    return state


class PartitionStep:
    """The step of a host-streamed scan: one partition into the running
    queues, ``step(state, queries, vectors, norms, base_index, n_valid)``.

    ``backend="torch"`` is :func:`chunk_step` in plain ops on a (m, k)
    queue. ``backend="cuda"`` is the fused kernels
    (``kernels.knn.ops.knn_shard``: ``knn_scan`` over the shard, then one
    ``knn_merge`` into the running queue, their plain versions on a CPU
    tensor), whose queue is next_pow2(k) wide and holds the kernel's
    scores; :meth:`finish` turns it into the (m, k) result. ``init`` gives
    the empty queue either way.
    """

    def __init__(self, k: int, metric: Metric = "l2", backend: str = "torch"):
        validate_metric(metric)
        self.k, self.metric, self.backend = int(k), metric, backend

    def init(self, m: int, device=None) -> TopK:
        if self.backend == "cuda":
            from repro_torch.core.partition import next_pow2

            return empty_topk((m,), next_pow2(self.k), device=device)
        return empty_topk((m,), self.k, device=device)

    def __call__(self, state: TopK, queries, vectors, norms, base_index, n_valid) -> TopK:
        if self.backend == "cuda":
            from repro_torch.kernels.knn.ops import knn_shard

            if int(n_valid) < vectors.shape[0]:
                # rows past n_valid must be masked for ip/cos, whose padded
                # zero rows would otherwise score; the kernel masks on norms
                norms = norms.clone()
                norms[int(n_valid):] = torch.inf
            return TopK(*knn_shard(state.scores, state.indices, queries, vectors, norms,
                                   self.k, self.metric, int(base_index)))
        return chunk_step(state, queries, vectors, norms, int(base_index), int(n_valid),
                          self.metric)

    def finish(self, state: TopK) -> TopK:
        if self.backend == "cuda":
            from repro_torch.kernels.knn.ops import finish_queue

            return finish_queue(state.scores, state.indices, self.k, self.metric == "cos")
        return state


def make_partition_step(k: int, metric: Metric = "l2", backend: str = "torch") -> PartitionStep:
    """A step fn(state, queries, vectors, norms, base_index, n_valid) that
    inserts one partition into the queues, for host-streamed scans (see
    :class:`PartitionStep`)."""
    return PartitionStep(k, metric, backend)


def fqsd_streamed(
    queries: torch.Tensor,
    partitions: Iterable[PaddedDataset],
    k: int,
    metric: Metric = "l2",
    prefetch_depth: int = 2,
    put_fn=None,
    step_fn: PartitionStep | None = None,
    stream_stats: dict | None = None,
    put_retries: int = 0,
    retry_backoff_s: float = 0.05,
    health: dict | None = None,
) -> TopK:
    """Exact kNN over a host-resident dataset streamed through the double
    buffer onto the queries' device.

    ``partitions`` yields equal-shape :class:`PaddedDataset` host shards
    (``partition.iter_partitions``, a store's shard source). The stream
    keeps one partition in flight at depth 2 (two banks). ``step_fn`` lets
    the executor pass its cached step (the plan's backend); a
    ``stream_stats`` dict receives the stream's transfers/restarts
    counters; ``put_retries``/``retry_backoff_s``/``health`` ride through
    to the stream's bounded transfer retry.
    """
    from repro_torch.core.streaming import DoubleBufferedStream

    step = step_fn if step_fn is not None else make_partition_step(k, metric)
    state = step.init(queries.shape[0], device=queries.device)
    stream = DoubleBufferedStream(
        partitions, depth=prefetch_depth, put_fn=put_fn, put_retries=put_retries,
        retry_backoff_s=retry_backoff_s, health=health, device=queries.device)
    for p in stream:
        state = step(state, queries, p.vectors, p.norms, p.base_index, p.n_valid)
    if stream_stats is not None:
        stream_stats["transfers"] = stream.transfers
        stream_stats["restarts"] = stream.restarts
    return step.finish(state)


def make_direct_partition_step(k: int):
    """The streamed step in the DIRECT ``(q - x)^2`` form: one partition's
    squared differences summed over d in one fixed order
    (:func:`~repro_torch.core.distance.direct_l2_sq`), merged into the
    running (m, k) state by a full lexicographic (value, index) sort —
    chunk- and order-invariant, so a shard-by-shard scan equals a full-sort
    oracle bit for bit. The exactness oracle AND the uncertified-row
    fallback of the streamed int8 executors, whose candidate rescore uses
    the same formula. Validity rides the norms channel: a non-finite norm
    gives +inf and index -1.

    Returns fn(s, i, queries, vectors, norms, base) -> (s, i).
    """

    def step(s, i, queries, vectors, norms, base):
        n = vectors.shape[0]
        d = direct_l2_sq(queries, vectors)
        valid = torch.isfinite(norms)
        d = torch.where(valid[None, :], d, torch.inf)
        idx = torch.where(valid, int(base) + torch.arange(n, dtype=torch.int32,
                                                           device=vectors.device), -1)
        s2, i2 = sort_pairs(torch.cat([s, d], -1),
                            torch.cat([i, idx.to(torch.int32).expand(d.shape)], -1))
        return s2[:, :k], i2[:, :k]

    return step


def streamed_direct_scan(
    queries: torch.Tensor,
    partitions: Iterable[PaddedDataset],
    k: int,
    prefetch_depth: int = 2,
    step_fn=None,
    stream_stats: dict | None = None,
    put_retries: int = 0,
    retry_backoff_s: float = 0.05,
    health: dict | None = None,
) -> TopK:
    """Exact direct-form kNN over streamed partitions (l2 only): the
    streamed f32 oracle, double buffered like :func:`fqsd_streamed` and
    scored by :func:`make_direct_partition_step`, so the result is
    bit-identical to a full lexicographic sort of every (q - x)^2. The
    streamed int8 executors are held against it and fall back to it for
    uncertified queries."""
    from repro_torch.core.streaming import DoubleBufferedStream

    step = step_fn if step_fn is not None else make_direct_partition_step(k)
    m = queries.shape[0]
    s = torch.full((m, k), torch.inf, dtype=torch.float32, device=queries.device)
    i = torch.full((m, k), -1, dtype=torch.int32, device=queries.device)
    stream = DoubleBufferedStream(partitions, depth=prefetch_depth, put_retries=put_retries,
                                  retry_backoff_s=retry_backoff_s, health=health,
                                  device=queries.device)
    for p in stream:
        s, i = step(s, i, queries, p.vectors, p.norms, p.base_index)
    if stream_stats is not None:
        stream_stats["transfers"] = stream.transfers
        stream_stats["restarts"] = stream.restarts
    return TopK(s, torch.where(torch.isfinite(s), i, -1))
