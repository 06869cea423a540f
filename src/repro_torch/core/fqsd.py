"""FQ-SD — Fixed Queries, Streamed Dataset (throughput; paper fig. 1).

A fixed batch of M queries is resident; the dataset flows past it in equal
chunks. Each chunk step computes an (M, chunk) score tile and inserts it
into the M running kNN queues, so scores never exist beyond one tile. This
is the plain path (``backend="torch"``); the fused kernel serves the same
requests with ``backend="cuda"``.
"""
from __future__ import annotations

import torch

from repro_torch.core.distance import Metric, pairwise_scores, validate_metric
from repro_torch.core.topk import TopK, empty_topk, merge_topk


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


def make_partition_step(k: int, metric: Metric = "l2"):
    """A step fn(state, queries, vectors, norms, base_index, n_valid) that
    inserts one partition into the queues, for host-streamed scans."""
    validate_metric(metric)

    def step(state: TopK, queries, vectors, norms, base_index, n_valid) -> TopK:
        return chunk_step(state, queries, vectors, norms, int(base_index),
                          int(n_valid), metric)

    return step
