"""FD-SQ — Fixed Dataset, Streamed Queries (latency; paper fig. 2).

The dataset is resident and split into partitions; a query fans out over
all of them, each partition produces a local top-k, and the locals merge
through one exact tree reduction. This is the plain path
(``backend="torch"``); the fused kernel serves the same requests with
``backend="cuda"``.
"""
from __future__ import annotations

import torch

from repro_torch.core.distance import Metric, validate_metric
from repro_torch.core.fqsd import chunk_step
from repro_torch.core.topk import TopK, empty_topk, tree_merge_sorted


def fdsq_search(
    query: torch.Tensor,
    dataset: torch.Tensor,
    dataset_norms: torch.Tensor,
    k: int,
    metric: Metric = "l2",
    n_partitions: int = 8,
) -> TopK:
    """Answer one query (or a micro-batch) over a resident dataset.

    query : (m, d) with small m (paper: m = 1); dataset : (N, d) padded,
    N divisible by n_partitions.
    """
    validate_metric(metric)
    n = dataset.shape[0]
    if n % n_partitions:
        raise ValueError(f"N={n} not divisible by n_partitions={n_partitions}")
    rows = n // n_partitions
    locals_ = [
        chunk_step(empty_topk((query.shape[0],), k, device=query.device), query,
                   dataset[p * rows: (p + 1) * rows],
                   dataset_norms[p * rows: (p + 1) * rows], p * rows, rows, metric)
        for p in range(n_partitions)
    ]
    return tree_merge_sorted(torch.stack([t.scores for t in locals_]),
                             torch.stack([t.indices for t in locals_]))


def fdsq_query_stream(
    queries_iter,
    dataset: torch.Tensor,
    dataset_norms: torch.Tensor,
    k: int,
    metric: Metric = "l2",
    n_partitions: int = 8,
):
    """Answer a stream of incoming queries one at a time (paper arrows
    3-5), yielding one TopK of shape (k,) per query."""
    for q in queries_iter:
        q = torch.as_tensor(q).to(device=dataset.device, dtype=dataset.dtype)
        if q.ndim == 1:
            q = q[None, :]
        out = fdsq_search(q, dataset, dataset_norms, k, metric, n_partitions)
        yield TopK(out.scores[0], out.indices[0])
