"""Exact top-k selection and merge on (score, index) pairs.

The paper's kNN queue drains its k smallest (distance, index) pairs in
order, earlier-seen elements winning ties. Every selection here is exact
and lexicographic on (score, index): equal scores go to the smaller index,
and -0.0 orders equal to +0.0.

torch has no two-key sort, so each pair is packed into one int64 key: the
f32 score (with -0.0 mapped to +0.0) in an order-preserving signed form in
the high 32 bits, the index in the low 32. Distinct indices make every key
distinct, so a sort or top-k over keys is the lexicographic order itself,
whatever algorithm the device's sort uses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: Index of an empty queue slot (its score is +inf).
INVALID_INDEX = -1


class TopK(NamedTuple):
    """Running kNN queue state: sorted ascending along the last axis."""

    scores: torch.Tensor  # (..., k) f32
    indices: torch.Tensor  # (..., k) i32

    @property
    def k(self) -> int:
        return self.scores.shape[-1]


def empty_topk(batch_shape: tuple[int, ...], k: int, device=None) -> TopK:
    """A queue full of (+inf, -1) — the reset state of the paper's queue."""
    return TopK(
        scores=torch.full((*batch_shape, k), torch.inf, dtype=torch.float32,
                          device=device),
        indices=torch.full((*batch_shape, k), INVALID_INDEX,
                           dtype=torch.int32, device=device),
    )


def pair_keys(scores: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """int64 keys whose integer order is the (score, index) order."""
    v = scores.to(torch.float32) + 0.0  # -0.0 + 0.0 == +0.0
    b = v.view(torch.int32).to(torch.int64)
    # non-negative floats order as their bits; negative ones reversed
    skey = torch.where(b >= 0, b, -(b & 0x7FFFFFFF) - 1)
    return (skey << 32) | (indices.to(torch.int64) + 2**31)


def sort_pairs(
    scores: torch.Tensor, indices: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (scores, indices) ascending by (score, index) over the last axis."""
    scores = scores.to(torch.float32)
    indices = indices.to(torch.int32)
    perm = torch.argsort(pair_keys(scores, indices), dim=-1)
    return scores.gather(-1, perm), indices.gather(-1, perm)


def topk_smallest(
    scores: torch.Tensor, indices: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k lexicographically smallest pairs of the last axis, sorted.

    scores : (..., n), indices : (..., n). If n < k the result is padded
    with (+inf, -1), a partially filled queue. Ties at the k boundary go to
    the smaller index, as the documented contract says.
    """
    scores = scores.to(torch.float32)
    indices = indices.to(torch.int32)
    n = scores.shape[-1]
    if n <= k:
        s, i = sort_pairs(scores, indices)
        pad = k - n
        if pad:
            batch = s.shape[:-1]
            s = torch.cat([s, s.new_full((*batch, pad), torch.inf)], -1)
            i = torch.cat([i, i.new_full((*batch, pad), INVALID_INDEX)], -1)
        return s, i
    _, pos = torch.topk(pair_keys(scores, indices), k, dim=-1, largest=False,
                        sorted=True)
    return scores.gather(-1, pos), indices.gather(-1, pos)


def merge_topk(state: TopK, scores: torch.Tensor, indices: torch.Tensor) -> TopK:
    """Insert a block of candidates into the running queue (exact)."""
    all_s = torch.cat([state.scores, scores.to(torch.float32)], dim=-1)
    all_i = torch.cat([state.indices, indices.to(torch.int32)], dim=-1)
    return TopK(*topk_smallest(all_s, all_i, state.k))


def tree_merge_sorted(parts_scores: torch.Tensor,
                      parts_indices: torch.Tensor) -> TopK:
    """Merge P per-partition results, (P, ..., k) -> (..., k), by a binary
    tree of pairwise merges (O(log P) stages)."""
    s = parts_scores.to(torch.float32)
    i = parts_indices.to(torch.int32)
    k = s.shape[-1]
    while s.shape[0] > 1:
        if s.shape[0] % 2:  # pad with one empty (drained) queue
            s = torch.cat([s, torch.full_like(s[:1], torch.inf)], dim=0)
            i = torch.cat([i, torch.full_like(i[:1], INVALID_INDEX)], dim=0)
        half = s.shape[0] // 2
        s, i = topk_smallest(torch.cat([s[:half], s[half:]], dim=-1),
                             torch.cat([i[:half], i[half:]], dim=-1), k)
    return TopK(s[0], i[0])


def knn_oracle(
    scores: torch.Tensor, k: int, base_index: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference kNN from a dense (M, N) score matrix (smaller = closer)."""
    m, n = scores.shape
    idx = torch.arange(n, dtype=torch.int32,
                       device=scores.device).expand(m, n)
    s, i = topk_smallest(scores, idx, k)
    return s, torch.where(i >= 0, i + base_index, i)
