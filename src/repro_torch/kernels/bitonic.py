"""Bitonic compare-exchange networks in plain torch.

The reference of the CUDA device functions in ``csrc/bitonic.cuh``: the
same stages, the same lexicographic (value, index) comparison, so exact
score ties break to the smaller index. Arrays are (..., L) with L a power
of two; values and indices move as pairs. A stage at distance s pairs lane
i with lane i + s (bit s of i clear); the reshape to (..., L/2s, 2, s)
puts the two halves of every pair side by side.
"""
from __future__ import annotations

import torch


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def _pair_less(v1, i1, v2, i2):
    """(v1, i1) < (v2, i2) lexicographically."""
    return (v1 < v2) | ((v1 == v2) & (i1 < i2))


def _compare_exchange(vals, idxs, s: int, k: int | None):
    """One stage at distance s. Each pair's lower lane keeps the smaller
    pair where its bit k is clear (ascending block) and the larger where it
    is set; ``k=None`` sorts every pair ascending."""
    lead, L = vals.shape[:-1], vals.shape[-1]
    v = vals.reshape(*lead, L // (2 * s), 2, s)
    i = idxs.reshape(*lead, L // (2 * s), 2, s)
    lo_v, hi_v, lo_i, hi_i = v[..., 0, :], v[..., 1, :], i[..., 0, :], i[..., 1, :]
    swap = _pair_less(hi_v, hi_i, lo_v, lo_i)
    if k is not None:
        block = torch.arange(L // (2 * s), device=vals.device) * (2 * s)
        asc = ((block & k) == 0)[:, None]
        swap = torch.where(asc, swap, _pair_less(lo_v, lo_i, hi_v, hi_i))
    out_v = torch.stack([torch.where(swap, hi_v, lo_v),
                         torch.where(swap, lo_v, hi_v)], dim=-2)
    out_i = torch.stack([torch.where(swap, hi_i, lo_i),
                         torch.where(swap, lo_i, hi_i)], dim=-2)
    return out_v.reshape(vals.shape), out_i.reshape(idxs.shape)


def bitonic_sort(vals, idxs):
    """Full ascending bitonic sort over the last axis (power-of-two length):
    log2(L)·(log2(L)+1)/2 compare-exchange stages."""
    L = vals.shape[-1]
    if not _is_pow2(L):
        raise ValueError(f"bitonic_sort needs power-of-two length, got {L}")
    k = 2
    while k <= L:
        s = k // 2
        while s >= 1:
            vals, idxs = _compare_exchange(vals, idxs, s, k)
            s //= 2
        k *= 2
    return vals, idxs


def bitonic_merge_ascending(vals, idxs):
    """Sort a *bitonic* (..., L) sequence ascending: log2(L) stages."""
    L = vals.shape[-1]
    if not _is_pow2(L):
        raise ValueError(f"bitonic_merge needs power-of-two length, got {L}")
    s = L // 2
    while s >= 1:
        vals, idxs = _compare_exchange(vals, idxs, s, None)
        s //= 2
    return vals, idxs


def topk_update(buf_v, buf_i, cand_v, cand_i):
    """Merge k sorted-ascending candidates into a sorted-ascending (..., k)
    queue: reverse the candidates, keep the lane-wise lexicographic minimum
    (exactly the k smallest of the union, as a bitonic sequence), then one
    bitonic merge re-sorts it."""
    if buf_v.shape != cand_v.shape:
        raise ValueError(
            f"buffer/candidates shape mismatch {buf_v.shape} vs {cand_v.shape}")
    rev_v = torch.flip(cand_v, dims=(-1,))
    rev_i = torch.flip(cand_i, dims=(-1,))
    take_rev = _pair_less(rev_v, rev_i, buf_v, buf_i)
    return bitonic_merge_ascending(torch.where(take_rev, rev_v, buf_v),
                                   torch.where(take_rev, rev_i, buf_i))


def sort_topk_tile(scores, idxs, k_eff: int):
    """Sort a (..., L) tile ascending and return its first k_eff columns."""
    v, i = bitonic_sort(scores, idxs)
    return v[..., :k_eff], i[..., :k_eff]


def tile_prunable(scores, queue_vals) -> torch.Tensor:
    """True iff no element of a (bm, bn) score tile can enter the queues.

    Strictly greater-than: a candidate that ties a query's current worst
    value can still displace it through the index tie-break, so a tile that
    touches the threshold is never pruned.
    """
    worst = queue_vals[..., -1:]
    tile_min = torch.amin(scores, dim=-1, keepdim=True)
    return torch.all(tile_min > worst)
