"""Streaming top-k over a score matrix on Hopper.

Replaces ``repro/kernels/topk/kernel.py::topk_pallas`` (``_topk_kernel``);
the CUDA sources are ``../csrc/topk.cu`` (``topk_scan``) and ``knn_merge``
of ``../csrc/knn.cu``, with the bitonic networks of ``../csrc/bitonic.cuh``.

What it computes, as the TPU kernel does: for each row of an (M, N) f32
score matrix in device memory, the k_eff lexicographically smallest
(score, index) pairs, sorted: each (bm, bn) tile is bitonic-sorted per row
and merged into the row's queue, with no pruning. A queue starts as
(+inf, -1) pairs, which every (+inf, j) pair compares above, so lanes past
N (and +inf scores) never enter it.

Design. As ``knn_scan`` does, the n-tiles are split over S blocks per
m-tile so that a 16-row matrix still fills the card; each block keeps its
own queues in shared memory and ``knn_merge`` reduces the S sorted queues.
Neither M nor N need be a multiple of its block: the kernel masks the
ragged edges, so the scores are never copied.

Bound on this card: the kernel reads the scores once (M·N·4 bytes); the
compare-exchanges of the sorts are fewer than 1 % of the card's f32 issue
rate at the main path's shape, so bytes bound it. A full bitonic sort of
every tile does far more work than that bound counts (log²(bn)/2 stages per
tile, all in shared memory), which is what a faster design would remove.

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.partition import next_pow2
from repro_torch.kernels.knn.kernel import (
    _BLOCK_ROWS,
    _BLOCK_SMEM_MAX,
    _THREADS,
    LAUNCHES,
    _check_cuda,
    _raise_on,
    _resolve_splits,
    knn_merge,
    plain_queues,
)


def topk_smem_bytes(bm: int, bn: int, k_eff: int) -> int:
    """Shared memory of one block (``topk_smem_bytes`` in topk.cu)."""
    return bm * bn * 8 + bm * k_eff * 8


def topk_block_m(k_eff: int, bn: int, m: int) -> int:
    """Largest bm whose tile and queues fit a block, at most next_pow2(m)."""
    fit = [b for b in _BLOCK_ROWS
           if topk_smem_bytes(b, bn, k_eff) <= _BLOCK_SMEM_MAX and b <= next_pow2(m)]
    if not fit:
        raise ValueError(f"k_eff={k_eff}, bn={bn}: queue and tile exceed shared memory")
    return fit[-1]


def _check(scores, k_eff, bn):
    if scores.ndim != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be (M, N) f32, got {scores.dtype} {tuple(scores.shape)}")
    if bn % _THREADS or bn & (bn - 1):
        raise ValueError(f"bn={bn} must be a power of two >= {_THREADS}")
    if k_eff & (k_eff - 1) or not 1 <= k_eff <= bn:
        raise ValueError(f"k_eff={k_eff} must be a power of two <= bn={bn}")


def topk_scan(scores, k_eff: int, bm: int, bn: int, splits: int | None = None):
    """Per-split sorted queues, (M, S, k_eff) f32 values and i32 indices.
    ``splits=None`` fills the card."""
    _check(scores, k_eff, bn)
    if scores.device.type == "cpu":
        return topk_scan_plain(scores, k_eff, bn, splits or 1)
    _check_cuda(scores)
    if bm not in _BLOCK_ROWS or topk_smem_bytes(bm, bn, k_eff) > _BLOCK_SMEM_MAX:
        raise ValueError(f"bm={bm} must be one of {_BLOCK_ROWS} and fit shared memory")
    from repro_torch.kernels.build import load_library

    m, n = scores.shape
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    splits, tps = _resolve_splits(splits, m_tiles, n_tiles, topk_smem_bytes(bm, bn, k_eff),
                                  scores.device)
    out_v = torch.empty((m, splits, k_eff), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((m, splits, k_eff), dtype=torch.int32, device=scores.device)
    rc = load_library().topk_scan(
        scores.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), m, n, k_eff, bm, bn, splits,
        tps, torch.cuda.current_stream(scores.device).cuda_stream)
    _raise_on(rc, "topk_scan")
    LAUNCHES["topk"] += 1
    return out_v, out_i


def topk_fused(scores, k_eff: int, bm: int, bn: int):
    """(M, N) -> the (M, k_eff) sorted queues of the whole row."""
    if scores.device.type == "cpu":
        v, i = topk_scan_plain(scores, k_eff, bn, 1)
        return v[:, 0], i[:, 0]
    return knn_merge(*topk_scan(scores, k_eff, bm, bn))


def topk_scan_plain(scores, k_eff: int, bn: int, splits: int = 1):
    """``topk_scan`` in torch ops: the scan's queue loop over score tiles
    read from the matrix, lanes past N as +inf. Without pruning the row
    blocking does not change the result, so the plain version takes bm = 1."""
    _check(scores, k_eff, bn)
    m, n = scores.shape

    def tile(rows):  # (S, bn) column ids -> (M, S, bn) scores
        return torch.where(rows[None] < n, scores[:, rows.clamp(max=n - 1)], torch.inf)

    v, i, _ = plain_queues(tile, m, -(-n // bn), k_eff, 1, bn, False, splits, scores.device)
    return v, i
