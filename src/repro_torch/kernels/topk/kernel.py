"""Streaming top-k over a score matrix on Hopper.

Replaces ``repro/kernels/topk/kernel.py::topk_pallas`` (``_topk_kernel``);
the CUDA sources are ``../csrc/topk.cu`` (``topk_scan``), the survivor
filter of ``../csrc/select.cuh`` and ``knn_merge`` of ``../csrc/knn.cu``.

What it computes, as the TPU kernel does: for each row of an (M, N) f32
score matrix in device memory, the k_eff lexicographically smallest
(score, index) pairs, sorted. A queue starts as (+inf, -1) pairs, which
every (+inf, j) pair compares above, so lanes past N (and +inf scores)
never enter it.

Bound on this card: the kernel reads the scores once (M·N·4 bytes) and
needs about one comparison per score, so bytes bound it. Sorting whole
tiles, as the TPU kernel does, would cost 55 barrier-separated stages per
1024-wide tile, far above that bound; this design sorts only the scores
that can still enter the queue.

Design. One block per (row, split): block (r, s) streams its split of row
r with coalesced 16-byte loads (scalar loads where N % 4 != 0), a batch of
4096 scores (16 a thread) in flight while the previous one is filtered.
Each batch goes from registers through ``select.cuh``: only the scores
below the queue's worst pair are appended to a survivor buffer (1024
lanes), sorted, and merged into the row's queue by rank; shared memory
holds just the queue (two buffers of k_eff pairs) and that buffer. The
filter bites once the queue is full: of the L scores a block sees, about
k_eff·(1 + ln(L / k_eff)) survive on data in random order. S is chosen so
that the grid is at most two blocks per SM (floor(2·SMs / M) splits per
row, one wave): at (16, 1,000,000), k = 1024 on 132 SMs that is S = 16,
L ≈ 62,500, and about a twelfth of the scores survive (a quarter at
S = 66).
``knn_merge`` reduces the S sorted queues of each row. Neither M nor N need
be a multiple of a block: the kernel masks the ragged edge, so the scores
are never copied. Without pruning, the tile width bn only sets where the
splits begin (every split but the last covers whole bn-column tiles).

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.knn.kernel import (
    _BLOCK_SMEM_MAX,
    _SELECT_BOOK,
    _THREADS,
    LAUNCHES,
    _check_cuda,
    _raise_on,
    _resolve_splits,
    knn_merge,
    on_card,
    plain_queues,
    tiles_per_split,
)

_CAP = 1024  # survivor lanes of a block (a pass sorts at most this many)


def topk_smem_bytes(k_eff: int, cap: int = _CAP) -> int:
    """Shared memory of one block (``topk_smem_bytes`` in topk.cu):
    bookkeeping, two queue buffers of k_eff pairs, the survivor buffer."""
    return _SELECT_BOOK + k_eff * 16 + cap * 8


def topk_splits(m: int, n_tiles: int, device) -> int:
    """S for a grid of (M, S) blocks: about two blocks per SM, no split
    empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = min(n_tiles, 65535, max(1, 2 * sms // m))
    return -(-n_tiles // tiles_per_split(n_tiles, splits))


def _check(scores, k_eff, bn):
    if scores.ndim != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be (M, N) f32, got {scores.dtype} {tuple(scores.shape)}")
    if bn % _THREADS or bn & (bn - 1):
        raise ValueError(f"bn={bn} must be a power of two >= {_THREADS}")
    if k_eff & (k_eff - 1) or not 1 <= k_eff <= bn:
        raise ValueError(f"k_eff={k_eff} must be a power of two <= bn={bn}")


def topk_scan(scores, k_eff: int, bn: int, splits: int | None = None,
              return_stats: bool = False):
    """Per-split sorted queues, (M, S, k_eff) f32 values and i32 indices;
    split s covers the n-tiles [s·tps, (s+1)·tps) of bn columns.
    ``splits=None`` takes :func:`topk_splits`. ``return_stats=True`` (CUDA
    tensors only) adds the kernel's selection counters, (M, S, 4) i32:
    survivors, passes, comparisons of the survivor sorts, queue pairs
    moved."""
    _check(scores, k_eff, bn)
    if scores.device.type == "cpu":
        if return_stats:
            raise ValueError("selection counters come from the kernel: CUDA tensors only")
        return topk_scan_plain(scores, k_eff, bn, splits or 1)
    _check_cuda(scores)
    if topk_smem_bytes(k_eff) > _BLOCK_SMEM_MAX:
        raise ValueError(f"k_eff={k_eff}: the queue exceeds shared memory")
    from repro_torch.kernels.build import load_library

    m, n = scores.shape
    n_tiles = -(-n // bn)
    if splits is None:
        splits = topk_splits(m, n_tiles, scores.device)
    splits, tps = _resolve_splits(splits, n_tiles)
    out_v = torch.empty((m, splits, k_eff), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((m, splits, k_eff), dtype=torch.int32, device=scores.device)
    stats = (torch.zeros((m, splits, 4), dtype=torch.int32, device=scores.device)
             if return_stats else None)
    with on_card(scores.device):
        rc = load_library().topk_scan(
            scores.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            None if stats is None else stats.data_ptr(), m, n, k_eff, bn, splits, tps, _CAP,
            torch.cuda.current_stream(scores.device).cuda_stream)
    _raise_on(rc, "topk_scan")
    LAUNCHES["topk"] += 1
    return (out_v, out_i, stats) if return_stats else (out_v, out_i)


def topk_fused(scores, k_eff: int, bn: int):
    """(M, N) -> the (M, k_eff) sorted queues of the whole row."""
    if scores.device.type == "cpu":
        v, i = topk_scan_plain(scores, k_eff, bn, 1)
        return v[:, 0], i[:, 0]
    return knn_merge(*topk_scan(scores, k_eff, bn))


def topk_scan_plain(scores, k_eff: int, bn: int, splits: int = 1):
    """``topk_scan`` in torch ops: the scan's queue loop over score tiles
    read from the matrix, lanes past N as +inf, one row at a time (bm = 1:
    without pruning the row blocking does not change the result)."""
    _check(scores, k_eff, bn)
    m, n = scores.shape

    def tile(rows):  # (S, bn) column ids -> (M, S, bn) scores
        return torch.where(rows[None] < n, scores[:, rows.clamp(max=n - 1)], torch.inf)

    v, i, _ = plain_queues(tile, m, -(-n // bn), k_eff, 1, bn, False, splits, scores.device)
    return v, i
