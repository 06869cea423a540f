"""The card's peaks and the least time an exact search can take.

NVIDIA H100 SXM data sheet (dense, no sparsity): 3.35 TB/s of HBM3 and
67 TFLOP/s of f32 outside the tensor cores. The f32 scan is IEEE f32 (no
TF32), so the f32 peak is its ceiling.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32_BYTES = 4
ID_BYTES = 4  # the answers' ids are int32


def search_bytes(n: int, d: int, m: int, k: int) -> int:
    """The dataset's unpadded rows read once, the queries read, the answers
    (distance and id) written."""
    return F32_BYTES * n * d + F32_BYTES * m * d + (F32_BYTES + ID_BYTES) * m * k


def search_flops(n: int, d: int, m: int) -> int:
    """One multiply-add per query, row and coordinate."""
    return 2 * m * n * d


def search_bound_s(n: int, d: int, m: int, k: int) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the f32 peak: no search of m queries can take less on this card."""
    return max(search_bytes(n, d, m, k) / HBM_BYTES_PER_S,
               search_flops(n, d, m) / F32_FLOPS)
