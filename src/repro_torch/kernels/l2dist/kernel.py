"""Squared-L2 distance matrix on Hopper.

Replaces ``repro/kernels/l2dist/kernel.py::l2dist_pallas``
(``_l2dist_kernel``); the CUDA source is ``../csrc/l2dist.cu`` (with the
staged loads of ``../csrc/tile.cuh``).

What it computes, as the TPU kernel does: D[i, j] = max((acc + qn_i) + xn_j,
0) with acc = -2·<q_i, x_j> accumulated in f32, for f32 or bf16 operands
(bf16 widened on load). The product is the kernel's own: no library GEMM,
no tensor cores, no TF32.

Design. Both grid axes are parallel, as on the TPU: block (j, i) computes a
(bm, 256) tile, one dataset row per thread with bm accumulators, over
32-feature slices of its rows and of the bm queries staged in shared
memory. Neither M nor N need be a multiple of the tile; d must be a
multiple of 32 (``ops.l2dist`` pads it).

Bound on this card: the kernel reads x once (N·d bytes per element) and
writes the (M, N) f32 matrix; at the main path's shape (M = 16, N = 1e6,
d = 960, f32) that is 3.9 GB, bound by bytes (the 2·M·N·d FLOPs take less
than half as long at the f32 non-tensor peak). It does not yet overlap loads
with compute.

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.partition import next_pow2
from repro_torch.kernels.knn.kernel import (
    _BLOCK_ROWS,
    _DEPTH,
    LAUNCHES,
    _check_cuda,
    _raise_on,
)


def block_m(m: int) -> int:
    """Query rows per block: the batch rounded up to a power of two, at most
    16 (a padding row is work thrown away)."""
    return min(_BLOCK_ROWS[-1], next_pow2(m))


def _check(q, x, qn, xn):
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and x {tuple(x.shape)} must be (M, d), (N, d)")
    if q.dtype != x.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q and x must both be f32 or both bf16, got {q.dtype}, {x.dtype}")
    for name, t, rows in (("qn", qn, q.shape[0]), ("xn", xn, x.shape[0])):
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 of shape ({rows},), got {t.dtype} "
                             f"{tuple(t.shape)}")


def l2dist_tiles(q, x, qn, xn):
    """(M, d) x (N, d) -> (M, N) f32 squared L2 from the given f32 row norms
    qn (M,) and xn (N,)."""
    _check(q, x, qn, xn)
    if q.device.type == "cpu":
        return l2dist_plain(q, x, qn, xn)
    _check_cuda(q, x, qn, xn)
    m, n, d = q.shape[0], x.shape[0], q.shape[1]
    if d % _DEPTH:
        raise ValueError(f"d={d} must be a multiple of {_DEPTH}")
    bm = block_m(m)
    if -(-m // bm) > 65535:
        raise ValueError(f"M={m} exceeds the grid's {65535 * bm} rows")
    from repro_torch.kernels.build import load_library

    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    rc = load_library().l2dist(
        q.data_ptr(), x.data_ptr(), qn.data_ptr(), xn.data_ptr(), out.data_ptr(), m, n, d,
        bm, int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "l2dist")
    LAUNCHES["l2dist"] += 1
    return out


def l2dist_plain(q, x, qn, xn):
    """The kernel's function in torch ops, rounded in its order:
    max((-2·cross + qn) + xn, 0)."""
    _check(q, x, qn, xn)
    acc = -2.0 * (q.to(torch.float32) @ x.to(torch.float32).T)
    return torch.clamp_min((acc + qn[:, None]) + xn[None, :], 0.0)
