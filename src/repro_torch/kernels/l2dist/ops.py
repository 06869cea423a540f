"""Public wrapper of the l2dist kernel: norms and padding."""
from __future__ import annotations

import torch

from repro_torch.core.distance import row_norms_sq
from repro_torch.core.partition import pad_dim, round_up
from repro_torch.kernels.knn.kernel import _DEPTH
from repro_torch.kernels.l2dist.kernel import l2dist_tiles


def l2dist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix, any (M, d) x (N, d) -> (M, N) f32.

    q and x share one dtype (f32 or bf16). The f32 row norms come from the
    rows as given; d is zero-padded to the kernel's 32-feature slices (zeros
    add exactly 0 to every term), which copies the operands only when d is
    not already a multiple of 32. M and N are never padded: the kernel
    masks its ragged edge.
    """
    if q.dtype != x.dtype:
        raise ValueError(f"operand dtypes must match, got {q.dtype} vs {x.dtype}")
    dp = round_up(q.shape[1], _DEPTH)
    return l2dist_tiles(pad_dim(q, dp).contiguous(), pad_dim(x, dp).contiguous(),
                        row_norms_sq(q), row_norms_sq(x))
