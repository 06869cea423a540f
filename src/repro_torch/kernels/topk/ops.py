"""Public wrapper of the streaming top-k kernel."""
from __future__ import annotations

import torch

from repro_torch.core.partition import next_pow2
from repro_torch.kernels.topk.kernel import topk_fused


def topk(scores: torch.Tensor, k: int,
         block_n: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of (M, N) scores: (values, indices) sorted
    ascending, ties to the smaller index, -0.0 equal to +0.0.

    k rounds up to a power of two for the queue, then the result is sliced
    back; when k > N the missing slots are (+inf, -1). As in the TPU kernel,
    a +inf score never enters a queue, so it too reads as (+inf, -1).
    """
    n = scores.shape[1]
    k_eff = next_pow2(k)
    bn = max(block_n, k_eff)
    v, i = topk_fused(scores.to(torch.float32).contiguous(), k_eff, bn)
    v, i = v[:, :k], i[:, :k]
    return v, torch.where(i < n, i, -1)
