"""Plain oracle for the streaming top-k kernel: a full two-key sort."""
from __future__ import annotations

import torch

from repro_torch.core.topk import sort_pairs


def topk_ref(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row, sorted ascending, ties to the smaller index;
    rows shorter than k are padded with (+inf, -1).

    scores (M, N) -> (values (M, k) f32, indices (M, k) i32).
    """
    m, n = scores.shape
    idx = torch.arange(n, dtype=torch.int32, device=scores.device).expand(m, n)
    s, i = sort_pairs(scores, idx)
    if n >= k:
        return s[:, :k], i[:, :k]
    pad = k - n
    return (torch.cat([s, s.new_full((m, pad), torch.inf)], 1),
            torch.cat([i, i.new_full((m, pad), -1)], 1))
