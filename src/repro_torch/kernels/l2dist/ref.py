"""Plain oracle for the l2dist kernel."""
from __future__ import annotations

import torch


def l2dist_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance matrix, (M, d) x (N, d) -> (M, N) f32."""
    q32, x32 = q.to(torch.float32), x.to(torch.float32)
    qn = torch.sum(q32 * q32, dim=-1, keepdim=True)
    xn = torch.sum(x32 * x32, dim=-1)
    return torch.clamp_min(qn - 2.0 * (q32 @ x32.T) + xn[None, :], 0.0)
