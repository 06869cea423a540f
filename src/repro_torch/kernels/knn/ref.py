"""Plain oracle for the fused kNN kernel: dense scores + a full two-key sort."""
from __future__ import annotations

import torch

from repro_torch.core.topk import sort_pairs


def knn_ref(q: torch.Tensor, x: torch.Tensor, k: int,
            metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN from dense scores. (M, d), (N, d) -> (M, k) vals + idx."""
    q32, x32 = q.to(torch.float32), x.to(torch.float32)
    cross = q32 @ x32.T
    if metric == "l2":
        qn = torch.sum(q32 * q32, dim=-1, keepdim=True)
        xn = torch.sum(x32 * x32, dim=-1)
        s = torch.clamp_min(qn - 2.0 * cross + xn[None, :], 0.0)
    elif metric == "ip":
        s = -cross
    elif metric == "cos":
        qn = torch.sqrt(torch.sum(q32 * q32, dim=-1, keepdim=True))
        xn = torch.sqrt(torch.sum(x32 * x32, dim=-1))[None, :]
        s = 1.0 - cross / torch.clamp_min(qn * xn, 1e-30)
    else:
        raise ValueError(metric)
    m, n = s.shape
    idx = torch.arange(n, dtype=torch.int32, device=s.device).expand(m, n)
    sv, si = sort_pairs(s, idx)
    if n >= k:
        return sv[:, :k], si[:, :k]
    pad = k - n
    sv = torch.cat([sv, sv.new_full((m, pad), torch.inf)], dim=1)
    si = torch.cat([si, si.new_full((m, pad), -1)], dim=1)
    return sv, si
