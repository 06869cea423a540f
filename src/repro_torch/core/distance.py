"""Distance computation: "smaller is better" score matrices on torch tensors.

    ||x - q||^2 = ||x||^2 - 2 <x, q> + ||q||^2

The <x, q> term is one matrix product accumulated in f32 whatever the
input dtype (bf16 operands are widened first). These are the plain paths
(``backend="torch"``) and the oracles of the kernels in
``repro_torch.kernels``.
"""
from __future__ import annotations

from typing import Literal

import torch

Metric = Literal["l2", "ip", "cos"]

_SUPPORTED: tuple[str, ...] = ("l2", "ip", "cos")

#: Rows per pass of :func:`row_norms_sq`, so the squares of a dataset the
#: size of device memory never exist at once.
_NORM_CHUNK_ROWS = 1 << 16
_QUERY_BLOCK = 16  # rows of each torch.sum in query_norms_sq


def validate_metric(metric: str) -> None:
    if metric not in _SUPPORTED:
        raise ValueError(f"metric must be one of {_SUPPORTED}, got {metric!r}")


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """||x_i||^2 per row, in f32, computed a chunk of rows at a time and
    summed by :func:`sum_last_fixed`: a row's norm has the same bits on
    the host and on the card, whatever rows are computed beside it (a row
    upserted alone and the same row in a fresh fit)."""
    out = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    if x.shape[-1] == 0:
        return out
    flat, res = x.reshape(-1, x.shape[-1]), out.reshape(-1)
    for s in range(0, flat.shape[0], _NORM_CHUNK_ROWS):
        c = flat[s: s + _NORM_CHUNK_ROWS].to(torch.float32)
        res[s: s + _NORM_CHUNK_ROWS] = sum_last_fixed(c * c)
    return out


def query_norms_sq(q: torch.Tensor) -> torch.Tensor:
    """||q_i||^2 per row in f32, as the scans' epilogue takes it: one
    ``torch.sum`` a block of exactly ``_QUERY_BLOCK`` rows (the last one
    padded with zero rows), so every row is reduced in the order of one
    fixed shape whatever its batch. ``torch.sum``'s order on a card
    follows the number of rows (8 queries summed in a batch of 8 and of 16
    differ in the last bit), and a pair's scan score adds this norm, so
    without it a query's answer would depend on the queries beside it."""
    q = q.to(torch.float32)
    m = q.shape[0]
    mp = max(_QUERY_BLOCK, -(-m // _QUERY_BLOCK) * _QUERY_BLOCK)
    if mp != m:
        q = torch.cat([q, q.new_zeros((mp - m, q.shape[1]))])
    sq = q * q
    sums = [torch.sum(b, dim=-1) for b in sq.split(_QUERY_BLOCK)]
    return (sums[0] if len(sums) == 1 else torch.cat(sums))[:m]


def inner_product(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """<q, x> matrix, (M, d) x (N, d) -> (M, N), f32 accumulation."""
    return q.to(torch.float32) @ x.to(torch.float32).T


def l2_sq(q: torch.Tensor, x: torch.Tensor,
          x_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Squared euclidean distance matrix, (M, d) x (N, d) -> (M, N)."""
    q32 = q.to(torch.float32)
    qn = torch.sum(q32 * q32, dim=-1, keepdim=True)  # (M, 1)
    xn = row_norms_sq(x) if x_norms is None else x_norms.to(torch.float32)
    d = qn - 2.0 * inner_product(q, x) + xn[None, :]
    # tiny negatives from cancellation; distances are >= 0
    return torch.clamp_min(d, 0.0)


def sum_last_fixed(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order: pairwise halving
    (columns i and i + h added, an odd last column folded into column 0).

    Every step is an elementwise add, so each result depends only on its
    own row's values, never on the other axes' sizes; ``torch.sum``'s order
    on a card may change with the outer size. ``t`` may be overwritten.
    """
    while t.shape[-1] > 1:
        n = t.shape[-1]
        h = n // 2
        s = t[..., :h] + t[..., h:2 * h]
        if n % 2:
            s[..., 0] += t[..., 2 * h]
        t = s
    return t[..., 0]


def direct_l2_sq(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared L2 in the direct form, sum((q - x)²), summed by
    :func:`sum_last_fixed`: q (M, d) against shared rows (R, d) or per-query
    rows (M, R, d) -> (M, R) f32. The same (query, row) pair gives the same
    bits whichever rows surround it — the int8 tier's rescore and its exact
    oracle both go through here."""
    rows = rows.to(torch.float32)
    diff = q.to(torch.float32)[:, None, :] - (rows[None] if rows.ndim == 2 else rows)
    return sum_last_fixed(diff.mul_(diff))


def cosine_distance(q: torch.Tensor, x: torch.Tensor,
                    x_norms: torch.Tensor | None = None) -> torch.Tensor:
    """1 - cos(q, x); zero vectors map to distance 1."""
    ip = inner_product(q, x)
    qn = torch.sqrt(row_norms_sq(q))[:, None]
    xn = torch.sqrt(row_norms_sq(x) if x_norms is None
                    else x_norms.to(torch.float32))
    denom = torch.clamp_min(qn * xn[None, :], 1e-30)
    return 1.0 - ip / denom


def pairwise_scores(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: Metric = "l2",
    x_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Uniform "smaller is better" score matrix for any supported metric.

    l2 -> squared distance; ip -> negated inner product; cos -> cosine
    distance.
    """
    validate_metric(metric)
    if metric == "l2":
        return l2_sq(q, x, x_norms)
    if metric == "ip":
        return -inner_product(q, x)
    return cosine_distance(q, x, x_norms)
