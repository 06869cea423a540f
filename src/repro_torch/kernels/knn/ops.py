"""Public wrapper of the fused kNN kernel (engine ``backend="cuda"``).

:func:`knn` pads the inputs to the kernel's blocking, runs the fused scan
(:func:`repro_torch.kernels.knn.kernel.knn_fused`: the CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor), and slices the result.
``cos`` is served by pre-normalised rows through the ip epilogue plus 1,
so every metric runs through one kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distance import row_norms_sq
from repro_torch.core.partition import LANE, next_pow2, round_up
from repro_torch.core.topk import TopK
from repro_torch.kernels.knn.kernel import knn_fused, max_block_m

#: (bm, bn, bd) before the legality clamps of :func:`resolved_blocks`.
DEFAULT_BLOCKS = (128, 512, 512)


def resolved_blocks(
    k: int,
    d: int,
    block_m: int = DEFAULT_BLOCKS[0],
    block_n: int = DEFAULT_BLOCKS[1],
    block_d: int = DEFAULT_BLOCKS[2],
    m: int | None = None,
) -> tuple[int, int, int]:
    """The (bm, bn, bd) the kernel actually runs after legality clamps.

    bn grows to hold the k_eff-wide queue. bd is the largest multiple of
    LANE that divides the padded dim and is <= block_d, so an aligned
    dataset is never copied to pad its dim. bm shrinks to the batch
    (``next_pow2(m)`` when m is given) and to what one block's shared
    memory holds beside a (bm, bn) tile and a (bm, k_eff) queue; on the
    card a row of padding queries is work thrown away.
    """
    k_eff = next_pow2(k)
    bn = max(block_n, k_eff)
    dp = round_up(max(d, 1), LANE)
    bd = max(b for b in range(LANE, max(block_d, LANE) + 1, LANE) if dp % b == 0)
    bm = min(block_m, max_block_m(k_eff, bn))
    if m is not None:
        bm = min(bm, next_pow2(m))
    bm = 1 << (bm.bit_length() - 1)  # the kernel's row blocks are powers of 2
    return bm, bn, bd


class KernelCall(NamedTuple):
    """The padded operands of one fused-kernel call and how to undo them."""

    q: torch.Tensor  # (mp, dp), x's dtype
    x: torch.Tensor  # (np, dp)
    xn: torch.Tensor  # (np,) f32, +inf on padded / excluded rows
    k_eff: int
    metric: str  # the kernel's metric: "l2" or "ip"
    blocks: tuple[int, int, int]
    m: int  # true query rows
    k: int  # requested k
    cos: bool  # scores get the cos epilogue (+1)

    @property
    def merges(self) -> int:
        """Tile merges one sequential pass would attempt: m_tiles·n_tiles."""
        bm, bn, _ = self.blocks
        return (self.q.shape[0] // bm) * (self.x.shape[0] // bn)


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    out = t.new_zeros((rows, cols))
    out[: t.shape[0], : t.shape[1]] = t
    return out


def prepare(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    x_norms: torch.Tensor | None = None,
    block_m: int = DEFAULT_BLOCKS[0],
    block_n: int = DEFAULT_BLOCKS[1],
    block_d: int = DEFAULT_BLOCKS[2],
    x_prenormalized: bool = False,
) -> KernelCall:
    """Normalise (cos), pad and block the operands of :func:`knn`."""
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"fused kernel supports l2|ip|cos, got {metric}")
    xn = row_norms_sq(x) if x_norms is None else x_norms.to(torch.float32)
    kernel_metric = metric
    if metric == "cos":
        # pre-normalise rows and reuse the ip epilogue. Zero rows and padded
        # rows (norm +inf) both become zero vectors -> ip 0 -> distance 1;
        # padded rows stay masked by xn = +inf.
        q32 = q.to(torch.float32)
        qn_row = torch.sqrt(torch.sum(q32 * q32, dim=-1, keepdim=True))
        q = torch.where(qn_row > 0, q32 / torch.clamp_min(qn_row, 1e-30), 0.0)
        if not x_prenormalized:
            xn_row = torch.sqrt(xn)[:, None]
            x = torch.where(torch.isfinite(xn_row) & (xn_row > 0),
                            x.to(torch.float32) / torch.clamp_min(xn_row, 1e-30), 0.0)
        else:
            # a resident pre-normalised view keeps its storage dtype; the
            # kernel takes q and x of one dtype, so q follows x
            q = q.to(x.dtype)
        kernel_metric = "ip"
    m, d = q.shape
    n = x.shape[0]
    bm, bn, bd = resolved_blocks(k, d, block_m, block_n, block_d, m=m)
    mp, np_, dp = round_up(m, bm), round_up(n, bn), round_up(d, bd)
    xn_p = xn if n == np_ else torch.cat(
        [xn, xn.new_full((np_ - n,), torch.inf)])
    return KernelCall(_pad2(q, mp, dp).contiguous(), _pad2(x, np_, dp).contiguous(),
                      xn_p.contiguous(), next_pow2(k), kernel_metric, (bm, bn, bd), m, k,
                      metric == "cos")


def finish(call: KernelCall, v: torch.Tensor, i: torch.Tensor) -> TopK:
    """Slice a kernel result back to (m, k); cos scores get their +1 and
    every +inf score carries index -1."""
    v, i = v[: call.m, : call.k], i[: call.m, : call.k]
    if call.cos:
        v = v + 1.0  # -<q_hat, x_hat> -> cosine distance (+inf stays +inf)
    return TopK(v, torch.where(torch.isfinite(v), i, -1))


def knn(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    x_norms: torch.Tensor | None = None,
    block_m: int = DEFAULT_BLOCKS[0],
    block_n: int = DEFAULT_BLOCKS[1],
    block_d: int = DEFAULT_BLOCKS[2],
    prune: bool = True,
    return_stats: bool = False,
    x_prenormalized: bool = False,
):
    """Exact kNN of (M, d) queries over an (N, d) dataset -> TopK((M,k),(M,k)).

    Handles all padding: d zero-padded, N padded with +inf-norm rows, k
    rounded up to a power of two for the queue then sliced. Given
    ``x_norms`` (engine-resident datasets carry them), padded and excluded
    rows must already be +inf. ``x_prenormalized=True`` says the dataset
    rows are already L2-normalised for cos (done once at fit time);
    ``x_norms`` stays the raw-norm validity channel either way. With
    ``return_stats=True`` returns (TopK, skip_rate), skip_rate = pruned
    tile merges / (m_tiles·n_tiles), a 0-d tensor.
    """
    call = prepare(q, x, k, metric, x_norms, block_m, block_n, block_d, x_prenormalized)
    bm, bn, bd = call.blocks
    v, i, skips = knn_fused(call.q, call.x, call.xn, call.k_eff, call.metric, bm, bn, bd,
                            prune)
    out = finish(call, v, i)
    if not return_stats:
        return out
    return out, skips.sum().to(torch.float32) / call.merges
