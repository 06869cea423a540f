"""Public wrappers of the fused kNN kernels (engine ``backend="cuda"``).

* :func:`knn`              — fused f32/bf16 scan (l2 | ip | cos). It pads
                             the inputs to the kernel's blocking, runs
                             :func:`~repro_torch.kernels.knn.kernel.knn_fused`
                             (the CUDA kernel on a CUDA tensor, its plain
                             version on a CPU tensor) and slices the
                             result. ``cos`` is served by pre-normalised
                             rows through the ip epilogue plus 1.
* :func:`knn_int8`         — fused int8 scan (1 B/element dataset reads)
                             with a widened candidate queue, then a
                             certified exact f32 rescore that reads only the
                             candidate rows.
* :func:`knn_exact_direct` — chunked exact scan in the direct (q - x)² form:
                             the bit-exact oracle of, and the fallback for,
                             the int8 tier.

The rescore and ``knn_exact_direct`` are plain torch ops, as they are XLA
ops outside any Pallas kernel in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distance import direct_l2_sq, row_norms_sq
from repro_torch.core.partition import LANE, next_pow2, round_up
from repro_torch.core.quantized import QuantizedDataset
from repro_torch.core.topk import TopK, sort_pairs, topk_smallest
from repro_torch.kernels.knn.kernel import (
    int8_max_block_m,
    knn_fused,
    knn_int8_fused,
    knn_int8_scan,
    knn_merge,
    knn_scan,
    max_block_m,
)

#: (bm, bn, bd) before the legality clamps of :func:`resolved_blocks`.
DEFAULT_BLOCKS = (128, 512, 512)


def resolved_blocks(
    k: int,
    d: int,
    block_m: int = DEFAULT_BLOCKS[0],
    block_n: int = DEFAULT_BLOCKS[1],
    block_d: int = DEFAULT_BLOCKS[2],
    m: int | None = None,
    rescore_factor: int | None = None,
) -> tuple[int, int, int]:
    """The (bm, bn, bd) the kernel actually runs after legality clamps.

    ``rescore_factor=None`` means the f32 kernel, whose queue is k_eff wide;
    an int means the int8 kernel, whose queue is
    q_len = 2·next_pow2(rescore_factor·k_eff) wide. bn grows to hold the
    queue. bd is the largest multiple of LANE that divides the padded dim
    and is <= block_d, so an aligned dataset is never copied to pad its
    dim. bm shrinks to the batch (``next_pow2(m)`` when m is given) and to
    the kernel's limit: both kernels keep their queues in device memory, so
    that is their scoring's 16 whatever the queue. On the card a row of
    padding queries is work thrown away.
    """
    k_eff = next_pow2(k)
    queue = k_eff if rescore_factor is None else int8_queue(k, rescore_factor)[1]
    bn = max(block_n, queue)
    dp = round_up(max(d, 1), LANE)
    bd = max(b for b in range(LANE, max(block_d, LANE) + 1, LANE) if dp % b == 0)
    bm = min(block_m, max_block_m() if rescore_factor is None else int8_max_block_m())
    if m is not None:
        bm = min(bm, next_pow2(m))
    bm = 1 << (bm.bit_length() - 1)  # the kernel's row blocks are powers of 2
    return bm, bn, bd


def int8_queue(k: int, rescore_factor: int) -> tuple[int, int]:
    """(r, q_len): the rescore budget r = next_pow2(rescore_factor·k_eff)
    and the int8 queue width q_len = 2r (entry r certifies)."""
    r = next_pow2(max(1, rescore_factor) * next_pow2(k))
    return r, 2 * r


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


def finish_queue(v: torch.Tensor, i: torch.Tensor, k: int, cos: bool) -> TopK:
    """A kernel queue as the (rows, k) result: cos scores get their +1 and
    every +inf score carries index -1."""
    v, i = v[:, :k], i[:, :k]
    if cos:
        v = v + 1.0  # -<q_hat, x_hat> -> cosine distance (+inf stays +inf)
    return TopK(v, torch.where(torch.isfinite(v), i, -1))


def finish(call: KernelCall, v: torch.Tensor, i: torch.Tensor) -> TopK:
    """Slice a kernel result back to (m, k) (:func:`finish_queue`)."""
    return finish_queue(v[: call.m], i[: call.m], call.k, call.cos)


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


# ------------------------------------------------------------------ int8
class Int8Call(NamedTuple):
    """The padded operands of one int8-kernel call."""

    q: torch.Tensor  # (mp, dp) f32
    qn: torch.Tensor  # (mp,) f32
    x8: torch.Tensor  # (n, dp) int8 — rows never padded (the kernel masks)
    scales: torch.Tensor  # (np,) f32, padded with 1
    err: torch.Tensor  # (np,) f32, padded with 0
    hn: torch.Tensor  # (np,) f32 exact quantised norms, +inf invalid/padded
    r: int
    q_len: int
    blocks: tuple[int, int, int]
    m: int
    k: int

    @property
    def merges(self) -> int:
        """Tile merges one sequential pass would attempt: m_tiles·n_tiles."""
        bm, bn, _ = self.blocks
        return (self.q.shape[0] // bm) * (self.hn.shape[0] // bn)


def _pad1(t: torch.Tensor, rows: int, value: float) -> torch.Tensor:
    t = t.to(torch.float32)
    if t.shape[0] == rows:
        return t.contiguous()
    return torch.cat([t, t.new_full((rows - t.shape[0],), value)])


def prepare_int8(
    q: torch.Tensor,
    ds: QuantizedDataset,
    k: int,
    rescore_factor: int = 4,
    block_m: int = DEFAULT_BLOCKS[0],
    block_n: int = DEFAULT_BLOCKS[1],
    block_d: int = DEFAULT_BLOCKS[2],
) -> Int8Call:
    """Pad and block the operands of :func:`knn_int8`. The channels keep the
    reference's padding (scales 1, err 0, hn +inf) and validity rides
    norms_sq, folded onto the exact quantised norms; the codes are padded
    only in d, and only when d is not already a multiple of bd."""
    m, d = q.shape
    n = ds.q.shape[0]
    r, q_len = int8_queue(k, rescore_factor)
    bm, bn, bd = resolved_blocks(k, d, block_m, block_n, block_d, m=m,
                                 rescore_factor=rescore_factor)
    mp, np_, dp = round_up(m, bm), round_up(n, bn), round_up(d, bd)
    qp = _pad2(q.to(torch.float32), mp, dp).contiguous()
    hn = torch.where(torch.isfinite(ds.norms_sq), ds.qnorm_sq.to(torch.float32), torch.inf)
    return Int8Call(qp, torch.sum(qp * qp, dim=-1), _pad2(ds.q, n, dp).contiguous(),
                    _pad1(ds.scales, np_, 1.0), _pad1(ds.err, np_, 0.0),
                    _pad1(hn, np_, torch.inf), r, q_len, (bm, bn, bd), m, k)


def rescore_certify(q: torch.Tensor, lb: torch.Tensor, li: torch.Tensor,
                    full_vectors: torch.Tensor, k: int, r: int) -> tuple[TopK, torch.Tensor]:
    """The certified exact rescore of a sorted (m, 2r) lower-bound queue.

    Gathers ONLY the r candidate rows of the f32 tier and scores them in the
    direct form (:func:`~repro_torch.core.distance.direct_l2_sq`, the same
    bits as :func:`knn_exact_direct` gives the pair). Certificate: the
    smallest lower bound OUTSIDE the candidates (queue entry r) must exceed
    the k-th smallest exact candidate distance; an infinite entry means the
    candidates already hold every valid row.
    """
    cand_idx = li[:, :r]
    cand_ok = cand_idx >= 0  # unfilled queue slots stay (inf, -1)
    exact_d = direct_l2_sq(q, full_vectors[torch.where(cand_ok, cand_idx, 0)])
    exact_d = torch.where(cand_ok, exact_d, torch.inf)
    s, i = sort_pairs(exact_d, cand_idx)  # lexicographic: exact tie order
    s, i = s[:, :k], i[:, :k]
    i = torch.where(torch.isfinite(s), i, -1)
    lb_r1 = lb[:, r]
    certificate = (lb_r1 > s[:, k - 1]) | ~torch.isfinite(lb_r1)
    return TopK(s, i), certificate


def knn_int8(
    q: torch.Tensor,
    ds: QuantizedDataset,
    full_vectors: torch.Tensor,
    k: int,
    rescore_factor: int = 4,
    block_m: int = DEFAULT_BLOCKS[0],
    block_n: int = DEFAULT_BLOCKS[1],
    block_d: int = DEFAULT_BLOCKS[2],
    prune: bool = True,
    return_stats: bool = False,
):
    """Exact kNN with a fused int8 first pass and a candidate-only rescore.

    The int8 scan keeps a widened queue of q_len = 2r certified lower bounds
    per query, r = next_pow2(rescore_factor·next_pow2(k)); then
    :func:`rescore_certify`. Returns (TopK, certificate (m,) bool), plus the
    pruning skip rate (skips / (m_tiles·n_tiles), a 0-d tensor) when
    ``return_stats=True``. q, ds.q and full_vectors share one padded width,
    ds.q and full_vectors one row count (the store guarantees both).
    """
    m, d = q.shape
    n, d8 = ds.q.shape
    if d != d8 or tuple(full_vectors.shape) != (n, d8):
        raise ValueError(
            f"geometry mismatch: q {tuple(q.shape)}, int8 {tuple(ds.q.shape)}, "
            f"f32 {tuple(full_vectors.shape)} (tiers must share padded shapes)")
    call = prepare_int8(q, ds, k, rescore_factor, block_m, block_n, block_d)
    bm, bn, _ = call.blocks
    lb, li, skips = knn_int8_fused(call.q, call.x8, call.qn, call.scales, call.err, call.hn,
                                   call.q_len, bm, bn, prune)
    out, cert = rescore_certify(q, lb[:m], li[:m], full_vectors, k, call.r)
    if not return_stats:
        return out, cert
    return out, cert, skips.sum().to(torch.float32) / call.merges


# --------------------------------------------------------- streamed shards
def merge_shard(v: torch.Tensor, i: torch.Tensor, sv: torch.Tensor, si: torch.Tensor,
                base_index: int, merge=knn_merge) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one shard's per-split sorted queues (m, S, w), indices local to
    the shard, into the running sorted (m, w0) queue (v, i), w0 <= w, with
    one :func:`knn_merge` (``merge``; ``knn_merge_plain`` gives the plain
    step): the indices move by ``base_index`` (an empty +inf slot keeps -1)
    and the running queue, padded with (+inf, -1) to width w, joins as
    split S + 1. Returns the (m, w) queue."""
    m, _, w = sv.shape
    si = torch.where(torch.isfinite(sv), si + base_index, -1)
    if v.shape[-1] < w:
        pad = w - v.shape[-1]
        v = torch.cat([v, v.new_full((m, pad), torch.inf)], -1)
        i = torch.cat([i, i.new_full((m, pad), -1)], -1)
    return merge(torch.cat([sv, v[:, None]], 1), torch.cat([si, i[:, None]], 1))


def knn_shard(v: torch.Tensor, i: torch.Tensor, q: torch.Tensor, x: torch.Tensor,
              x_norms: torch.Tensor, k: int, metric: str, base_index: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard of a streamed f32 scan on the kernels: ``knn_scan`` over
    the shard (its rows normalised by :func:`prepare` for cos), then
    :func:`merge_shard` into the running (m, next_pow2(k)) queue of kernel
    scores (ip form for cos: :func:`finish_queue` adds the 1). Two
    launches a shard; the same kernel scores every pair as a resident
    search does, and merging sorted queues is exact, so the streamed result
    is the resident one bit for bit."""
    call = prepare(q.to(x.dtype), x, k, metric, x_norms)
    bm, bn, _ = call.blocks
    qn = torch.sum(call.q.to(torch.float32) ** 2, dim=-1)
    sv, si, _ = knn_scan(call.q, call.x, qn, call.xn, call.k_eff, call.metric, bm, bn)
    return merge_shard(v, i, sv[: call.m], si[: call.m], base_index)


def int8_shard_operands(q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                        err: torch.Tensor, qnorm: torch.Tensor, r: int) -> tuple:
    """The arguments of ``knn_int8_scan`` (and its plain version) for one
    shard of a streamed int8 scan: (q, codes, qn, scales, err, hn, q_len,
    bm, bn) with q_len = next_pow2(r + 1), the queries padded to bm rows
    and the channels to the n-block (scales 1, err 0, hn +inf). ``qnorm``
    is the exact quantised norm with validity folded in (+inf invalid)."""
    m, d = q.shape
    q_len = next_pow2(r + 1)
    bm = min(int8_max_block_m(), next_pow2(m))
    bn = max(DEFAULT_BLOCKS[1], q_len)
    np_ = round_up(codes.shape[0], bn)
    qp = _pad2(q.to(torch.float32), round_up(m, bm), d).contiguous()
    return (qp, codes.contiguous(), torch.sum(qp * qp, dim=-1), _pad1(scales, np_, 1.0),
            _pad1(err, np_, 0.0), _pad1(qnorm, np_, torch.inf), q_len, bm, bn)


def knn_int8_shard(lb: torch.Tensor, li: torch.Tensor, q: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, err: torch.Tensor, qnorm: torch.Tensor,
                   base_index: int, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard of a streamed int8 scan on the kernels: ``knn_int8_scan``
    over the shard's codes (:func:`int8_shard_operands`), then
    :func:`merge_shard` into the running (m, r + 1) bound queue. Two
    launches a shard."""
    m = q.shape[0]
    sv, si, _ = knn_int8_scan(*int8_shard_operands(q, codes, scales, err, qnorm, r))
    v, i = merge_shard(lb, li, sv[:m], si[:m], base_index)
    return v[:, : r + 1], i[:, : r + 1]


def knn_exact_direct(q: torch.Tensor, x: torch.Tensor, norms: torch.Tensor, k: int,
                     chunk_rows: int = 8192) -> TopK:
    """Chunked exact kNN in the DIRECT (q - x)² form (l2 only).

    Every pairwise distance is :func:`~repro_torch.core.distance.direct_l2_sq`
    — the value, bit for bit, that :func:`rescore_certify` computes for the
    pair. Chunks merge lexicographically, so the result is a full-sort
    oracle over that formula whatever the chunking: the exactness fallback
    for uncertified int8 queries and the oracle the int8 tests compare
    against. ``norms`` carries validity (+inf on padding); N must be a
    multiple of chunk_rows.
    """
    m = q.shape[0]
    n = x.shape[0]
    if n % chunk_rows:
        raise ValueError(f"N={n} not a multiple of chunk_rows={chunk_rows}")
    s = torch.full((m, k), torch.inf, dtype=torch.float32, device=q.device)
    i = torch.full((m, k), -1, dtype=torch.int32, device=q.device)
    lanes = torch.arange(chunk_rows, dtype=torch.int32, device=q.device)
    for base in range(0, n, chunk_rows):
        dmat = direct_l2_sq(q, x[base: base + chunk_rows])
        dmat = torch.where(torch.isfinite(norms[base: base + chunk_rows])[None], dmat, torch.inf)
        s, i = topk_smallest(torch.cat([s, dmat], -1),
                             torch.cat([i, (base + lanes).expand(m, chunk_rows)], -1), k)
    return TopK(s, torch.where(torch.isfinite(s), i, -1))
