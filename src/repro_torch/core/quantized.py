"""Int8-quantised distance scan with exact rescoring (paper section 5).

The paper names quantisation as the lever to raise FQ-SD throughput, at the
cost of approximation. Here the final answer stays EXACT:

1. Symmetric per-vector int8 quantisation: x ~= s_x * q_x, q_x in [-127,127].
2. The scan computes approximate squared-L2 from the int8 codes widened to
   f32 (a quarter of the f32 dataset's bytes; on the card the f32 FMAs, not
   the bytes, then bound a 16-query batch — see PERF.md).
3. Per-pair error bound: for x = s_x q_x + e_x the scan computes
   d_hat = ||q - x_hat||^2 EXACTLY (the quantised norm ||x_hat||^2 is
   stored, not approximated), then brackets the true distance with the
   reverse-triangle bound below.
4. Candidate filter: keep every row whose LOWER bound is <= the k-th smallest
   UPPER bound; rescore candidates in f32; take exact top-k. A boolean
   certificate reports whether the static rescore budget covered the
   candidate set; rows it does not cover are recomputed exactly by the
   executors.

Bound derivation (squared L2): d(q,x) = ||q - x||^2 with x = x_hat + e,
x_hat = s_x q_x, and d_hat = ||q - x_hat||^2 computed exactly from the
stored quantised norm ||x_hat||^2 = s_x^2 ||q_x||^2:
  sqrt(d) = ||(q - x_hat) - e||  =>  |sqrt(d) - sqrt(d_hat)| <= ||e||
  =>  max(sqrt(d_hat) - err_x, 0)^2 <= d <= (sqrt(d_hat) + err_x)^2
with err_x >= ||e_x|| the stored per-row error norm. The quantised norm
must be exact: substituting ||x||^2 - err^2 for it drops the cross term
2<x_hat, e>, which reaches 2*||x||*err when the quantisation error aligns
with the row direction — lower bounds then overshoot true distances and
the filter silently prunes true neighbours while still certifying.

The bracket is sound in real arithmetic; d_hat itself is evaluated in f32
via the cancellation form qn - 2<q,x_hat> + ||x_hat||^2, so the certified
claim (like every exactness claim of the system, the oracle included) is
modulo f32 rounding of order ||q||^2 * 2^-24. That is also why f32 stays
IEEE on the card: no TF32 in any product here.

The codes are widened to f32 before every product (the reference's XLA path
casts them to bf16, which is exact for int8 values; f32 is exact too).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distance import direct_l2_sq
from repro_torch.core.topk import TopK, sort_pairs, topk_smallest

#: Rows quantised per pass: the f32 temporaries of one pass stay a few
#: hundred MB whatever the dataset's size.
QUANT_CHUNK_ROWS = 1 << 16


class QuantizedDataset(NamedTuple):
    q: torch.Tensor  # (N, d) int8
    scales: torch.Tensor  # (N,) f32
    err: torch.Tensor  # (N,) f32 — certified ||e_x|| upper bound
    norms_sq: torch.Tensor  # (N,) f32 — exact f32 row norms: the validity
    #                         channel. +inf marks an invalid row (padding):
    #                         masked out of bounds, candidates and rescore.
    qnorm_sq: torch.Tensor  # (N,) f32 — EXACT quantised norm ||x_hat||^2 =
    #                         s_x^2 * ||q_x||^2 (not derived from norms_sq,
    #                         or the bounds lose soundness — see above).


class Int8Partition(NamedTuple):
    """One streamed shard of the int8 tier: the multi-array partition the
    double buffer ships in one slot (1 B/element codes plus 12 B/row of f32
    side channels instead of 4 B/element f32 rows).

    ``qnorm`` is the exact quantised norm ``||x_hat||^2`` with validity
    folded in: +inf on padding and filter-masked rows, so the scan step
    needs one channel. ``n_valid``/``base_index`` stay host scalars.
    """

    q: torch.Tensor  # (padded_rows, padded_dim) int8 codes
    scales: torch.Tensor  # (padded_rows,) f32
    err: torch.Tensor  # (padded_rows,) f32 — certified ||e_x|| upper bound
    qnorm: torch.Tensor  # (padded_rows,) f32 — exact ||x_hat||^2; +inf invalid
    n_valid: int
    base_index: int

    def scan_bytes(self) -> int:
        """Bytes one streamed pass moves for this shard: int8 codes plus
        the three per-row f32 channels (scales, err, qnorm)."""
        rows = int(self.q.shape[0])
        return rows * int(self.q.shape[1]) + 12 * rows


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest f32 (IEEE), on any device. torch's CPU
    kernel is not correctly rounded; an f64 root rounded to f32 is, since
    53 >= 2·24 + 2 bits. The bounds need the reference's and the card's
    ``__fsqrt_rn`` bits."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def quantized_norm_sq(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """EXACT ||x_hat||^2 = s_x^2 * sum(q_x^2) of the dequantised rows: one
    formula for every QuantizedDataset producer."""
    qf = q.to(torch.float32)
    s = scales.to(torch.float32)
    return (s * s) * torch.sum(qf * qf, dim=-1)


def quantize_dataset(x: torch.Tensor, chunk_rows: int = QUANT_CHUNK_ROWS) -> QuantizedDataset:
    """Quantise (N, d) rows on their own device, ``chunk_rows`` at a time:
    a whole-array pass over a dataset the size of device memory would make
    a second full-size f32 temporary."""
    n, d = x.shape
    dev = x.device
    codes = torch.empty((n, d), dtype=torch.int8, device=dev)
    scales, err, norms, qnorm = (torch.empty(n, dtype=torch.float32, device=dev)
                                 for _ in range(4))
    for s in range(0, n, chunk_rows):
        x32 = x[s: s + chunk_rows].to(torch.float32)
        absmax = torch.amax(torch.abs(x32), dim=-1)
        sc = torch.where(absmax > 0, absmax / 127.0, 1.0)
        c = torch.clamp(torch.round(x32 / sc[:, None]), -127, 127)
        # exact per-row quantisation error (tighter than the sqrt(d)/2 worst case)
        e = x32 - c * sc[:, None]
        codes[s: s + chunk_rows] = c.to(torch.int8)
        scales[s: s + chunk_rows] = sc
        err[s: s + chunk_rows] = sqrt_rn(torch.sum(e * e, dim=-1))
        norms[s: s + chunk_rows] = torch.sum(x32 * x32, dim=-1)
        qnorm[s: s + chunk_rows] = quantized_norm_sq(c, sc)
    return QuantizedDataset(codes, scales, err, norms, qnorm)


def _approx_l2(qv: torch.Tensor, ds: QuantizedDataset) -> torch.Tensor:
    """d_hat = ||q - x_hat||^2 from the int8 codes (f32 queries), exact up
    to f32 rounding because qnorm_sq is the true ||x_hat||^2."""
    q32 = qv.to(torch.float32)
    qn = torch.sum(q32 * q32, dim=-1, keepdim=True)
    cross = (q32 @ ds.q.to(torch.float32).T) * ds.scales[None, :]
    return torch.clamp_min(qn - 2.0 * cross + ds.qnorm_sq[None, :], 0.0)


def int8_lower_bounds(queries, codes, scales, err, qnorm, base: int = 0):
    """Certified lower bounds of one int8 shard against a query batch:
    ``(lower, idx)`` with ``lower`` the (m, n) reverse-triangle lower bounds
    (+inf on invalid rows, i.e. non-finite ``qnorm``) and ``idx`` the (n,)
    global row ids (-1 on invalid rows)."""
    n = codes.shape[0]
    q32 = queries.to(torch.float32)
    qn = torch.sum(q32 * q32, dim=-1, keepdim=True)
    cross = (q32 @ codes.to(torch.float32).T) * scales[None, :]
    d_hat = torch.clamp_min(qn - 2.0 * cross + qnorm[None, :], 0.0)
    valid = torch.isfinite(qnorm)
    t = torch.clamp_min(sqrt_rn(d_hat) - err[None, :], 0.0)
    lower = torch.where(valid[None, :], t * t, torch.inf)
    idx = torch.where(valid, base + torch.arange(n, dtype=torch.int32, device=codes.device),
                      -1).to(torch.int32)
    return lower, idx


def make_int8_bound_step(r: int, backend: str = "torch"):
    """The step of the streamed int8 scan: insert one int8 shard's certified
    lower bounds into the running (m, r+1) candidate queue.

    The queue is one entry wider than the rescore budget ``r`` so the
    epilogue can read the smallest lower bound OUTSIDE the candidates
    (entry r) for the certificate. Invalid rows (+inf ``qnorm``) carry
    index -1. With ``backend="cuda"`` the step is the int8 scan kernel
    and one ``knn_merge`` (``kernels.knn.ops.knn_int8_shard``; their plain
    versions on a CPU tensor); otherwise plain ops. Both keep the queue in
    lexicographic (bound, index) order, so among equal bounds at the queue's
    boundary the smaller index stays (the reference's ``lax.top_k`` keeps
    either): the bound values, and so the certificate, are the same.

    Returns fn(lb, li, queries, codes, scales, err, qnorm, base) -> (lb, li).
    """
    if r < 1:
        raise ValueError(f"rescore budget r must be >= 1, got {r}")
    if backend == "cuda":
        from repro_torch.kernels.knn.ops import knn_int8_shard

        def kernel_step(lb, li, queries, codes, scales, err, qnorm, base):
            return knn_int8_shard(lb, li, queries, codes, scales, err, qnorm, int(base), r)

        return kernel_step

    def step(lb, li, queries, codes, scales, err, qnorm, base):
        lower, idx = int8_lower_bounds(queries, codes, scales, err, qnorm, int(base))
        s_loc, i_loc = topk_smallest(lower, idx.expand(lower.shape), r + 1)
        s, i = sort_pairs(torch.cat([lb, s_loc], -1), torch.cat([li, i_loc], -1))
        return s[:, : r + 1], i[:, : r + 1]

    return step


def knn_quantized(queries: torch.Tensor, ds: QuantizedDataset, full_vectors: torch.Tensor,
                  k: int, rescore_factor: int = 4) -> tuple[TopK, torch.Tensor]:
    """Exact kNN with an int8 first pass and an f32 rescore, in plain ops.

    Returns (topk, certificate): certificate[i] is True iff the rescore
    budget provably covered every candidate that could belong to query i's
    true top-k (the bracket above). The rescore is the direct form of
    :func:`~repro_torch.core.distance.direct_l2_sq`, so a certified row is
    bit-identical to ``knn_exact_direct`` over the same rows.
    """
    m = queries.shape[0]
    n = ds.q.shape[0]
    r = min(n, rescore_factor * k)

    valid = torch.isfinite(ds.norms_sq)  # False on padding
    root = sqrt_rn(_approx_l2(queries, ds))  # ||q - x_hat||
    e = ds.err[None, :]
    # reverse-triangle bracket around the true distance (module docstring)
    lo = torch.clamp_min(root - e, 0.0)
    hi = root + e
    lower = torch.where(valid[None, :], lo * lo, torch.inf)
    upper = torch.where(valid[None, :], hi * hi, torch.inf)

    idx = torch.arange(n, dtype=torch.int32, device=ds.q.device).expand(m, n)
    # k-th smallest upper bound = certified pruning threshold
    thresh = topk_smallest(upper, idx, k)[0][:, -1]
    # candidates: r smallest lower bounds; the certificate reads the
    # (r+1)-th: every row OUTSIDE the candidates must be provably worse.
    # An infinite (r+1)-th bound means the candidates hold every valid row.
    if r < n:
        lb, li = topk_smallest(lower, idx, r + 1)
        certificate = (lb[:, -1] > thresh) | ~torch.isfinite(lb[:, -1])
        cand_idx = li[:, :r]
    else:
        cand_idx = topk_smallest(lower, idx, r)[1]
        certificate = torch.ones((m,), dtype=torch.bool, device=ds.q.device)

    # exact f32 rescore of the candidates (invalid rows reach the candidate
    # set only when fewer than r valid rows exist; they are masked here)
    exact_d = direct_l2_sq(queries, full_vectors[cand_idx])  # (M, r)
    cand_ok = (cand_idx >= 0) & valid[cand_idx]
    exact_d = torch.where(cand_ok, exact_d, torch.inf)
    s, i = topk_smallest(exact_d, cand_idx, k)
    i = torch.where(torch.isfinite(s), i, -1)  # empty queue slots drain as -1
    return TopK(s, i), certificate
