"""The plain reference: exact k nearest neighbours by L2, in blocks.

Plain PyTorch, independent of the program: it makes each block of rows
again from the seed (data.py), works out its own norms, and computes every
distance in float64 as |q|^2 + |x|^2 - 2 q.x. The f32 rows are exact in
float64, so its distances are exact to about 1e-16 of |q|^2 + |x|^2, far
below the program's f32 rounding. Order: ascending distance, ties to the
smaller id (a stable sort over rows kept in id order).

:func:`lower_precision` is the control: the same search with the cross
term q.x in TF32, the precision below the configuration's f32 (on a card
through cuBLAS with TF32 allowed; on the CPU by rounding both operands to
TF32's 10-bit mantissa, which is what the card's TF32 product does).
"""
from __future__ import annotations

import torch

from knnbench import data


def _require_l2(cfg: dict) -> None:
    if cfg["metric"] != "l2":
        raise ValueError(f"the reference computes L2 distances; the configuration states "
                         f"metric {cfg['metric']!r} (inner product is served as L2 through "
                         f"ip_as_l2)")


def _sorted_merge(run_d, run_i, d, ids, k):
    """The k smallest of (run, block), ties to the smaller id: the running
    queue holds smaller ids than the block, and the sort is stable."""
    vals = torch.cat([run_d, d], dim=1)
    idx = torch.cat([run_i, ids.expand(d.shape[0], -1)], dim=1)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals[:, :k].contiguous(), torch.gather(idx, 1, order[:, :k])


def exact(cfg: dict, seed: int, queries: torch.Tensor, k: int,
          judge_ids: torch.Tensor | None = None) -> dict:
    """Exact search of ``queries`` (Q, d) over the configuration's rows.

    Returns ``dist`` (Q, k) float64 ascending and ``ids`` (Q, k) int64, the
    true k nearest; ``judged`` (Q, kk) float64, the exact distance of each
    id in ``judge_ids`` (Q, kk) (NaN where an id lies outside the rows); and
    ``scale`` (Q,) float64, |q|^2 plus the rows' mean |x|^2, the size of the
    terms an f32 distance rounds.
    """
    _require_l2(cfg)
    dev = queries.device
    q = queries.to(torch.float64)
    qn = (q * q).sum(1)
    Q = q.shape[0]
    run_d = torch.empty(Q, 0, dtype=torch.float64, device=dev)
    run_i = torch.empty(Q, 0, dtype=torch.int64, device=dev)
    judged = None
    if judge_ids is not None:
        judge_ids = judge_ids.to(dev, torch.int64)
        judged = torch.full(judge_ids.shape, float("nan"), dtype=torch.float64, device=dev)
    cent = data.centres(cfg, seed, dev)
    m2 = data.max_norm_sq(cfg, seed, cent) if cfg.get("ip_as_l2") else None
    rows = data.mixture(cfg)["block_rows"]
    norm_sum = torch.zeros((), dtype=torch.float64, device=dev)
    for b in range(data.n_blocks(cfg)):
        x = data.block(cfg, seed, b, cent, m2).to(torch.float64)
        xn = (x * x).sum(1)
        norm_sum += xn.sum()
        d = qn[:, None] + xn[None, :] - 2.0 * (q @ x.T)
        lo = b * rows
        ids = torch.arange(lo, lo + x.shape[0], device=dev)
        if judge_ids is not None:
            inside = (judge_ids >= lo) & (judge_ids < lo + x.shape[0])
            local = (judge_ids - lo).clamp(0, x.shape[0] - 1)
            judged = torch.where(inside, torch.gather(d, 1, local), judged)
        run_d, run_i = _sorted_merge(run_d, run_i, d, ids[None, :], k)
        del x, d
    return {"dist": run_d, "ids": run_i, "judged": judged,
            "scale": qn + norm_sum / cfg["n"]}


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10-bit mantissa, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def lower_precision(cfg: dict, seed: int, queries: torch.Tensor, k: int):
    """The control: the reference's search with the cross term in TF32 and
    the rest in f32; returns (scores (Q, k) f32, ids (Q, k) int64)."""
    _require_l2(cfg)
    dev = queries.device
    q = queries.to(torch.float32)
    qn = (q * q).sum(1)
    Q = q.shape[0]
    run_d = torch.empty(Q, 0, device=dev)
    run_i = torch.empty(Q, 0, dtype=torch.int64, device=dev)
    cent = data.centres(cfg, seed, dev)
    m2 = data.max_norm_sq(cfg, seed, cent) if cfg.get("ip_as_l2") else None
    rows = data.mixture(cfg)["block_rows"]
    on_card = dev.type == "cuda"
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = on_card
        for b in range(data.n_blocks(cfg)):
            x = data.block(cfg, seed, b, cent, m2)
            xn = (x * x).sum(1)
            cross = q @ x.T if on_card else _tf32(q) @ _tf32(x).T
            d = qn[:, None] + xn[None, :] - 2.0 * cross
            lo = b * rows
            ids = torch.arange(lo, lo + x.shape[0], device=dev)
            run_d, run_i = _sorted_merge(run_d, run_i, d, ids[None, :], k)
            del x, d, cross
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return run_d, run_i
