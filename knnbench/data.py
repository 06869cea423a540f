"""The rows and queries of a cell, made from ``--seed``.

Rows follow a Gaussian mixture (the configuration's centres, then each row
a centre plus noise drawn from the seed), so a query's neighbours cluster as
they do among real descriptors.
Block ``b`` of the rows depends on (seed, b) alone: the reference makes any
block again instead of holding a second copy of the dataset. Queries are
held-out rows of the same mixture, perturbed.

A configuration with ``ip_as_l2`` stores each row x with the extra
coordinate sqrt(M^2 - |x|^2), M the largest row norm, and each query q as
(q, 0): the L2 order is then the inner-product order (MS-MARCO/STAR).

Both sides get the same bits: the program the whole dataset from
:func:`dataset`, the reference each block from :func:`block`.
"""
from __future__ import annotations

import hashlib

import torch

_CENTRES, _ROWS, _QUERIES = "centres", "rows", "queries"


def _seed(seed: int, stream: str, index: int = 0) -> int:
    h = hashlib.sha256(f"{int(seed)}:{stream}:{int(index)}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _gen(device, seed: int, stream: str, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed(seed, stream, index))


def mixture(cfg: dict) -> dict:
    return cfg["assumed"]["mixture"]


def base_dim(cfg: dict) -> int:
    """The published width of a row before any extra coordinate."""
    return cfg["d"] - 1 if cfg.get("ip_as_l2") else cfg["d"]


def n_blocks(cfg: dict) -> int:
    rows = mixture(cfg)["block_rows"]
    return -(-cfg["n"] // rows)


def centres(cfg: dict, seed: int, device) -> torch.Tensor:
    """The mixture's centres: the configuration's own (``centre_seed``), the
    same for every run, so that every seed gives rows and queries of one
    structure and the survivor filter the same work to do."""
    mx = mixture(cfg)
    g = _gen(device, mx["centre_seed"], _CENTRES)
    return mx["centre_scale"] * torch.randn(mx["clusters"], base_dim(cfg), generator=g,
                                            device=device)


def _draw(cent, g, rows, scale) -> torch.Tensor:
    c = torch.randint(0, cent.shape[0], (rows,), generator=g, device=cent.device)
    x = torch.randn(rows, cent.shape[1], generator=g, device=cent.device)
    return x.mul_(scale).add_(cent[c])


def base_block(cfg: dict, seed: int, b: int, cent: torch.Tensor):
    """Block ``b`` before any extra coordinate: (rows, base_dim) and the
    squared norms of its rows."""
    mx = mixture(cfg)
    lo = b * mx["block_rows"]
    rows = min(mx["block_rows"], cfg["n"] - lo)
    x = _draw(cent, _gen(cent.device, seed, _ROWS, b), rows, mx["noise_scale"])
    return x, (x * x).sum(1)


def max_norm_sq(cfg: dict, seed: int, cent: torch.Tensor) -> torch.Tensor:
    """M^2 of an ``ip_as_l2`` configuration, made block by block."""
    return torch.stack([base_block(cfg, seed, b, cent)[1].max()
                        for b in range(n_blocks(cfg))]).max()


def _extend(x, norms, m2) -> torch.Tensor:
    extra = (m2 - norms).clamp_(min=0).sqrt_()
    return torch.cat([x, extra[:, None]], dim=1)


def block(cfg: dict, seed: int, b: int, cent: torch.Tensor, m2=None) -> torch.Tensor:
    """Block ``b`` of the rows as both sides see them, (rows, d) f32."""
    x, norms = base_block(cfg, seed, b, cent)
    return _extend(x, norms, m2) if cfg.get("ip_as_l2") else x


def dataset(cfg: dict, seed: int, device) -> torch.Tensor:
    """All rows, (n, d) f32, made on ``device`` block by block."""
    cent = centres(cfg, seed, device)
    out = torch.empty(cfg["n"], cfg["d"], device=device)
    rows = mixture(cfg)["block_rows"]
    ext = cfg.get("ip_as_l2")
    norms = torch.empty(cfg["n"], device=device) if ext else None
    for b in range(n_blocks(cfg)):
        x, nrm = base_block(cfg, seed, b, cent)
        lo = b * rows
        out[lo: lo + x.shape[0], : x.shape[1]] = x
        if ext:
            norms[lo: lo + x.shape[0]] = nrm
        del x
    if ext:
        extra = (norms.max() - norms).clamp_(min=0).sqrt_()
        out[:, -1] = extra
    return out


def queries(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """``count`` queries, (count, d) f32: held-out rows of the mixture plus
    a perturbation (0 in the extra coordinate of ``ip_as_l2``)."""
    mx = mixture(cfg)
    cent = centres(cfg, seed, device)
    g = _gen(device, seed, _QUERIES)
    q = _draw(cent, g, count, mx["noise_scale"])
    q.add_(mx["query_noise_scale"] * torch.randn(q.shape, generator=g, device=device))
    if cfg.get("ip_as_l2"):
        q = torch.cat([q, q.new_zeros(count, 1)], dim=1)
    return q
