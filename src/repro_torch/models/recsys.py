"""Recsys models: DLRM-RM2, Two-Tower retrieval, BST, Wide&Deep.

All categorical tables of a model are FUSED into one (total_rows, dim)
matrix with static per-feature row offsets, as in the reference
(``repro.models.recsys``). A lookup indexes the fused table; its gradient
is a dense table, as ``jnp.take``'s is, so AdamW moves and decays every
row as the reference's does (no ``sparse=True``, no ``nn.EmbeddingBag``).
On a mesh with a ``model`` axis (``repro_torch.core.mesh.use_mesh``) the
fused table is row-sharded over it (``param_specs``) and a lookup is the
reference's island: each position takes the ids that fall in its rows
(a masked take), and the positions' values are summed, so traffic is
batch · dim, never table-sized (:func:`embedding_lookup`).

The parameters are the reference's tree: dicts and Python lists of
``{"w", "b"}`` layers, each leaf a tensor, so ``optim``, ``checkpoint``
and ``convert`` walk them as they walk the reference's pytree.

Entry points:
    init(generator, cfg, device=None)        -> the param tree
    forward(params, cfg, batch)              -> logits (B,)
    loss_fn(params, cfg, batch)              -> (loss, aux)
    value_and_grad(params, cfg, batch)       -> ((loss, aux), grads tree)
    serve_scores(params, cfg, batch)         -> scores (B,)
    retrieve_topk(params, cfg, user_ids, candidates, k) -> TopK

The paper tie-in: two-tower ``retrieval_cand`` (1 query vs 10^6
candidates, maximum inner product) is exact kNN with metric ``ip``. On a
CUDA tensor ``retrieve_topk`` runs the card's fused kNN kernel
(``kernels/knn/ops.py::knn``: one ``knn_scan`` and one ``knn_merge``); on
a CPU tensor it runs the plain ``core/fqsd.py::chunk_step``, the
reference's own call. The tensors' device decides.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.mesh import current_mesh
from repro_torch.core.topk import TopK
from repro_torch.models.layers import dense_init, draw_device, island
from repro_torch.runtime.sharding import P, resolve
from repro_torch.tree import tree_map, value_and_grad as _value_and_grad

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str  # "dlrm" | "two_tower" | "bst" | "wide_deep"
    table_sizes: tuple[int, ...]
    embed_dim: int
    n_dense: int = 0
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    tower_mlp: tuple[int, ...] = ()
    interaction: str = "dot"  # dot | concat | transformer-seq
    seq_len: int = 0
    n_heads: int = 0
    n_blocks: int = 0
    dtype: Any = torch.float32

    @property
    def total_rows(self) -> int:
        return sum(self.table_sizes)

    @property
    def padded_rows(self) -> int:
        """Fused-table rows padded as the reference pads them (so every mesh
        axis combination divides evenly). Pad rows are never addressed: ids
        stay below total_rows."""
        mult = 8192 if self.total_rows >= 1_000_000 else 32
        return ((self.total_rows + mult - 1) // mult) * mult

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    def feature_offsets(self, device=None) -> torch.Tensor:
        """Each feature's first row in the fused table, int32."""
        off, acc = [], 0
        for s in self.table_sizes:
            off.append(acc)
            acc += s
        return torch.tensor(off, dtype=torch.int32, device=device)

    def params_count(self) -> int:
        def mlp_p(dims):
            return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        n = self.total_rows * self.embed_dim
        if self.kind == "dlrm":
            n += mlp_p((self.n_dense,) + self.bot_mlp)
            n_int = self.n_sparse + 1
            d_top_in = n_int * (n_int - 1) // 2 + self.bot_mlp[-1]
            n += mlp_p((d_top_in,) + self.top_mlp)
        elif self.kind == "two_tower":
            n += 2 * mlp_p((self.embed_dim,) + self.tower_mlp)
        elif self.kind == "bst":
            d = self.embed_dim
            n += self.n_blocks * (4 * d * d + 2 * d + 8 * d * d)  # attn + ffn
            n += mlp_p((d * 2,) + self.top_mlp) + self.top_mlp[-1] + 1
        elif self.kind == "wide_deep":
            n += self.total_rows  # wide weights (dim-1 tables)
            n += mlp_p((self.n_sparse * self.embed_dim,) + self.top_mlp)
        return n


# ------------------------------------------------------------ embeddings
def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) -> (..., dim): rows of the fused table. Every id must be
    in range (torch raises on the CPU and asserts on the card where
    ``jnp.take`` would clamp). On a mesh with a ``model`` axis the table is
    row-sharded over it: :class:`_RowShardedLookup`."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return table[ids.long()]
    return _RowShardedLookup.apply(table, ids, mesh)


def _row_blocks(table_rows: int, ids: torch.Tensor, mesh):
    """(data block rows, tp, rows a model position holds, device(i, t))."""
    tp = mesh.shape["model"]
    if table_rows % tp:
        raise ValueError(f"{table_rows} table rows do not split over model={tp}")
    blocks, b_loc, device = island(mesh, ids.shape[0] if ids.ndim else 1)
    return blocks, b_loc, tp, table_rows // tp, device


class _RowShardedLookup(torch.autograd.Function):
    """The reference's row-sharded lookup, position by position: model
    position t holds rows [t·size, (t+1)·size) and each data block of the
    ids (the batch over the data axes); it takes the ids in its rows
    (others clipped and zeroed), and the positions' values are summed in
    position order (``psum`` over ``model``). Exactly one position holds a
    row, so the sum is the row itself. The backward scatters each
    position's rows of the cotangent into its block of one dense table
    gradient (``jnp.take``'s transpose)."""

    @staticmethod
    def forward(ctx, table, ids, mesh):
        blocks, b_loc, tp, size, device = _row_blocks(table.shape[0], ids, mesh)
        first = mesh.first
        outs = []
        for i in range(blocks):
            idb = ids[i * b_loc:(i + 1) * b_loc] if blocks > 1 else ids
            total = None
            for t in range(tp):
                dev = device(i, t)
                loc = idb.to(dev).long() - t * size
                ok = (loc >= 0) & (loc < size)
                vals = table[t * size:(t + 1) * size].to(dev)[loc.clamp(0, size - 1)]
                vals = torch.where(ok[..., None], vals, 0).to(first)
                total = vals if total is None else total + vals
            outs.append(total)
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.shape = mesh, table.shape
        return torch.cat(outs) if blocks > 1 else outs[0]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        mesh = ctx.mesh
        blocks, b_loc, tp, size, device = _row_blocks(ctx.shape[0], ids, mesh)
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=mesh.first)
        for i in range(blocks):
            rows = slice(i * b_loc, (i + 1) * b_loc) if blocks > 1 else slice(None)
            for t in range(tp):
                dev = device(i, t)
                loc = ids[rows].to(dev).long() - t * size
                ok = (loc >= 0) & (loc < size)
                part = grad[t * size:(t + 1) * size]
                part.index_put_((loc[ok],), g[rows].to(dev)[ok].to(part.device),
                                accumulate=True)
        return grad, None, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """Multi-hot bag pooling: ids (B, L) with -1 padding -> (B, dim).

    A padding id reads row 0 and is masked out, as in the reference."""
    mask = ids >= 0
    vals = embedding_lookup(table, torch.clamp_min(ids, 0))
    vals = vals * mask[..., None].to(vals.dtype)
    out = vals.sum(dim=-2)
    if mode == "mean":
        out = out / torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1).to(out.dtype)
    return out


def _init_mlp(g, dims, dtype, device):
    return [{"w": dense_init(g, (a, b), dtype, device=device),
             "b": torch.zeros((b,), dtype=dtype, device=draw_device(g, device))}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(params, x, final_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if final_act or i + 1 < len(params):
            x = torch.relu(x)
    return x


def _init_table(g, rows, dim, dtype, device):
    """N(0, 0.01²) rows, drawn in f32 and scaled in place (a full-size
    table has no room for a second copy)."""
    t = torch.randn((rows, dim), generator=g, device=draw_device(g, device), dtype=F32)
    return t.mul_(0.01).to(dtype)


# ------------------------------------------------------------------ init
def init(generator: torch.Generator, cfg: RecsysConfig, device=None) -> dict:
    """Random parameters drawn from ``generator`` on its own device, then
    placed on ``device`` (``None`` means CUDA and raises without a card;
    ``"meta"`` gives shapes and dtypes only). Not trainable until the
    caller sets ``requires_grad``."""
    device = resolve_device(device)
    g = generator
    params: dict = {"embed": _init_table(g, cfg.padded_rows, cfg.embed_dim, cfg.dtype, device)}
    if cfg.kind == "dlrm":
        params["bot"] = _init_mlp(g, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype, device)
        n_int = cfg.n_sparse + 1
        d_top_in = n_int * (n_int - 1) // 2 + cfg.bot_mlp[-1]
        params["top"] = _init_mlp(g, (d_top_in,) + cfg.top_mlp, cfg.dtype, device)
    elif cfg.kind == "two_tower":
        params["user_tower"] = _init_mlp(g, (cfg.embed_dim,) + cfg.tower_mlp, cfg.dtype, device)
        params["item_tower"] = _init_mlp(g, (cfg.embed_dim,) + cfg.tower_mlp, cfg.dtype, device)
    elif cfg.kind == "bst":
        d = cfg.embed_dim
        params["pos"] = _init_table(g, cfg.seq_len + 1, d, cfg.dtype, device)
        params["attn"] = {
            **{k: dense_init(g, (d, d), cfg.dtype, device=device)
               for k in ("wq", "wk", "wv", "wo")},
            "ffn1": _init_mlp(g, (d, 4 * d), cfg.dtype, device)[0],
            "ffn2": _init_mlp(g, (4 * d, d), cfg.dtype, device)[0],
        }
        params["top"] = _init_mlp(g, (2 * d,) + cfg.top_mlp + (1,), cfg.dtype, device)
    elif cfg.kind == "wide_deep":
        params["wide"] = _init_table(g, cfg.padded_rows, 1, cfg.dtype, device)
        params["wide_bias"] = torch.zeros((), dtype=cfg.dtype, device=draw_device(g, device))
        params["deep"] = _init_mlp(
            g, (cfg.n_sparse * cfg.embed_dim,) + cfg.top_mlp + (1,), cfg.dtype, device)
    else:
        raise ValueError(cfg.kind)
    return tree_map(lambda t: t.to(device), params)


def param_specs(cfg: RecsysConfig):
    """Tables row-shard over `model`; MLPs replicate (the reference's tree of
    specs, built from the parameters' shapes on the meta device)."""
    rows = resolve(("rows",))[0]
    sample = init(torch.Generator(), dataclasses.replace(cfg, table_sizes=(8,) * cfg.n_sparse),
                  device="meta")
    specs = tree_map(lambda _: P(), sample)
    specs["embed"] = P(rows, None)
    if cfg.kind == "wide_deep":
        specs["wide"] = P(rows, None)
    return specs


# --------------------------------------------------------------- forward
def _dlrm_forward(params, cfg, batch):
    dense = batch["dense"].to(cfg.dtype)  # (B, n_dense)
    ids = batch["sparse"] + cfg.feature_offsets(dense.device)[None, :]  # (B, n_sparse)
    emb = embedding_lookup(params["embed"], ids)  # (B, n_sparse, d)
    bot = _mlp(params["bot"], dense, final_act=True)  # (B, d)
    z = torch.cat([bot[:, None, :], emb], dim=1)  # (B, F, d)
    inter = torch.bmm(z, z.transpose(1, 2))  # (B, F, F) pairwise dots
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=z.device)  # row-major, as jnp's
    flat = inter[:, iu, ju]  # (B, F(F-1)/2)
    top_in = torch.cat([flat, bot], dim=-1)
    return _mlp(params["top"], top_in)[:, 0]  # logits (B,)


def _two_tower_embed(params, cfg, ids, tower):
    e = embedding_lookup(params["embed"], ids)
    v = _mlp(params[tower], e)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-6)


def _bst_forward(params, cfg, batch):
    d = cfg.embed_dim
    seq_ids = batch["seq"] + cfg.feature_offsets(batch["seq"].device)[0]  # (B, S)
    tgt_ids = batch["target"] + cfg.feature_offsets(batch["seq"].device)[0]  # (B,)
    e = embedding_lookup(params["embed"], seq_ids)  # (B, S, d)
    e = e + params["pos"][: cfg.seq_len][None]
    a = params["attn"]
    b, s, _ = e.shape
    h = cfg.n_heads
    dh = d // h
    q = (e @ a["wq"]).reshape(b, s, h, dh)
    k = (e @ a["wk"]).reshape(b, s, h, dh)
    v = (e @ a["wv"]).reshape(b, s, h, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    mask = batch.get("seq_mask")
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits, -torch.inf)
    p = torch.softmax(logits.to(F32), dim=-1).to(e.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d) @ a["wo"]
    x = e + o
    x = x + (torch.relu(x @ a["ffn1"]["w"] + a["ffn1"]["b"]) @ a["ffn2"]["w"] + a["ffn2"]["b"])
    pooled = x.mean(dim=1)  # over every position, masked ones too, as the reference
    tgt = embedding_lookup(params["embed"], tgt_ids)
    return _mlp(params["top"], torch.cat([pooled, tgt], dim=-1))[:, 0]


def _wide_deep_forward(params, cfg, batch):
    ids = batch["sparse"] + cfg.feature_offsets(batch["sparse"].device)[None, :]  # (B, F)
    wide = embedding_lookup(params["wide"], ids)[..., 0].sum(-1) + params["wide_bias"]
    emb = embedding_lookup(params["embed"], ids)  # (B, F, d)
    deep = _mlp(params["deep"], emb.reshape(emb.shape[0], -1))[:, 0]
    return wide + deep


def forward(params, cfg: RecsysConfig, batch) -> torch.Tensor:
    if cfg.kind == "dlrm":
        return _dlrm_forward(params, cfg, batch)
    if cfg.kind == "bst":
        return _bst_forward(params, cfg, batch)
    if cfg.kind == "wide_deep":
        return _wide_deep_forward(params, cfg, batch)
    raise ValueError(f"forward() undefined for {cfg.kind}; use two_tower_* fns")


def loss_fn(params, cfg: RecsysConfig, batch) -> tuple[torch.Tensor, dict]:
    if cfg.kind == "two_tower":
        u = _two_tower_embed(params, cfg, batch["user"], "user_tower")
        v = _two_tower_embed(params, cfg, batch["item"], "item_tower")
        logits = (u @ v.T) / 0.05  # in-batch sampled softmax
        logz = torch.logsumexp(logits, dim=-1)
        nll = (logz - torch.diagonal(logits)).mean()
        return nll, {"nll": nll}
    logits = forward(params, cfg, batch).to(F32)
    y = batch["label"].to(F32)
    bce = torch.mean(torch.clamp_min(logits, 0) - logits * y
                     + torch.log1p(torch.exp(-torch.abs(logits))))
    return bce, {"bce": bce}


def value_and_grad(params, cfg: RecsysConfig, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, aux), grads),
    the grads a tree of the params' structure. Every leaf must require
    grad."""
    return _value_and_grad(lambda p: loss_fn(p, cfg, batch), params)


# ----------------------------------------------------------------- serve
@torch.no_grad()
def serve_scores(params, cfg: RecsysConfig, batch) -> torch.Tensor:
    """Pointwise scoring (serve_p99 / serve_bulk shapes)."""
    if cfg.kind == "two_tower":
        u = _two_tower_embed(params, cfg, batch["user"], "user_tower")
        v = _two_tower_embed(params, cfg, batch["item"], "item_tower")
        return torch.einsum("bd,bd->b", u, v)
    return torch.sigmoid(forward(params, cfg, batch))


def mips_topk(u: torch.Tensor, candidates: torch.Tensor, k: int) -> TopK:
    """Exact maximum inner product search of (B, d) queries over (N, d)
    candidates: scores are -<u, c>, ascending. A CUDA tensor goes through
    the card's fused kernel (one ``knn_scan`` + one ``knn_merge``), a CPU
    tensor through the plain ``chunk_step``."""
    if u.device.type == "cuda":
        from repro_torch.kernels.knn.ops import knn

        return knn(u, candidates, k, metric="ip")
    if u.device.type != "cpu":
        raise ValueError(f"no retrieval path on {u.device}")
    from repro_torch.core.fqsd import chunk_step
    from repro_torch.core.topk import empty_topk

    state = empty_topk((u.shape[0],), k, device=u.device)
    return chunk_step(state, u, candidates, None, 0, candidates.shape[0], "ip")


@torch.no_grad()
def retrieve_topk(params, cfg: RecsysConfig, user_ids, candidates, k: int) -> TopK:
    """retrieval_cand shape: exact MIPS over the candidate corpus
    (:func:`mips_topk`)."""
    u = _two_tower_embed(params, cfg, user_ids, "user_tower")  # (B, d)
    return mips_topk(u, candidates, k)
