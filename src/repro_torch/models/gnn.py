"""MeshGraphNet (arXiv:2010.03409) — encode-process-decode message passing.

Message passing scatters edge messages into their destination nodes
(``index_add`` for sum and mean, ``scatter_reduce("amax")`` for max), the
port's counterpart of the reference's ``jax.ops.segment_sum`` /
``segment_max`` (``repro.models.gnn``). On the card these scatters use
atomics, so two runs may differ in the last bits of a sum: the port is held
to the reference by tolerances, not bit for bit.

Supports all four assigned shapes through one code path:
    full_graph_sm / ogb_products  — one big (padded) edge list
    minibatch_lg                  — sampled subgraph from repro_torch.models.sampler
    molecule                      — batched small graphs with a leading batch dim,
                                    run as their disjoint union (the reference vmaps)

The parameters are the reference's tree: the encoders and the decoder are
Python lists of ``{"w", "b"}`` layers; ``procs`` holds the L processor
layers stacked on a leading axis, as the reference's ``jax.vmap(init_proc)``
does, and ``apply`` loops over them. With ``cfg.remat`` and grad enabled
each layer runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body). ``scan_unroll`` is the reference's
dry-run knob; the port loops and ignores it. The reference's
``shard(..., "edges", None)`` constraints are kept where it has them, for
the reader: they leave values as they are (``runtime.sharding``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.models.layers import dense_init, draw_device
from repro_torch.runtime.sharding import shard
from repro_torch.tree import tree_map, value_and_grad as _value_and_grad

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    aggregator: str = "sum"  # sum | mean | max
    d_node_in: int = 1433
    d_edge_in: int = 4
    d_out: int = 1
    dtype: Any = torch.float32
    remat: bool = False
    scan_unroll: bool = False  # the reference's dry-run knob; the port loops

    def params_count(self) -> int:
        def mlp_p(d_in):
            total, d = 0, d_in
            for _ in range(self.mlp_layers):
                total += d * self.d_hidden + self.d_hidden
                d = self.d_hidden
            return total
        enc = mlp_p(self.d_node_in) + mlp_p(self.d_edge_in)
        proc = self.n_layers * (mlp_p(3 * self.d_hidden) + mlp_p(2 * self.d_hidden))
        dec = mlp_p(self.d_hidden) + self.d_hidden * self.d_out + self.d_out
        return enc + proc + dec


def _init_mlp(g, d_in, d_hidden, n_layers, dtype, device, d_out=None, stack=()):
    """An MLP's layers; ``stack=(L,)`` draws L of them stacked on a leading
    axis."""
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out or d_hidden]
    return [{"w": dense_init(g, (*stack, a, b), dtype, device=device),
             "b": torch.zeros((*stack, b), dtype=dtype, device=draw_device(g, device))}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(params, x):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i + 1 < len(params):
            x = torch.relu(x)
    return x


def init(generator: torch.Generator, cfg: GNNConfig, device=None) -> dict:
    """Random parameters drawn from ``generator`` on its own device, then
    placed on ``device`` (``None`` means CUDA and raises without a card;
    ``"meta"`` gives shapes and dtypes only)."""
    device = resolve_device(device)
    g, h, n, dt = generator, cfg.d_hidden, cfg.mlp_layers, cfg.dtype
    params = {
        "node_enc": _init_mlp(g, cfg.d_node_in, h, n, dt, device),
        "edge_enc": _init_mlp(g, cfg.d_edge_in, h, n, dt, device),
        "procs": {
            "edge_mlp": _init_mlp(g, 3 * h, h, n, dt, device, stack=(cfg.n_layers,)),
            "node_mlp": _init_mlp(g, 2 * h, h, n, dt, device, stack=(cfg.n_layers,)),
        },
        "decoder": _init_mlp(g, h, h, n, dt, device, d_out=cfg.d_out),
    }
    return tree_map(lambda t: t.to(device), params)


def _aggregate(messages, dst, n_nodes, aggregator, edge_mask=None):
    """Per-node reduction of edge messages over their destinations; masked
    edges scatter (as zeros) into a sink row past the last node."""
    if edge_mask is not None:
        messages = messages * edge_mask[:, None].to(messages.dtype)
        dst = torch.where(edge_mask, dst, n_nodes)  # scatter pads to a sink row
        n_seg = n_nodes + 1
    else:
        n_seg = n_nodes
    dst = dst.long()
    zeros = messages.new_zeros((n_seg, messages.shape[-1]))
    if aggregator == "sum":
        agg = zeros.index_add(0, dst, messages)
    elif aggregator == "mean":
        s = zeros.index_add(0, dst, messages)
        c = messages.new_zeros((n_seg,)).index_add(0, dst, messages.new_ones(dst.shape))
        agg = s / torch.clamp_min(c, 1.0)[:, None]
    elif aggregator == "max":
        # an empty segment keeps the buffer's 0: the reference's -inf, then 0
        agg = zeros.scatter_reduce(0, dst[:, None].expand_as(messages), messages, "amax",
                                   include_self=False)
        agg = torch.where(torch.isfinite(agg), agg, 0.0)
    else:
        raise ValueError(aggregator)
    return agg[:n_nodes] if edge_mask is not None else agg


def _proc(cfg, lp, x, e, snd, rcv, mask):
    """One processor layer: edge update, aggregate, node update."""
    inp = torch.cat([e, x[snd], x[rcv]], dim=-1)
    e_new = e + _mlp(lp["edge_mlp"], shard(inp, "edges", None))
    agg = _aggregate(e_new, rcv, x.shape[0], cfg.aggregator, mask)
    x_new = x + _mlp(lp["node_mlp"], torch.cat([x, agg], dim=-1))
    return x_new, e_new


def apply(params, cfg: GNNConfig, graph: dict) -> torch.Tensor:
    """graph = {nodes (N, d_node_in), edges (E, d_edge_in),
    senders (E,), receivers (E,), optional edge_mask (E,) bool}.
    Returns per-node predictions (N, d_out).
    """
    x = _mlp(params["node_enc"], graph["nodes"].to(cfg.dtype))
    e = _mlp(params["edge_enc"], graph["edges"].to(cfg.dtype))
    snd = graph["senders"].long()
    rcv = graph["receivers"].long()
    mask = graph.get("edge_mask")
    e = shard(e, "edges", None)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = tree_map(lambda t, i=i: t[i], params["procs"])
        if remat:
            x, e = checkpoint(_proc, cfg, lp, x, e, snd, rcv, mask, use_reentrant=False)
        else:
            x, e = _proc(cfg, lp, x, e, snd, rcv, mask)
    return _mlp(params["decoder"], x)


def apply_batched(params, cfg: GNNConfig, graphs: dict) -> torch.Tensor:
    """Batched small graphs (molecule shape): leading batch dim on all
    arrays, run as one graph, their disjoint union, whose nodes of graph b
    are offset by b·N. Each graph's answer is the one it gets alone."""
    b, n = graphs["nodes"].shape[:2]
    offset = (torch.arange(b, device=graphs["senders"].device) * n)[:, None]
    union = {
        "nodes": graphs["nodes"].reshape(b * n, -1),
        "edges": graphs["edges"].reshape(-1, graphs["edges"].shape[-1]),
        "senders": (graphs["senders"].long() + offset).reshape(-1),
        "receivers": (graphs["receivers"].long() + offset).reshape(-1),
    }
    if "edge_mask" in graphs:
        union["edge_mask"] = graphs["edge_mask"].reshape(-1)
    return apply(params, cfg, union).reshape(b, n, -1)


def loss_fn(params, cfg: GNNConfig, batch) -> tuple[torch.Tensor, dict]:
    """Node-level regression (MeshGraphNet's next-step dynamics loss)."""
    graph = batch["graph"]
    target = batch["targets"]
    if graph["nodes"].ndim == 3:  # batched molecules
        pred = apply_batched(params, cfg, graph)
    else:
        pred = apply(params, cfg, graph)
    err = (pred.to(F32) - target.to(F32)) ** 2
    node_mask = batch.get("node_mask")
    if node_mask is not None:
        err = err * node_mask[..., None]
        loss = err.sum() / torch.clamp_min(node_mask.sum() * cfg.d_out, 1.0)
    else:
        loss = err.mean()
    return loss, {"mse": loss}


def value_and_grad(params, cfg: GNNConfig, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, aux), grads),
    the grads a tree of the params' structure. Every leaf must require
    grad."""
    return _value_and_grad(lambda p: loss_fn(p, cfg, batch), params)
