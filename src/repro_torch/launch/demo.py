"""Materialize real inputs for a Cell (smoke runs, the training driver,
examples).

Params come from the model's init (not random tensors shaped like params —
routers and softmaxes need sane magnitudes), drawn from a
``torch.Generator`` seeded with ``seed``; batches are drawn from
``np.random.default_rng(seed)`` exactly as the reference draws them, in
its order (the cell's inputs in their insertion order), so they are the
reference's batches. The weights are trainable (``requires_grad``) for a
train cell.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.engine import resolve_device
from repro_torch.launch.steps import Cell, build_cell
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import requires_grad_


def lm_tokens(rng: np.random.Generator, vocab: int, spec: torch.Tensor, device) -> torch.Tensor:
    """Token ids of ``spec``'s shape (a meta tensor): the reference's draw."""
    return torch.from_numpy(rng.integers(0, vocab, tuple(spec.shape)).astype(np.int32)).to(device)


def lm_batch(rng: np.random.Generator, vocab: int, batch_in: dict, device) -> dict:
    """Token ids for each input of ``batch_in``, in its order."""
    return {k: lm_tokens(rng, vocab, v, device) for k, v in batch_in.items()}


def _np(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def gnn_batch(rng: np.random.Generator, batch_in: dict, device) -> dict:
    """A GNN cell's batch for ``batch_in`` (meta tensors): the reference's
    draws, graph inputs in their order (senders and receivers uniform over
    the nodes, every edge valid, features and targets N(0, 1))."""
    g = {}
    n_nodes = batch_in["graph"]["nodes"].shape[-2]
    for k, v in batch_in["graph"].items():
        shape = tuple(v.shape)
        if k in ("senders", "receivers"):
            g[k] = _np(rng.integers(0, n_nodes, shape).astype(np.int32), device)
        elif k == "edge_mask":
            g[k] = torch.ones(shape, dtype=torch.bool, device=device)
        else:
            g[k] = _np(rng.standard_normal(shape).astype(np.float32), device)
    batch = {"graph": g, "targets": _np(
        rng.standard_normal(tuple(batch_in["targets"].shape)).astype(np.float32), device)}
    if "node_mask" in batch_in:
        batch["node_mask"] = torch.ones(tuple(batch_in["node_mask"].shape), dtype=torch.float32,
                                        device=device)
    return batch


def recsys_batch(rng: np.random.Generator, cfg: R.RecsysConfig, batch_in: dict,
                 device) -> dict:
    """A recsys cell's batch for ``batch_in`` (meta tensors): the
    reference's draws, in its order (ids uniform over each feature's
    table, labels 0/1, dense features N(0, 1))."""
    out = {}
    for k, v in batch_in.items():
        shape = tuple(v.shape)
        if k == "dense":
            out[k] = _np(rng.standard_normal(shape).astype(np.float32), device)
        elif k == "label":
            out[k] = _np(rng.integers(0, 2, shape).astype(np.float32), device)
        elif k == "sparse":
            cols = [rng.integers(0, cfg.table_sizes[i], shape[:-1] + (1,))
                    for i in range(shape[-1])]
            out[k] = _np(np.concatenate(cols, -1).astype(np.int32), device)
        elif k in ("seq", "target", "user", "item"):
            out[k] = _np(rng.integers(0, cfg.table_sizes[0], shape).astype(np.int32), device)
    return out


def materialize(arch: ArchConfig, shape: ShapeSpec, smoke: bool = True, seed: int = 0,
                device=None) -> tuple[Cell, tuple]:
    """Returns (cell, concrete positional args), on ``device`` (``None``
    means CUDA, which must exist)."""
    device = resolve_device(device)
    cell = build_cell(arch, shape, smoke=smoke)
    rng = np.random.default_rng(seed)

    if arch.family == "lm":
        cfg: T.LMConfig = arch.smoke_model if smoke else arch.model
        params = T.init(torch.Generator(device).manual_seed(seed), cfg, device)
        args = [params]
        if shape.kind == "train":
            params.requires_grad_(True)
            opt = adamw_init(params, AdamWConfig(moment_dtype=arch.train_moment_dtype))
            args += [opt, lm_batch(rng, cfg.vocab, cell.inputs[2], device)]
        elif shape.kind == "prefill":
            args.append(lm_tokens(rng, cfg.vocab, cell.inputs[1], device))
        else:  # decode
            cache = T.init_cache(cfg, *cell.inputs[1]["k"].shape[1:3], device=device)
            cache["len"] = cache["k"].shape[2] // 2
            args += [cache, lm_tokens(rng, cfg.vocab, cell.inputs[2], device)]
        return cell, tuple(args)

    if arch.family == "gnn":
        base: G.GNNConfig = arch.smoke_model if smoke else arch.model
        cfg = dataclasses.replace(base, d_node_in=cell.inputs[2]["graph"]["nodes"].shape[-1])
        params = requires_grad_(G.init(torch.Generator(device).manual_seed(seed), cfg, device))
        opt = adamw_init(params, AdamWConfig(moment_dtype=arch.train_moment_dtype))
        return cell, (params, opt, gnn_batch(rng, cell.inputs[2], device))

    if arch.family == "recsys":
        cfg: R.RecsysConfig = arch.smoke_model if smoke else arch.model
        params = R.init(torch.Generator(device).manual_seed(seed), cfg, device)
        if shape.kind == "train":
            requires_grad_(params)
            opt = adamw_init(params, AdamWConfig(moment_dtype=arch.train_moment_dtype))
            return cell, (params, opt, recsys_batch(rng, cfg, cell.inputs[2], device))
        if shape.kind == "serve":
            return cell, (params, recsys_batch(rng, cfg, cell.inputs[1], device))
        uid = rng.integers(0, cfg.table_sizes[0], tuple(cell.inputs[1].shape)).astype(np.int32)
        cand = rng.standard_normal(tuple(cell.inputs[2].shape)).astype(np.float32)
        return cell, (params, _np(uid, device), _np(cand, device))

    if arch.family == "knn":
        q = torch.from_numpy(rng.standard_normal(tuple(cell.inputs[0].shape)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(tuple(cell.inputs[1].shape)).astype(np.float32))
        q, v = q.to(device), v.to(device)
        return cell, (q, v, torch.sum(v * v, dim=-1))

    raise ValueError(arch.family)
