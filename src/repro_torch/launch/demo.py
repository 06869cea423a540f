"""Materialize real inputs for a Cell (smoke runs, the training driver,
examples).

Params come from the model's init (not random tensors shaped like params —
routers and softmaxes need sane magnitudes), drawn from a
``torch.Generator`` seeded with ``seed``; batches are drawn from
``np.random.default_rng(seed)`` exactly as the reference draws them, so
they are the reference's batches. The LM's weights are trainable
(``requires_grad``) for a train cell.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.engine import resolve_device
from repro_torch.launch.steps import Cell, build_cell
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig


def lm_tokens(rng: np.random.Generator, vocab: int, spec: torch.Tensor, device) -> torch.Tensor:
    """Token ids of ``spec``'s shape (a meta tensor): the reference's draw."""
    return torch.from_numpy(rng.integers(0, vocab, tuple(spec.shape)).astype(np.int32)).to(device)


def lm_batch(rng: np.random.Generator, vocab: int, batch_in: dict, device) -> dict:
    """Token ids for each input of ``batch_in``, in its order."""
    return {k: lm_tokens(rng, vocab, v, device) for k, v in batch_in.items()}


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

    if arch.family == "knn":
        q = torch.from_numpy(rng.standard_normal(tuple(cell.inputs[0].shape)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(tuple(cell.inputs[1].shape)).astype(np.float32))
        q, v = q.to(device), v.to(device)
        return cell, (q, v, torch.sum(v * v, dim=-1))

    raise ValueError(arch.family)
