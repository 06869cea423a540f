"""Cell builder: (architecture x shape) -> step function + input shapes +
the dims the roofline reads. Shared by the training driver, the examples
and the tests (smoke=True swaps in the reduced model and tiny dims but runs
the same step code).

A Cell bundles:
    fn       step callable (params-first)
    inputs   positional args as meta tensors (trees of them): shapes and
             dtypes, nothing allocated
    meta     dims used by the roofline (params, tokens, model flops, ...)

Meshless: the reference's partition specs (``in_specs``, ``out_specs``) and
its sharded branches come with the port's substrate on a mesh. The train
step updates the parameters and the optimizer state in place
(``optim.adamw``) and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, apply_updates
from repro_torch.optim.adamw import AdamWConfig

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    inputs: tuple  # positional args as meta tensors (trees of them)
    meta: dict


def _spec(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ============================================================== LM cells
def build_lm_cell(arch: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> Cell:
    cfg: T.LMConfig = arch.smoke_model if smoke else arch.model
    if smoke:
        batch, seq = {"train": (2, 16), "prefill": (2, 32), "decode": (2, 64)}[shape.kind]
    else:
        batch, seq = shape["global_batch"], shape["seq_len"]

    params_shape = T.init(torch.Generator(), cfg, device=META)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(lr=1e-4, moment_dtype=arch.train_moment_dtype)
        opt_shape = adamw_init(params_shape, opt_cfg)
        mb = arch.train_microbatches if not smoke else 1

        def train_step(params, opt_state, batch_):
            if mb == 1:
                (loss, metrics), grads = T.value_and_grad(params, cfg, batch_)
            else:
                # gradient accumulation: peak activation memory / mb at the
                # same tokens a step. Grads accumulate in the param dtype.
                tk = batch_["tokens"].reshape(mb, batch // mb, seq)
                lb = batch_["labels"].reshape(mb, batch // mb, seq)
                grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
                loss = torch.zeros((), dtype=torch.float32, device=tk.device)
                for i in range(mb):
                    (l, _), g = T.value_and_grad(params, cfg, {"tokens": tk[i], "labels": lb[i]})
                    for n, gi in g.items():
                        grads[n] += gi.to(grads[n].dtype)
                    loss = loss + l
                grads = {n: g / mb for n, g in grads.items()}
                loss = loss / mb
                metrics = {"nll": loss, "moe_aux": torch.zeros_like(loss)}
            updates, opt_state = adamw_update(grads, opt_state, params, opt_cfg)
            params = apply_updates(params, updates)
            return params, opt_state, {"loss": loss, **metrics}

        batch_in = {"tokens": _spec((batch, seq)), "labels": _spec((batch, seq))}
        return Cell(arch.arch_id, shape.name, shape.kind, train_step,
                    (params_shape, opt_shape, batch_in),
                    _lm_meta(cfg, batch, seq, train=True))

    if shape.kind == "prefill":
        # 32k prefill: wider flash tiles, as the reference's cell has them
        cfg = dataclasses.replace(cfg, q_block=2048, kv_block=2048)

        def prefill_step(params, tokens):
            return T.prefill(params, cfg, tokens)

        return Cell(arch.arch_id, shape.name, shape.kind, prefill_step,
                    (params_shape, _spec((batch, seq))),
                    _lm_meta(cfg, batch, seq, train=False))

    # decode (decode_32k / long_500k): one new token against a seq_len cache
    cache_shape = T.init_cache(cfg, batch, seq, device=META)

    def decode(params, cache, tokens):
        return T.decode_step(params, cfg, cache, tokens)

    return Cell(arch.arch_id, shape.name, shape.kind, decode,
                (params_shape, cache_shape, _spec((batch, 1))),
                _lm_meta(cfg, batch, seq, train=False, decode=True))


def _lm_meta(cfg: T.LMConfig, batch, seq, train: bool, decode: bool = False):
    n_total = cfg.params_count()
    n_active = cfg.active_params_count()
    tokens = batch * (1 if decode else seq)
    model_flops = (6 if train else 2) * n_active * tokens
    if decode:
        # attention reads the whole cache: 2 * B * S * L * kv * dh * 2 matmuls
        model_flops += 4 * batch * seq * cfg.n_layers * cfg.n_kv_heads * cfg.d_head
    return {
        "family": "lm", "params_total": n_total, "params_active": n_active,
        "tokens": tokens, "model_flops": model_flops,
        "batch": batch, "seq": seq, "train": train,
    }


# ============================================================== kNN cells
def build_knn_cell(arch: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> Cell:
    if smoke:
        n, d, m, k = 2048, 128, 4, 16
    else:
        n, d, m, k = shape["n"], shape["d"], shape["m"], shape["k"]
    d_pad = _round_up(d, 128)
    n_pad = _round_up(n, 128 * 256)  # the reference's meshless padding (256 devices)

    if shape.kind == "knn_fdsq":
        def fn(qv, vecs, norms):
            from repro_torch.core.fdsq import fdsq_search
            return fdsq_search(qv, vecs, norms, k, "l2", 4)
    else:  # knn_fqsd, knn_ring, knn_ring_q: one device scans everything
        def fn(qv, vecs, norms):
            from repro_torch.core.fqsd import fqsd_scan
            return fqsd_scan(qv, vecs, norms, k, "l2", 256)

    meta = {
        "family": "knn", "params_total": 0, "params_active": 0,
        "model_flops": 2 * m * n * d + m * n,  # GEMM + epilogue
        "n": n, "d": d, "m": m, "k": k, "train": False,
        "dataset_bytes": n_pad * d_pad * 4,
    }
    f32 = torch.float32
    return Cell(arch.arch_id, shape.name, shape.kind, fn,
                (_spec((m, d_pad), f32), _spec((n_pad, d_pad), f32), _spec((n_pad,), f32)),
                meta)


def _round_up(v, m):
    return ((v + m - 1) // m) * m


# ================================================================ dispatch
def build_cell(arch: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> Cell:
    if arch.family == "lm":
        return build_lm_cell(arch, shape, smoke)
    if arch.family == "knn":
        return build_knn_cell(arch, shape, smoke)
    if arch.family in ("gnn", "recsys"):
        raise NotImplementedError(
            f"{arch.family} cells come with the recsys and GNN models (ROADMAP A11c)")
    raise ValueError(arch.family)
