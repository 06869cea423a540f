"""Cell builder: (architecture x shape) -> step function + input shapes +
the dims the roofline reads, for every family (LM, GNN, recsys, kNN).
Shared by the training driver, the examples and the tests (smoke=True
swaps in the reduced model and tiny dims but runs the same step code).

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
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.sampler import edge_budget
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


# ============================================================= GNN cells
def build_gnn_cell(arch: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> Cell:
    base_cfg: G.GNNConfig = arch.smoke_model if smoke else arch.model
    d_feat = 8 if smoke else shape["d_feat"]
    cfg = dataclasses.replace(base_cfg, d_node_in=d_feat)
    f32 = torch.float32

    if shape.kind == "train_sampled":
        n_pad, e_pad = (64, 80) if smoke else edge_budget(
            shape["batch_nodes"], (shape["fanout0"], shape["fanout1"]))
        graph = {
            "nodes": _spec((n_pad, d_feat), f32),
            "edges": _spec((e_pad, cfg.d_edge_in), f32),
            "senders": _spec((e_pad,)),
            "receivers": _spec((e_pad,)),
            "edge_mask": _spec((e_pad,), torch.bool),
        }
        batch_in = {"graph": graph, "targets": _spec((n_pad, cfg.d_out), f32),
                    "node_mask": _spec((n_pad,), f32)}
        n_edges_step = e_pad
    elif shape.kind == "train_batched":
        bsz = 4 if smoke else shape["batch"]
        nn_, ne = (8, 12) if smoke else (shape["n_nodes"], shape["n_edges"])
        graph = {
            "nodes": _spec((bsz, nn_, d_feat), f32),
            "edges": _spec((bsz, ne, cfg.d_edge_in), f32),
            "senders": _spec((bsz, ne)),
            "receivers": _spec((bsz, ne)),
        }
        batch_in = {"graph": graph, "targets": _spec((bsz, nn_, cfg.d_out), f32)}
        n_edges_step = bsz * ne
    else:  # full-batch train
        nn_, ne = (32, 128) if smoke else (shape["n_nodes"], shape["n_edges"])
        ne_pad = _round_up(ne, 512 * 256)  # the reference's padding (edges over 512·256 devices)
        graph = {
            "nodes": _spec((nn_, d_feat), f32),
            "edges": _spec((ne_pad, cfg.d_edge_in), f32),
            "senders": _spec((ne_pad,)),
            "receivers": _spec((ne_pad,)),
            "edge_mask": _spec((ne_pad,), torch.bool),
        }
        batch_in = {"graph": graph, "targets": _spec((nn_, cfg.d_out), f32),
                    "node_mask": _spec((nn_,), f32)}
        n_edges_step = ne_pad

    params_shape = G.init(torch.Generator(), cfg, device=META)
    opt_cfg = AdamWConfig(lr=1e-3, moment_dtype=arch.train_moment_dtype)
    opt_shape = adamw_init(params_shape, opt_cfg)

    def train_step(params, opt_state, batch_):
        (loss, metrics), grads = G.value_and_grad(params, cfg, batch_)
        updates, opt_state = adamw_update(grads, opt_state, params, opt_cfg)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **metrics}

    n_params = cfg.params_count()
    meta = {
        "family": "gnn", "params_total": n_params, "params_active": n_params,
        "edges": n_edges_step,
        # per MP layer: edge MLP (3h->h->h) + node MLP (2h->h->h) matmuls
        "model_flops": 6 * n_edges_step * cfg.n_layers
        * (3 * cfg.d_hidden * cfg.d_hidden + cfg.d_hidden * cfg.d_hidden) * 2,
        "train": True,
    }
    return Cell(arch.arch_id, shape.name, shape.kind, train_step,
                (params_shape, opt_shape, batch_in), meta)


# ========================================================== recsys cells
def build_recsys_cell(arch: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> Cell:
    cfg: R.RecsysConfig = arch.smoke_model if smoke else arch.model
    batch = 8 if smoke else shape["batch"]
    f32 = torch.float32
    params_shape = R.init(torch.Generator(), cfg, device=META)

    def batch_inputs():
        if cfg.kind == "dlrm":
            return {"dense": _spec((batch, cfg.n_dense), f32),
                    "sparse": _spec((batch, cfg.n_sparse)),
                    "label": _spec((batch,), f32)}
        if cfg.kind == "two_tower":
            return {"user": _spec((batch,)), "item": _spec((batch,))}
        if cfg.kind == "bst":
            return {"seq": _spec((batch, cfg.seq_len)), "target": _spec((batch,)),
                    "label": _spec((batch,), f32)}
        return {"sparse": _spec((batch, cfg.n_sparse)), "label": _spec((batch,), f32)}

    n_params = cfg.params_count()
    meta = {
        "family": "recsys", "params_total": n_params, "params_active": n_params,
        "batch": batch, "train": shape.kind == "train",
        "model_flops": _recsys_flops(cfg, batch, shape.kind),
    }

    if shape.kind == "train":
        opt_cfg = AdamWConfig(lr=1e-3, moment_dtype=arch.train_moment_dtype)
        opt_shape = adamw_init(params_shape, opt_cfg)

        def train_step(params, opt_state, batch_):
            (loss, metrics), grads = R.value_and_grad(params, cfg, batch_)
            updates, opt_state = adamw_update(grads, opt_state, params, opt_cfg)
            params = apply_updates(params, updates)
            return params, opt_state, {"loss": loss, **metrics}

        return Cell(arch.arch_id, shape.name, shape.kind, train_step,
                    (params_shape, opt_shape, batch_inputs()), meta)

    if shape.kind == "serve":
        def serve_step(params, batch_):
            return R.serve_scores(params, cfg, batch_)

        return Cell(arch.arch_id, shape.name, shape.kind, serve_step,
                    (params_shape, batch_inputs()), meta)

    # retrieval: 1 query vs n_candidates — the paper's FD-SQ dataflow
    n_cand = 4096 if smoke else shape["n_candidates"]
    d_out = cfg.tower_mlp[-1] if cfg.kind == "two_tower" else cfg.embed_dim
    k = 16 if smoke else 100

    if cfg.kind == "two_tower":
        def retrieve(params, user_ids, candidates):
            return R.retrieve_topk(params, cfg, user_ids, candidates, k)
    else:
        # pointwise models score candidate id lists exhaustively: treat the
        # candidate matrix as precomputed item representations and rank by
        # inner product against the user's embedding row, zero-padded to
        # the candidates' width (the reference's generic path)
        @torch.no_grad()
        def retrieve(params, user_ids, candidates):
            u = R.embedding_lookup(params["embed"], user_ids)
            if u.shape[-1] != candidates.shape[-1]:
                u = torch.nn.functional.pad(u, (0, candidates.shape[-1] - u.shape[-1]))
            return R.mips_topk(u, candidates, k)

    meta = dict(meta)
    meta["model_flops"] = 2 * batch * n_cand * d_out
    meta["n_candidates"] = n_cand
    return Cell(arch.arch_id, shape.name, shape.kind, retrieve,
                (params_shape, _spec((batch,)), _spec((n_cand, d_out), f32)), meta)


def _recsys_flops(cfg: R.RecsysConfig, batch: int, kind: str) -> int:
    def mlp_f(dims):
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    if cfg.kind == "dlrm":
        f = mlp_f((cfg.n_dense,) + cfg.bot_mlp)
        n_int = cfg.n_sparse + 1
        f += 2 * n_int * n_int * cfg.embed_dim
        f += mlp_f((n_int * (n_int - 1) // 2 + cfg.bot_mlp[-1],) + cfg.top_mlp)
    elif cfg.kind == "two_tower":
        f = 2 * mlp_f((cfg.embed_dim,) + cfg.tower_mlp)
    elif cfg.kind == "bst":
        d = cfg.embed_dim
        f = 2 * cfg.seq_len * (4 * d * d) + 2 * cfg.seq_len * cfg.seq_len * d
        f += mlp_f((2 * d,) + cfg.top_mlp + (1,))
    else:
        f = mlp_f((cfg.n_sparse * cfg.embed_dim,) + cfg.top_mlp + (1,))
    per_example = f + 2 * cfg.n_sparse * cfg.embed_dim  # lookups
    mult = 3 if kind == "train" else 1  # fwd+bwd
    return batch * per_example * mult


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
    if arch.family == "gnn":
        return build_gnn_cell(arch, shape, smoke)
    if arch.family == "recsys":
        return build_recsys_cell(arch, shape, smoke)
    if arch.family == "knn":
        return build_knn_cell(arch, shape, smoke)
    raise ValueError(arch.family)
