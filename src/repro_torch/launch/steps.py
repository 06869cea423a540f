"""Cell builder: (architecture x shape) -> step function + input shapes +
partition specs + the dims the roofline reads, for every family (LM, GNN,
recsys, kNN). Shared by the training driver, the dry run, the examples and
the tests (smoke=True swaps in the reduced model and tiny dims but runs the
same step code).

A Cell bundles:
    fn         step callable (params-first)
    inputs     positional args as meta tensors (trees of them): shapes and
               dtypes, nothing allocated
    in_specs   tree of ``runtime.sharding.P`` matching fn's positional args
    out_specs  tree of P for its outputs
    meta       dims used by the roofline (params, tokens, model flops, ...)

The specs are the reference's, computed against the mesh active while the
cell is built (``repro_torch.core.mesh.use_mesh``; replicated without one)
and given in the reference's layout: a ``Transformer``'s parameters and
moments as ``repro_torch.tree.reference_layout`` lays them out, each layer
leaf stacked on a leading L axis. ``fn`` reads the mesh active when it is
called, as the reference's traced step does: the models take their
sharded branches there, and the kNN cells run ``core.sharded``'s
functions over the mesh's positions, on the card's kernels on a CUDA mesh
(``backend="cuda"``) and on the plain steps on a CPU one. The train step
updates the parameters and the optimizer state in place (``optim.adamw``)
and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.mesh import current_mesh
from repro_torch.core.topk import TopK
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.sampler import edge_budget
from repro_torch.optim import adamw_init, adamw_update, apply_updates
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.sharding import P, resolve, sanitize_spec, sanitize_tree
from repro_torch.tree import reference_layout, tree_map

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    inputs: tuple  # positional args as meta tensors (trees of them)
    in_specs: tuple
    out_specs: Any
    meta: dict


def _spec(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _replicated(tree):
    return tree_map(lambda _: P(), tree)


def _opt_specs(param_specs_tree, opt_shapes):
    """AdamWState spec tree: moments mirror param specs (same ZeRO-3/TP
    sharding); int8 _Q8 scale vectors replicate size-1 axes. param specs
    lead the map so one spec leaf covers a whole _Q8(q, scale) subtree."""

    def fix(shape_leaf, spec):
        sp = list(spec) + [None] * (len(shape_leaf.shape) - len(spec))
        for i, dim in enumerate(shape_leaf.shape):
            if dim == 1:
                sp[i] = None
        return P(*sp[: len(shape_leaf.shape)])

    def expand(spec_leaf, opt_subtree):
        return tree_map(lambda leaf: fix(leaf, spec_leaf), opt_subtree)

    m = tree_map(expand, param_specs_tree, opt_shapes.m)
    v = tree_map(expand, param_specs_tree, opt_shapes.v)
    return type(opt_shapes)(step=P(), m=m, v=v)


def _mesh():
    return current_mesh()


def _san(shape_tuple, spec):
    """Divisibility-sanitize a spec against the active mesh (P() meshless)."""
    m = _mesh()
    if not m:
        return P()
    return sanitize_spec(shape_tuple, spec, dict(m.shape))


def _axsize(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(mesh.shape[e] for e in entry)
    return mesh.shape[entry]


def _backend(mesh) -> str:
    """The kNN steps on a mesh: the card's kernels on a CUDA mesh, the
    plain steps elsewhere."""
    return "cuda" if mesh.first.type == "cuda" else "torch"


# ============================================================== LM cells
def build_lm_cell(arch: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> Cell:
    cfg: T.LMConfig = arch.smoke_model if smoke else arch.model
    if smoke:
        batch, seq = {"train": (2, 16), "prefill": (2, 32), "decode": (2, 64)}[shape.kind]
    else:
        batch, seq = shape["global_batch"], shape["seq_len"]

    params_shape = T.init(torch.Generator(), cfg, device=META)
    params_layout = reference_layout(params_shape)
    training = shape.kind == "train"
    pspecs = (sanitize_tree(params_layout, T.param_specs(cfg, training=training), _mesh())
              if _mesh() else _replicated(params_layout))

    if shape.kind == "train":
        opt_cfg = AdamWConfig(lr=1e-4, moment_dtype=arch.train_moment_dtype)
        opt_shape = adamw_init(params_shape, opt_cfg)
        opt_layout = reference_layout(opt_shape)
        ospecs = _opt_specs(pspecs, opt_layout) if _mesh() else _replicated(opt_layout)
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
        bspecs = _lm_batch_specs() if _mesh() else {"tokens": P(), "labels": P()}
        metrics_specs = {"loss": P(), "nll": P(), "moe_aux": P()}
        return Cell(arch.arch_id, shape.name, shape.kind, train_step,
                    (params_shape, opt_shape, batch_in),
                    (pspecs, ospecs, bspecs),
                    (pspecs, ospecs, metrics_specs),
                    _lm_meta(cfg, batch, seq, train=True))

    if shape.kind == "prefill":
        # 32k prefill: wider flash tiles, as the reference's cell has them
        cfg = dataclasses.replace(cfg, q_block=2048, kv_block=2048)

        def prefill_step(params, tokens):
            return T.prefill(params, cfg, tokens)

        b = resolve(("batch",))[0]
        out_specs = (P(b, None), _cache_specs(cfg, batch, seq))
        return Cell(arch.arch_id, shape.name, shape.kind, prefill_step,
                    (params_shape, _spec((batch, seq))),
                    (pspecs, P(b, None) if _mesh() else P()),
                    out_specs if _mesh() else None,
                    _lm_meta(cfg, batch, seq, train=False))

    # decode (decode_32k / long_500k): one new token against a seq_len cache
    cache_shape = T.init_cache(cfg, batch, seq, device=META)
    cache_sp = _cache_specs(cfg, batch, seq) if _mesh() else _replicated(cache_shape)

    def decode(params, cache, tokens):
        return T.decode_step(params, cfg, cache, tokens)

    b = resolve(("batch",))[0]
    tok_sp = _san((batch, 1), P(b, None))
    logit_sp = _san((batch, cfg.vocab_padded), P(b, None))
    return Cell(arch.arch_id, shape.name, shape.kind, decode,
                (params_shape, cache_shape, _spec((batch, 1))),
                (pspecs, cache_sp, tok_sp),
                (logit_sp, cache_sp),
                _lm_meta(cfg, batch, seq, train=False, decode=True))


def _lm_batch_specs():
    b = resolve(("batch",))[0]
    return {"tokens": P(b, None), "labels": P(b, None)}


def _cache_specs(cfg: T.LMConfig, batch: int, seq: int):
    """(L, B, S, KV, dh): batch over data axes when divisible, else the
    sequence shards over `model` (long-context single-request case)."""
    if not _mesh():
        return {"k": P(), "v": P(), "len": P()}
    b_ax = resolve(("batch",))[0]
    tp = resolve(("heads",))[0]
    mesh = _mesh()
    b_div = batch % _axsize(mesh, b_ax) == 0 if b_ax else False
    kv_div = cfg.n_kv_heads % _axsize(mesh, tp) == 0 if tp else False
    b_entry = b_ax if b_div else None
    if kv_div:
        sp = P(None, b_entry, None, tp, None)
    else:
        sp = P(None, b_entry, tp, None, None)  # shard the cache sequence
    return {"k": sp, "v": sp, "len": P()}


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
    pspecs = _replicated(params_shape)  # GNN MLPs are tiny -> replicate
    opt_cfg = AdamWConfig(lr=1e-3, moment_dtype=arch.train_moment_dtype)
    opt_shape = adamw_init(params_shape, opt_cfg)
    ospecs = _replicated(opt_shape)

    e_ax = resolve(("edges",))[0] if _mesh() else None
    bspecs = _replicated(batch_in)
    if _mesh():
        g = dict(bspecs["graph"])
        for k in ("edges", "senders", "receivers", "edge_mask"):
            if k in g:
                g[k] = P(e_ax, *([None] * (len(batch_in["graph"][k].shape) - 1)))
        if shape.kind == "train_batched":
            b_ax = resolve(("batch",))[0]
            g = {k: P(b_ax, *([None] * (len(v.shape) - 1)))
                 for k, v in batch_in["graph"].items()}
            bspecs = {"graph": g, "targets": P(b_ax, None, None)}
        else:
            bspecs = dict(bspecs)
            bspecs["graph"] = g

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
                (params_shape, opt_shape, batch_in),
                (pspecs, ospecs, bspecs),
                (pspecs, ospecs, {"loss": P(), "mse": P()}),
                meta)


# ========================================================== recsys cells
def build_recsys_cell(arch: ArchConfig, shape: ShapeSpec, smoke: bool = False) -> Cell:
    cfg: R.RecsysConfig = arch.smoke_model if smoke else arch.model
    batch = 8 if smoke else shape["batch"]
    f32 = torch.float32
    params_shape = R.init(torch.Generator(), cfg, device=META)
    pspecs = (sanitize_tree(params_shape, R.param_specs(cfg), _mesh()) if _mesh()
              else _replicated(params_shape))

    def batch_inputs():
        b_ax = resolve(("batch",))[0] if _mesh() else None
        if cfg.kind == "dlrm":
            ins = {"dense": _spec((batch, cfg.n_dense), f32),
                   "sparse": _spec((batch, cfg.n_sparse)),
                   "label": _spec((batch,), f32)}
        elif cfg.kind == "two_tower":
            ins = {"user": _spec((batch,)), "item": _spec((batch,))}
        elif cfg.kind == "bst":
            ins = {"seq": _spec((batch, cfg.seq_len)), "target": _spec((batch,)),
                   "label": _spec((batch,), f32)}
        else:
            ins = {"sparse": _spec((batch, cfg.n_sparse)), "label": _spec((batch,), f32)}
        specs = {k: P(b_ax, *([None] * (len(v.shape) - 1))) for k, v in ins.items()}
        return ins, specs

    n_params = cfg.params_count()
    meta = {
        "family": "recsys", "params_total": n_params, "params_active": n_params,
        "batch": batch, "train": shape.kind == "train",
        "model_flops": _recsys_flops(cfg, batch, shape.kind),
    }

    if shape.kind == "train":
        opt_cfg = AdamWConfig(lr=1e-3, moment_dtype=arch.train_moment_dtype)
        opt_shape = adamw_init(params_shape, opt_cfg)
        ospecs = _opt_specs(pspecs, opt_shape) if _mesh() else _replicated(opt_shape)
        ins, bspecs = batch_inputs()

        def train_step(params, opt_state, batch_):
            (loss, metrics), grads = R.value_and_grad(params, cfg, batch_)
            updates, opt_state = adamw_update(grads, opt_state, params, opt_cfg)
            params = apply_updates(params, updates)
            return params, opt_state, {"loss": loss, **metrics}

        mkeys = {"two_tower": "nll"}.get(cfg.kind, "bce")
        return Cell(arch.arch_id, shape.name, shape.kind, train_step,
                    (params_shape, opt_shape, ins),
                    (pspecs, ospecs, bspecs),
                    (pspecs, ospecs, {"loss": P(), mkeys: P()}),
                    meta)

    if shape.kind == "serve":
        ins, bspecs = batch_inputs()

        def serve_step(params, batch_):
            return R.serve_scores(params, cfg, batch_)

        b_ax = resolve(("batch",))[0] if _mesh() else None
        return Cell(arch.arch_id, shape.name, shape.kind, serve_step,
                    (params_shape, ins), (pspecs, bspecs), P(b_ax), meta)

    # retrieval: 1 query vs n_candidates — the paper's FD-SQ dataflow
    n_cand = 4096 if smoke else shape["n_candidates"]
    d_out = cfg.tower_mlp[-1] if cfg.kind == "two_tower" else cfg.embed_dim
    k = 16 if smoke else 100
    rows_ax = resolve(("rows",))[0] if _mesh() else None

    if cfg.kind == "two_tower":
        def retrieve(params, user_ids, candidates):
            mesh = _mesh()
            rows = resolve(("rows",))[0] if mesh else None
            if rows is None:
                return R.retrieve_topk(params, cfg, user_ids, candidates, k)
            # the reference's P(rows, None) candidates, made explicit: each
            # position scans its row block, the queues merge exactly
            from repro_torch.core.distance import row_norms_sq
            from repro_torch.core.sharded import fdsq_sharded

            with torch.no_grad():
                u = R._two_tower_embed(params, cfg, user_ids, "user_tower")
                return fdsq_sharded(mesh, k, "ip", (rows,) if isinstance(rows, str) else rows,
                                    backend=_backend(mesh))(
                    u, candidates, row_norms_sq(candidates))
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
                (params_shape, _spec((batch,)), _spec((n_cand, d_out), f32)),
                (pspecs, P(None), P(rows_ax, None)), TopK(P(), P()), meta)


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
    from repro_torch.core import sharded as S

    if smoke:
        n, d, m, k = 2048, 128, 4, 16
    else:
        n, d, m, k = shape["n"], shape["d"], shape["m"], shape["k"]
    d_pad = _round_up(d, 128)
    mesh = _mesh()
    total = mesh.size if mesh else 256
    n_pad = _round_up(n, 128 * total)

    data_axes = ("data", "model") if not mesh or "pod" not in mesh.axis_names \
        else ("pod", "data", "model")
    # queries shard over `data` only (the mesh functions' contract);
    # sanitized for small m (e.g. GIST m=16 on the multi-pod mesh).
    q_sp = _san((m, d_pad), P("data", None))
    q_ax = q_sp[0] if mesh else None

    if shape.kind == "knn_fdsq":
        def fn(qv, vecs, norms):
            mesh_ = _mesh()
            if mesh_ is None:
                from repro_torch.core.fdsq import fdsq_search
                return fdsq_search(qv, vecs, norms, k, "l2", 4)
            return S.fdsq_sharded(mesh_, k, "l2", data_axes, chunk_rows=None,
                                  backend=_backend(mesh_))(qv, vecs, norms)
        in_specs = (P(), P(data_axes), P(data_axes))
        out_specs = TopK(P(), P())
    elif shape.kind in ("knn_ring", "knn_ring_q"):
        ring = S.fqsd_ring_queries if shape.kind == "knn_ring_q" else S.fqsd_ring

        def fn(qv, vecs, norms):
            mesh_ = _mesh()
            if mesh_ is None:
                from repro_torch.core.fqsd import fqsd_scan
                return fqsd_scan(qv, vecs, norms, k, "l2", 256)
            return ring(mesh_, k, "l2", "data", "model", backend=_backend(mesh_))(
                qv, vecs, norms)
        in_specs = (P(q_ax), P(("data", "model")), P(("data", "model")))
        out_specs = TopK(P(q_ax), P(q_ax))
    else:  # knn_fqsd
        def fn(qv, vecs, norms):
            mesh_ = _mesh()
            if mesh_ is None:
                from repro_torch.core.fqsd import fqsd_scan
                return fqsd_scan(qv, vecs, norms, k, "l2", 256)
            return S.fqsd_sharded(mesh_, k, "l2", "data", "model",
                                  backend=_backend(mesh_))(qv, vecs, norms)
        in_specs = (P(q_ax), P("model"), P("model"))
        out_specs = TopK(P(q_ax), P(q_ax))

    meta = {
        "family": "knn", "params_total": 0, "params_active": 0,
        "model_flops": 2 * m * n * d + m * n,  # GEMM + epilogue
        "n": n, "d": d, "m": m, "k": k, "train": False,
        "dataset_bytes": n_pad * d_pad * 4,
    }
    f32 = torch.float32
    return Cell(arch.arch_id, shape.name, shape.kind, fn,
                (_spec((m, d_pad), f32), _spec((n_pad, d_pad), f32), _spec((n_pad,), f32)),
                in_specs, out_specs, meta)


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
