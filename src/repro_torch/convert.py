"""Carry search state, model parameters and training state between the JAX
package and the port.

Every function takes plain arrays (anything ``np.asarray`` reads, so a JAX
device array works) and never imports JAX or ``repro``: the JAX engine is
duck-typed. The parity tests use them so that both packages search the
identical padded state — the same vectors, the same +inf norms, the same
pre-normalised cos rows, the same int8 codes and side channels — and run
and train an LM, a recommender or MeshGraphNet on the same weights and
optimizer state, bf16 bits carried unchanged.

Training state goes both ways in the reference's layout
(``repro_torch.tree.reference_layout``: the param tree with layer weights
stacked on a leading L axis, ``AdamWState`` as (step, m, v), an int8 moment
as (q, scale)), the same leaves a checkpoint of either package holds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.engine import ExactKNN, resolve_device
from repro_torch.core.partition import PaddedDataset
from repro_torch.core.quantized import QuantizedDataset
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.store import DatasetStore
from repro_torch.tree import reference_layout, tree_leaves, tree_map

_BACKENDS = {"xla": "torch", "pallas": "cuda"}


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def padded_from_numpy(vectors, norms, n_valid: int, base_index: int = 0,
                      device=None) -> PaddedDataset:
    """The port's PaddedDataset over the arrays of a JAX PaddedDataset.

    ``device=None`` means CUDA and raises ``RuntimeError`` without one; pass
    ``device="cpu"`` to build the state on the CPU.
    """
    device = resolve_device(device)
    return PaddedDataset(_tensor(vectors, device), _tensor(norms, device).to(torch.float32),
                         int(n_valid), int(base_index))


def quantized_from_numpy(q, scales, err, norms_sq, qnorm_sq, device=None) -> QuantizedDataset:
    """The port's QuantizedDataset over the arrays of a JAX one (codes int8,
    channels f32), so both packages scan identical codes. ``device`` as in
    :func:`padded_from_numpy`."""
    device = resolve_device(device)
    codes = _tensor(q, device)
    if codes.dtype != torch.int8:
        raise ValueError(f"int8 codes expected, got {codes.dtype}")
    return QuantizedDataset(codes, *(_tensor(a, device).to(torch.float32)
                                     for a in (scales, err, norms_sq, qnorm_sq)))


def store_from_numpy(jax_store, pin_memory: bool = False) -> DatasetStore:
    """The port's host-RAM store over a JAX ``DatasetStore``'s per-shard
    arrays, so both packages stream the identical padded state.

    Reads, per main shard, the f32 vectors and norms (+inf on padding) with
    their n_valid and base index (``read_shard(i, "f32")``), and, when the
    store has its int8 tier, the codes, scales, err, norms_sq and qnorm_sq
    of that shard. The shards stay on the host, page-locked with
    ``pin_memory=True`` (which needs a CUDA device).
    """
    shards = []
    for i in range(int(jax_store.n_shards)):
        p = jax_store.read_shard(i, "f32")
        shards.append(padded_from_numpy(p.vectors, p.norms, p.n_valid, p.base_index,
                                        device="cpu"))
    int8 = None
    if jax_store.has_tier("int8"):
        int8 = [quantized_from_numpy(*q8, device="cpu") for q8 in jax_store._int8]
    store = DatasetStore(shards, int8=int8)
    return store.pin() if pin_memory else store


def engine_state_from_jax(jax_engine, device=None) -> ExactKNN:
    """A port engine over a fitted JAX ``ExactKNN``'s resident arrays.

    Reads the JAX engine's configuration (k, metric, backend, chunking,
    dtype) and its resident padded view — vectors (already L2-normalised
    when the JAX engine serves cos through its fused kernel) and norms
    with +inf on padding — and attaches them unchanged, with its int8 view
    (codes, scales, err, norms_sq, qnorm_sq) when it has enabled one.
    Filter masks fold onto the same norms channels at search time.
    ``device`` is taken as :class:`ExactKNN` takes it: ``None`` means CUDA,
    which must exist.
    """
    device = resolve_device(device)
    ds = jax_engine._ds
    if ds is None:
        raise ValueError("the JAX engine has no resident view (fit it first)")
    padded = padded_from_numpy(ds.vectors, ds.norms, ds.n_valid, ds.base_index, device)
    eng = ExactKNN(
        k=jax_engine.k, metric=jax_engine.metric,
        backend=_BACKENDS[jax_engine.backend], chunk_rows=jax_engine.chunk_rows,
        n_partitions=jax_engine.n_partitions, dtype=padded.vectors.dtype,
        device=device,
        rescore_factor=jax_engine.rescore_factor,
    )
    eng._attach(padded.vectors, padded.norms, padded.n_valid,
                prenormalized=bool(getattr(jax_engine, "_cos_prenormalized", False)))
    q8 = getattr(jax_engine, "_int8", None)
    if q8 is not None:
        eng._int8 = quantized_from_numpy(*q8, device=device)
    return eng


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def lm_params_from_numpy(params, cfg: T.LMConfig, device=None) -> T.Transformer:
    """The port's LM over a reference param tree (``repro.models.transformer
    .init``'s layout: layer weights stacked on a leading L axis).

    The stack is split into one ``Block`` a layer; every weight keeps the
    reference's (in, out) layout (``wq (d, H·dh)``, ``wo (H·dh, d)``,
    ``head (d, V_padded)``, ``moe.w_gate (E, d, de)``, the router in f32) and
    its dtype, bf16 bits unchanged. ``device`` as in
    :func:`padded_from_numpy`.
    """
    device = resolve_device(device)
    p = _numpy_tree(params)
    lay = p["layers"]

    def block(i):
        def at(group):
            return {k: _tensor(v[i], device) for k, v in lay[group].items()}

        ffn = ({"moe": L.MoE(**at("moe"))} if cfg.is_moe else {"mlp": L.MLP(**at("mlp"))})
        return T.Block(L.RMSNorm(**at("ln1")), L.RMSNorm(**at("ln2")),
                       L.Attention(**at("attn")), **ffn)

    return T.Transformer(cfg, _tensor(p["embed"], device), [block(i) for i in range(cfg.n_layers)],
                         L.RMSNorm(_tensor(p["final_norm"]["scale"], device)),
                         _tensor(p["head"], device))


def _tensor_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensor_tree(v, device) for v in tree)
    return _tensor(tree, device)


def recsys_params_from_numpy(params, device=None) -> dict:
    """The port's recommender params over a reference param tree
    (``repro.models.recsys.init``'s layout: the fused table, MLPs as lists
    of ``{"w", "b"}``): the same tree of tensors, each leaf's dtype and
    bits unchanged. ``device`` as in :func:`padded_from_numpy`."""
    return _tensor_tree(params, resolve_device(device))


def gnn_params_from_numpy(params, device=None) -> dict:
    """The port's MeshGraphNet params over a reference param tree
    (``repro.models.gnn.init``'s layout: ``procs`` stacked on a leading L
    axis, as the port holds it). ``device`` as in :func:`padded_from_numpy`."""
    return _tensor_tree(params, resolve_device(device))


def state_to_numpy(tree, bf16=None):
    """A port tree (a ``Transformer``, an ``AdamWState`` of its moments,
    gradients by parameter name, tuples of these) as the reference's numpy
    tree: the same nesting, stacked layer leaves, the port's NamedTuples
    (``AdamWState``, ``_Q8``) holding numpy arrays. bf16 leaves are their
    bits as ``uint16``, or viewed as ``bf16`` when given a numpy bfloat16
    dtype (the reference's ``jnp.bfloat16``; the port does not import
    ``ml_dtypes``)."""
    def leaf(x):
        a = ckpt.host_array(x)
        if bf16 is not None and ckpt.dtype_name(x) == "bfloat16":
            a = a.view(bf16)
        return a

    return tree_map(leaf, reference_layout(tree))


def state_from_numpy(tree, template):
    """Write a reference numpy tree (``repro``'s params, ``AdamWState``,
    anything in the reference's layout) into the port ``template`` of the
    same layout, in place, each leaf cast to the template's dtype; returns
    ``template``. Leaf count and shapes are checked first."""
    src = [np.asarray(a) for a in tree_leaves(tree)]
    return ckpt.restore(template, [
        (a.shape, a.dtype.name,  # "bfloat16" for an ml_dtypes array: its bits
         lambda a=a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a) for a in src])


def adamw_state_from_numpy(state, params):
    """The port's ``AdamWState`` for ``params`` (a ``Transformer`` or a tree
    of tensors — recommender and GNN params —, whose device it takes) over a reference ``AdamWState``: its
    step and its f32, bf16 or int8 (``_Q8``) moments, bits unchanged."""
    first = state.m
    while isinstance(first, (dict, list)):  # down to the first leaf or _Q8
        first = first[sorted(first)[0]] if isinstance(first, dict) else first[0]
    if isinstance(first, tuple) and getattr(first, "_fields", None) == ("q", "scale"):
        moments = "int8"
    elif np.asarray(first).dtype.name == "bfloat16":
        moments = "bf16"
    else:
        moments = "f32"
    return state_from_numpy(state, adamw_init(params, AdamWConfig(moment_dtype=moments)))

