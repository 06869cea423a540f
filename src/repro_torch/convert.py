"""Carry search state and LM parameters from the JAX package into the port.

Every function takes plain arrays (anything ``np.asarray`` reads, so a JAX
device array works) and never imports JAX or ``repro``: the JAX engine is
duck-typed. The parity tests use them so that both packages search the
identical padded state — the same vectors, the same +inf norms, the same
pre-normalised cos rows, the same int8 codes and side channels — and run
an LM on the same weights, bf16 bits carried unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import ExactKNN, resolve_device
from repro_torch.core.partition import PaddedDataset
from repro_torch.core.quantized import QuantizedDataset
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.store import DatasetStore

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
