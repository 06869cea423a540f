"""Carry search state from the JAX package into the port.

Both functions take plain arrays (anything ``np.asarray`` reads, so a JAX
device array works) and never import JAX or ``repro``: the JAX engine is
duck-typed. The parity tests use them so that both packages search the
identical padded state — the same vectors, the same +inf norms, the same
pre-normalised cos rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import ExactKNN, resolve_device
from repro_torch.core.partition import PaddedDataset

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


def engine_state_from_jax(jax_engine, device=None) -> ExactKNN:
    """A port engine over a fitted JAX ``ExactKNN``'s resident arrays.

    Reads the JAX engine's configuration (k, metric, backend, chunking,
    dtype) and its resident padded view — vectors (already L2-normalised
    when the JAX engine serves cos through its fused kernel) and norms
    with +inf on padding — and attaches them unchanged. Filter masks fold
    onto the same norms channel at search time. ``device`` is taken as
    :class:`ExactKNN` takes it: ``None`` means CUDA, which must exist.
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
    )
    eng._attach(padded.vectors, padded.norms, padded.n_valid,
                prenormalized=bool(getattr(jax_engine, "_cos_prenormalized", False)))
    return eng
