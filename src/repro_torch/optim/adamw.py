"""AdamW with selectable moment precision: f32 | bf16 | int8.

int8 moments use symmetric per-row (last axis) quantization with
round-to-nearest; the quantization error is small relative to Adam's EMA
noise and cuts the optimizer state by 4x / 8x.

The arithmetic is the reference's (``repro.optim.adamw``) op for op: f32
math, the update cast to the param's dtype, then ``(p.f32 + u.f32)`` cast
back. What differs is the PyTorch idiom around it:

* ``params`` is a tree of tensors (``repro_torch.tree``) or an
  ``nn.Module``, whose moments and updates are dicts by parameter name
  (``named_parameters``) and whose gradients come the same way
  (``models.transformer.value_and_grad``);
* the step is in place, as ``torch.optim``'s: ``adamw_update`` writes the
  new moments into the state's tensors and ``apply_updates`` the new
  values into the parameters (a full-width model has no room for a second
  copy of either);
* a leaf of more than ``CHUNK_ELEMS`` elements (an embedding table) is
  updated in row chunks, so the update's f32 temporaries take a chunk's
  size, not the leaf's: the ops are elementwise, so the bits are the
  whole-leaf update's;
* weight decay goes by the rank of the reference's leaf: a module that
  stacks nothing (the port's ``Transformer`` holds one tensor a layer where
  the reference stacks L of them) says so through ``reference_ndim(name)``,
  so ``ln1``/``ln2`` scales and QKV biases, (L, d) there, are decayed and
  ``final_norm``'s (d,) is not, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


class _Q8(NamedTuple):
    """Int8-quantized tensor: q * scale, scale per last-axis row."""

    q: torch.Tensor  # int8
    scale: torch.Tensor  # f32, shape = q.shape[:-1] + (1,) (or () for scalars)


def _q8_encode(x: torch.Tensor) -> _Q8:
    if x.ndim == 0:
        s = torch.clamp_min(torch.abs(x) / 127.0, 1e-12)
        return _Q8(torch.round(x / s).to(torch.int8), s)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    s = torch.clamp_min(amax / 127.0, 1e-12)
    return _Q8(torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s)


def _q8_decode(z: _Q8) -> torch.Tensor:
    return z.q.to(F32) * z.scale


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, ()
    m: Any  # tree matching params (f32/bf16 tensors or _Q8)
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float | None = 1.0
    moment_dtype: str = "f32"  # f32 | bf16 | int8


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "f32":
        return x.to(F32)
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        return _q8_encode(x)
    raise ValueError(dtype)


def _decode(x) -> torch.Tensor:
    if isinstance(x, _Q8):
        return _q8_decode(x)
    return x.to(F32)


def _store(dst, x: torch.Tensor, dtype: str) -> None:
    """Encode ``x`` into the moment ``dst`` in place."""
    if isinstance(dst, _Q8):
        new = _q8_encode(x)
        dst.q.copy_(new.q)
        dst.scale.copy_(new.scale)
    else:
        dst.copy_(_encode(x, dtype))


def _tree(params):
    """The tree the moments mirror: a module's parameters by name."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def _ndims(params):
    """The rank of each parameter's leaf in the reference's tree."""
    tree = _tree(params)
    if hasattr(params, "reference_ndim"):
        return {name: params.reference_ndim(name) for name in tree}
    return tree_map(lambda p: p.ndim, tree)


#: Elements of a leaf updated at once: a larger leaf (an embedding table)
#: is updated in row chunks, so the update's f32 temporaries take a chunk's
#: size and not the leaf's. The ops are elementwise: the bits are the same.
CHUNK_ELEMS = 1 << 26


def _chunk_rows(p: torch.Tensor) -> int:
    """Rows of ``p`` (of rank >= 2) a chunk of the update takes. A leaf of
    lower rank is updated whole: an int8 moment of a vector has one scale
    for the whole of it."""
    return max(1, CHUNK_ELEMS // max(1, p[0].numel()))


def _rows(x, sl: slice):
    """Rows ``sl`` of a moment: views, so a store into them writes the
    moment in place (an int8 moment's scales are per row)."""
    return _Q8(x.q[sl], x.scale[sl]) if isinstance(x, _Q8) else x[sl]


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    tree = _tree(params)
    zeros = lambda p: _encode(torch.zeros(p.shape, dtype=F32, device=p.device),  # noqa: E731
                              cfg.moment_dtype)
    device = tree_leaves(tree)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, tree), v=tree_map(zeros, tree))


def _global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig = AdamWConfig()):
    """Returns (updates, new_state). updates are -lr-scaled deltas in each
    param's dtype; the new state holds the old state's moment tensors,
    overwritten in place, and a new step."""
    step = state.step + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    tree = _tree(params)

    scale = None
    if cfg.grad_clip is not None:
        gn = _global_norm(grads)
        scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-12), 1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(F32))
    bc2 = 1.0 - torch.pow(b2, step.to(F32))

    def upd_rows(g, m, v, p, decay):
        # the reference's clip multiplies by an f32 array, so the clipped
        # gradient is f32 whatever the param's dtype
        g32 = g.to(F32) if scale is None else g.to(F32) * scale
        m32 = b1 * _decode(m) + (1 - b1) * g32
        v32 = b2 * _decode(v) + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.to(F32)
        _store(m, m32, cfg.moment_dtype)
        _store(v, v32, cfg.moment_dtype)
        return (-lr * delta).to(p.dtype)

    def upd(g, m, v, p, ndim):
        decay = bool(cfg.weight_decay) and ndim >= 2  # no decay on norms/biases
        rows = _chunk_rows(p) if p.ndim >= 2 else None
        if rows is None or rows >= p.shape[0]:
            return upd_rows(g, m, v, p, decay)
        out = torch.empty_like(p)
        for s in range(0, p.shape[0], rows):
            sl = slice(s, s + rows)
            out[sl] = upd_rows(g[sl], _rows(m, sl), _rows(v, sl), p[sl], decay)
        return out

    updates = tree_map(upd, grads, state.m, state.v, tree, _ndims(params))
    return updates, AdamWState(step=step, m=state.m, v=state.v)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates`` in f32, cast back, written into the parameters
    in place; returns ``params``."""
    def one(p, u):
        p.copy_((p.to(F32) + u.to(F32)).to(p.dtype))

    tree_map(one, _tree(params), updates)
    return params
