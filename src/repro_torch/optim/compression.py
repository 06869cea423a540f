"""Gradient compression for the DP all-reduce: int8 + error feedback.

compress_int8 quantizes per last-axis row to int8 (4x fewer wire bytes),
and ErrorFeedback keeps the quantization residual locally so that the bias
vanishes over steps (EF-SGD, arXiv:1901.09847). The arithmetic is the
reference's (``repro.optim.compression``): the same codes and scales.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map


class Compressed(NamedTuple):
    q: torch.Tensor  # int8
    scale: torch.Tensor  # f32 per leading row


def compress_int8(x: torch.Tensor) -> Compressed:
    if x.ndim == 0:
        s = torch.clamp_min(torch.abs(x) / 127.0, 1e-12)
        return Compressed(torch.round(x / s).to(torch.int8), s)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    s = torch.clamp_min(amax / 127.0, 1e-12)
    return Compressed(torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s)


def decompress_int8(c: Compressed) -> torch.Tensor:
    return c.q.to(torch.float32) * c.scale


class ErrorFeedback(NamedTuple):
    residual: Any  # tree of f32, mirrors grads

    @staticmethod
    def init(grads) -> "ErrorFeedback":
        return ErrorFeedback(tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def compress_with_feedback(grads, ef: ErrorFeedback):
    """Returns (compressed tree, new_ef). Decompress-side is lossless."""

    def one(g, r):
        corrected = g.to(torch.float32) + r
        c = compress_int8(corrected)
        return c, corrected - decompress_int8(c)

    out = tree_map(one, grads, ef.residual)
    comp = tree_map(lambda g, o: o[0], grads, out)
    resid = tree_map(lambda g, o: o[1], grads, out)
    return comp, ErrorFeedback(resid)


def decompress_tree(comp, template):
    return tree_map(lambda t, c: decompress_int8(c).to(t.dtype), template, comp)
