"""Dataset padding (paper section 3.2 alignment rules), on torch tensors.

The dataset is padded once, at fit time, never per query:

* rows are padded to a multiple of the kernel's n-tile (``LANE`` times the
  partition count), and padded rows carry a +inf norm, so they can never
  enter a kNN queue;
* the feature dim is padded with zeros to a multiple of ``LANE``, which is
  exact for every metric.

Padding happens on the device the vectors already live on: a dataset
generated on the card is padded there, with no host copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distance import row_norms_sq

LANE = 128  # row and feature alignment; a multiple of every kernel tile edge


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def next_pow2(v: int) -> int:
    """Smallest power of two >= v (>= 1). Queue widths round up to this."""
    p = 1
    while p < v:
        p <<= 1
    return p


class PaddedDataset(NamedTuple):
    """An alignment-padded dataset partition, resident on one device."""

    vectors: torch.Tensor  # (n_pad, d_pad)
    norms: torch.Tensor  # (n_pad,) f32 — +inf on padded rows
    n_valid: int  # true row count
    base_index: int  # global index of row 0


def pad_dim(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Zero-pad the last axis to ``d_pad`` (returns ``x`` itself if aligned)."""
    d = x.shape[-1]
    if d == d_pad:
        return x
    if d > d_pad:
        raise ValueError(f"d={d} exceeds padded dim {d_pad}")
    out = x.new_zeros((*x.shape[:-1], d_pad))
    out[..., :d] = x
    return out


def pad_rows(x: torch.Tensor, n_pad: int, value: float = 0.0) -> torch.Tensor:
    """Pad the first axis to ``n_pad`` rows of ``value`` (``x`` if aligned)."""
    n = x.shape[0]
    if n == n_pad:
        return x
    out = x.new_full((n_pad, *x.shape[1:]), value)
    out[:n] = x
    return out


def aligned_shape(n: int, d: int, row_mult: int = LANE, dim_mult: int = LANE):
    return round_up(max(n, 1), row_mult), round_up(d, dim_mult)


def make_padded(
    vectors: torch.Tensor, base_index: int = 0, row_mult: int = LANE,
    dim_mult: int = LANE,
) -> PaddedDataset:
    """Pad one partition on its own device; padded rows get a +inf norm.

    For ``ip``/``cos`` the padded rows are zero vectors scoring 0 / 1; the
    executors mask on the norms channel, so they still never enter a queue.
    """
    n, d = vectors.shape
    n_pad, d_pad = aligned_shape(n, d, row_mult, dim_mult)
    v = vectors.new_zeros((n_pad, d_pad))
    v[:n, :d] = vectors
    norms = row_norms_sq(v)
    norms[n:] = torch.inf
    return PaddedDataset(v, norms, n, base_index)
