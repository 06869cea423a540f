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

from typing import Iterator, NamedTuple

import numpy as np
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


def iter_partitions(vectors, rows_per_part: int, row_mult: int = LANE,
                    dim_mult: int = LANE) -> Iterator[PaddedDataset]:
    """Host-side generator of equal padded partitions (paper arrow 3).

    Every partition has the same padded shape, the last one included, so a
    streamed scan sees one shape throughout. ``vectors`` is a numpy array
    or a tensor; each partition lies on its device.
    """
    v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
        np.asarray(vectors, dtype=np.float32))
    n = v.shape[0]
    rows_per_part = round_up(rows_per_part, row_mult)
    for start in range(0, n, rows_per_part):
        chunk = pad_rows(v[start: start + rows_per_part].to(torch.float32), rows_per_part)
        p = make_padded(chunk, base_index=start, row_mult=row_mult, dim_mult=dim_mult)
        # validity follows the true rows of the last, short chunk
        n_valid = min(rows_per_part, n - start)
        p.norms[n_valid:] = torch.inf
        yield PaddedDataset(p.vectors, p.norms, n_valid, start)
