"""Sorted per-split queues that stress ``knn_merge``'s threshold, for the
tests and the card check: made with numpy from a seed, sorted on the given
device, returned as (M, S, k) f32 values and i32 indices, each queue sorted
by (value, index). Indices are distinct within a row, as the scans write
them, except for the (+inf, -1) empty slots.

* ``one_queue``    — every pair of a row's answer sits in one queue;
* ``fillers``      — most queues empty, the rest part-filled, so that row 0
                     holds fewer real pairs than k and the others more;
* ``equal_values`` — every value equal: only the indices decide;
* ``ties``         — small integer values, -0.0 and +0.0 among them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.topk import sort_pairs

KINDS = ("one_queue", "fillers", "equal_values", "ties")


def merge_queues(kind: str, m: int, s: int, k: int, seed: int = 0, device="cpu"):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(s * k) for _ in range(m)]).reshape(m, s, k)
    if kind == "one_queue":
        v = rng.integers(k, 4 * k, (m, s, k)).astype(np.float32)
        for r in range(m):
            v[r, (3 * r + 1) % s] = rng.integers(0, k, k)
    elif kind == "fillers":
        v = rng.integers(-50, 51, (m, s, k)).astype(np.float32)
        fill = np.zeros((m, s), np.int64)
        for r in range(m):
            live = rng.choice(s, max(1, s // 8), replace=False)
            fill[r, live] = rng.integers(0, k + 1, live.size)
        fill[0] = 0
        fill[0, s // 2] = k // 3  # fewer real pairs than k in all
        empty = np.arange(k) >= fill[..., None]
        v[empty], idx[empty] = np.inf, -1
    elif kind == "equal_values":
        v = np.full((m, s, k), 3.0, np.float32)
    elif kind == "ties":
        v = rng.integers(-3, 4, (m, s, k)).astype(np.float32)
        zero = v == 0
        v[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(-0.0), 0.0)
    else:
        raise ValueError(kind)
    sv, si = sort_pairs(torch.from_numpy(v).to(device),
                        torch.from_numpy(idx.astype(np.int32)).to(device))
    return sv.contiguous(), si.contiguous()
