"""Host->device input pipeline with double-buffered prefetch.

Composes any host iterator (``repro_torch.data.synthetic`` generators,
partition streams) with the paper's double-buffering schedule
(``repro_torch.core.streaming.DoubleBufferedStream``): batch i+1 is put on
the device while the device computes on batch i. Every array of a batch (a
dict, a tuple or a bare array) becomes a tensor on ``device``. The
reference's ``mesh=`` / ``specs=`` sharding of each batch comes with the
port's substrate on a mesh.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.streaming import DoubleBufferedStream
from repro_torch.tree import tree_map


class DataPipeline:
    """`host_iter` may be any (re)iterable, including a
    :class:`repro_torch.store.DatasetStore`: a store is a restartable shard
    source, so ``DataPipeline(store)`` supports any number of epochs — each
    ``iter()`` opens a fresh pass. ``device=None`` means CUDA, which must
    exist."""

    def __init__(
        self,
        host_iter: Iterable,
        depth: int = 2,
        transform: Callable | None = None,
        device=None,
    ):
        self._host = host_iter
        self._depth = depth
        self._transform = transform
        self._device = resolve_device(device)

    def _put(self, batch):
        if self._transform is not None:
            batch = self._transform(batch)
        return tree_map(lambda x: torch.as_tensor(x).to(self._device, non_blocking=True)
                        if isinstance(x, (np.ndarray, torch.Tensor)) else x, batch)

    def __iter__(self) -> Iterator:
        return iter(DoubleBufferedStream(self._host, self._depth, self._put,
                                         device=self._device))
