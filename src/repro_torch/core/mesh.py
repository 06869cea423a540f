"""Device meshes: the counterpart of ``jax.sharding.Mesh`` and
``repro.compat.make_mesh``, which the JAX package takes from JAX itself.

A :class:`Mesh` is an n-d array of ``torch.device`` with a name per axis.
One process drives every position of it (the reference's single
controller): the sharded functions of :mod:`repro_torch.core.sharded` loop
over the positions, launch each position's work on its device, and move
queues and blocks between devices with ``Tensor.to``.

A position is a *logical* device: an explicit list may name one device
several times (``["cuda:0"] * 4`` on a one-card machine, ``["cpu"] * 8``
on a host), and every position still holds its own row block and runs its
own step, so the whole schedule (global row offsets, ring order,
hierarchical merges) runs on a single card. This differs from JAX by
design: a ``jax.sharding.Mesh`` takes each device once, and a host stands
in for several with ``--xla_force_host_platform_device_count``.

Meshes hash and compare by (device tuple, mesh shape, axis names), so an
executor cache key ``(plan.cache_key(), mesh, axes)`` hits for two equal
meshes as it does in the reference.

:func:`use_mesh` makes a mesh the active one of its thread, as the
reference's ``compat.use_mesh`` does; :func:`current_mesh` reads it (the
reference's ``compat.get_abstract_mesh``). The model code of
``repro_torch.models`` and the cells of ``repro_torch.launch.steps`` read
the active mesh to pick their sharded branches. A mesh of ``"meta"``
positions places nothing and computes nothing: the dry run builds its
cells under one.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import numpy as np
import torch


class Mesh:
    """An n-d array of ``torch.device`` positions with one name per axis.

    ``devices`` is any nested sequence (or ndarray) of devices or device
    strings whose rank equals ``len(axis_names)``; every entry must be of
    one device type, and a CUDA mesh needs a CUDA device to exist.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        names = tuple(axis_names)
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(names):
            raise ValueError(f"devices of rank {src.ndim} for {len(names)} axis names {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names must be distinct, got {names}")
        if src.size == 0:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(src.shape, dtype=object)
        for pos, d in np.ndenumerate(src):
            arr[pos] = torch.device(d)
        kinds = {d.type for d in arr.flat}
        if len(kinds) != 1:
            raise ValueError(f"mesh devices must be of one type, got {sorted(kinds)}")
        if "cuda" in kinds and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device, and none is available")
        self.devices = arr
        self.axis_names = names
        self._key = (tuple(str(d) for d in arr.flat), arr.shape, names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        """Axis sizes in axis order (``jax.sharding.AbstractMesh.axis_sizes``)."""
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The device of position (0, ..., 0): where results are gathered."""
        return self.devices.flat[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self._key[0])})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (``repro.compat.make_mesh``).

    ``devices=None`` takes the first ``prod(shape)`` CUDA devices and raises
    where there are fewer. An explicit flat list of ``prod(shape)`` devices
    (``torch.device`` or strings) is laid out row-major and may repeat a
    device: each position is a logical device of its own.
    """
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail < n:
            raise ValueError(f"mesh {shape} needs {n} CUDA devices, {avail} present; "
                             "pass devices= to lay logical devices over fewer")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"mesh {shape} needs {n} devices, got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axes)


_local = threading.local()


def current_mesh() -> Mesh | None:
    """The mesh :func:`use_mesh` made active on this thread, or None
    (``repro.compat.get_abstract_mesh``)."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the active mesh of this thread for the enclosed block
    (``repro.compat.use_mesh``); ``None`` makes the block meshless."""
    prev = current_mesh()
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


__all__ = ["Mesh", "make_mesh", "current_mesh", "use_mesh"]
