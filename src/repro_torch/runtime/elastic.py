"""Elastic scaling: re-mesh a training job onto a different device count.

When a host loses devices (or gains them back), the job restarts on a new
mesh. Checkpoints store FULL arrays (``repro_torch.checkpoint``), so
elasticity reduces to:

    1. build the new mesh from the surviving devices (largest (data, model)
       grid that divides the workload),
    2. re-derive the specs against it (``runtime.sharding`` sanitizes
       non-divisible axes),
    3. load the checkpoint with the new shardings
       (``load_checkpoint(..., shardings=)``), or re-place a live tree
       (:func:`reshard_tree`).

The port's meshes are logical positions in one process
(``repro_torch.core.mesh``): ``remesh(["cuda:0"] * 8)`` lays an 8-position
mesh over one card, ``remesh(["cpu"] * 4)`` over the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.runtime.sharding import place, sanitize_spec
from repro_torch.tree import tree_map


def best_mesh_shape(n_devices: int, prefer_model: int = 16) -> tuple[int, int]:
    """Largest (data, model) grid for the available devices: model axis as
    close to `prefer_model` as divisibility allows, rest data."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return n_devices // model, model


def remesh(devices=None, prefer_model: int = 16) -> Mesh:
    """A (data, model) mesh over ``devices`` (``None``: every CUDA device,
    which must exist)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("remesh over the CUDA devices found none; pass devices=")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    data, model = best_mesh_shape(len(devices), prefer_model)
    return make_mesh((data, model), ("data", "model"), devices=devices[: data * model])


def reshard_tree(tree, specs, mesh: Mesh):
    """Re-place a tree (tensors, placed :class:`~repro_torch.runtime.sharding.Sharded`
    leaves, or :class:`~repro_torch.tree.Stack` leaves of either) onto
    `mesh` under `specs`, each spec sanitized against the leaf's shape and
    the new mesh first."""
    sizes = dict(mesh.shape)
    return tree_map(lambda x, sp: place(x, sanitize_spec(tuple(x.shape), sp, sizes), mesh),
                    tree, specs)


__all__ = ["best_mesh_shape", "remesh", "reshard_tree"]
