"""Production mesh construction.

Functions, not module constants: importing this module touches no device.

Single pod: (data=16, model=16) — 256 positions.
Multi-pod:  (pod=2, data=16, model=16) — 512 positions; the `pod` axis
extends data parallelism across the pod boundary.

Without ``devices`` a mesh takes CUDA devices and raises where there are
too few, as the reference raises without its devices. With ``devices`` a
position may repeat a device (``["cuda:0"] * 16`` on one card) or be a
``"meta"`` device, on which nothing is allocated: the dry run
(``launch/dryrun.py``) builds its cells on a production mesh of those.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.mesh import Mesh, make_mesh


def _cuda_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devices = _cuda_devices() if devices is None else list(devices)
    if len(devices) < n:
        raise RuntimeError(
            f"production mesh needs {n} devices, found {len(devices)}; pass devices= "
            "(logical positions, or ['meta'] * n as launch/dryrun.py does)")
    return make_mesh(shape, axes, devices=devices[:n])


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """Small mesh over the given devices, or the CUDA devices (tests /
    examples)."""
    devices = _cuda_devices() if devices is None else list(devices)
    n = len(devices)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, have {n}")
    return make_mesh((data, model), ("data", "model"), devices=devices[: data * model])


__all__ = ["make_host_mesh", "make_production_mesh"]
