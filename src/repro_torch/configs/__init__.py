"""Architecture registry: --arch <id> resolution for launch/ and tests.

The port carries the kNN paper's workloads (``knn-search``); the other
architectures of the JAX package come with the port of its non-kNN
substrate.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeSpec  # noqa: F401

_MODULES = {
    "knn-search": "repro_torch.configs.knn_paper",  # the paper's own workloads
}

ALL_ARCHS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
