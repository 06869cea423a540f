"""Architecture registry: --arch <id> resolution for launch/ and tests.

The port carries the kNN paper's workloads (``knn-search``) and the five LM
architectures, whose decode-serving path (``repro_torch.models``,
``serving.DecodeServer``) is ported. The graph and recommender
architectures of the JAX package come with the rest of its non-kNN
substrate.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeSpec  # noqa: F401

_MODULES = {
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "knn-search": "repro_torch.configs.knn_paper",  # the paper's own workloads
}

ASSIGNED_ARCHS = tuple(a for a in _MODULES if a != "knn-search")
ALL_ARCHS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
