"""Config schema: an architecture and its input shapes.

Each architecture module exports ``ARCH: ArchConfig`` with its
hyperparameters, a reduced smoke config for CPU tests, and its family's
shape set. The port carries the kNN paper's workloads and the five LM
architectures (their decode-serving path; training comes later).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | knn_fqsd | knn_fdsq | knn_ring | knn_ring_q
    dims: Mapping[str, int]

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # knn | lm
    model: Any
    smoke_model: Any
    shapes: tuple[ShapeSpec, ...]
    source: str = ""
    notes: str = ""
    train_moment_dtype: str = "f32"  # optimizer moment precision for train cells
    train_microbatches: int = 1  # gradient-accumulation chunks per step

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}; has {[s.name for s in self.shapes]}")


# ---------------------------------------------------------------- LM shapes
LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)
