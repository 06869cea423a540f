"""Config schema: an architecture and its input shapes.

Each architecture module exports ``ARCH: ArchConfig`` with its
hyperparameters, a reduced smoke config for CPU tests, and its family's
shape set. The port carries the kNN paper's workloads and every
architecture of the JAX package: the five LMs, the GNN and the four
recommenders.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | train_sampled | train_batched | serve | retrieval | knn_*
    dims: Mapping[str, int]

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # lm | gnn | recsys | knn
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

# --------------------------------------------------------------- GNN shapes
GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "train_sampled",
              {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
               "fanout0": 15, "fanout1": 10, "d_feat": 602}),
    ShapeSpec("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeSpec("molecule", "train_batched",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16}),
)

# ------------------------------------------------------------ recsys shapes
RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)
