"""knn-search — the reproduced paper's own workloads (Table 1 datasets).

GIST (1M x 960), YFCC100M-HNFc6 (~100M x 4096), MS-MARCO/STAR (8.84M x 769):

    gist_fqsd      FQ-SD, batch 16 queries, k=1024   (paper Table 2, GIST)
    msmarco_fdsq   FD-SQ, single query, k=1024       (paper Table 2, MARCO)
    msmarco_k72    FD-SQ, single query, k=72         (paper Table 3 best)
    yfcc_ring      FQ-SD ring-streamed over a mesh (YFCC does not fit one
                   device): repro_torch.core.sharded.fqsd_ring over the
                   port's devices
    yfcc_ring_q    the query-ring variant of yfcc_ring (fqsd_ring_queries)

The ring shapes run on a mesh of the port's devices (repro_torch.core.mesh);
at their size (about 1.6 TB of f32 rows) they need more cards than one
machine of the port's has.
"""
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class KNNWorkload:
    name: str
    n_vectors: int
    dim: int
    n_queries: int
    dtype: object = torch.float32


_MODEL = KNNWorkload(name="knn-paper", n_vectors=8_841_823, dim=769, n_queries=6980)
_SMOKE = KNNWorkload(name="knn-smoke", n_vectors=4096, dim=96, n_queries=16)

KNN_SHAPES = (
    ShapeSpec("gist_fqsd", "knn_fqsd",
              {"n": 1_000_000, "d": 960, "m": 16, "k": 1024}),
    ShapeSpec("msmarco_fdsq", "knn_fdsq",
              {"n": 8_841_823, "d": 769, "m": 1, "k": 1024}),
    ShapeSpec("msmarco_k72", "knn_fdsq",
              {"n": 8_841_823, "d": 769, "m": 1, "k": 72}),
    ShapeSpec("yfcc_ring", "knn_ring",
              {"n": 100_000_000, "d": 4096, "m": 256, "k": 1024}),
    ShapeSpec("yfcc_ring_q", "knn_ring_q",
              {"n": 100_000_000, "d": 4096, "m": 256, "k": 1024}),
)

ARCH = ArchConfig(
    arch_id="knn-search",
    family="knn",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=KNN_SHAPES,
    source="the reproduced paper (Table 1-3)",
    notes="FQ-SD/FD-SQ executors of repro_torch.core; the ring shapes run "
          "on a mesh of the port's devices and need more cards than one "
          "machine has.",
)
