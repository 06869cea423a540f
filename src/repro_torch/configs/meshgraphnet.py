"""meshgraphnet — encode-process-decode mesh GNN [arXiv:2010.03409; unverified].

n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2. Message passing
scatters edge messages into their receivers (index_add); world-space edges
in the examples are built with the paper's exact-kNN engine (the technique
tie-in).

Shape-dependent input feature width is handled by per-shape encoder configs
(see launch/steps.py: d_node_in <- shape dims).
"""
import torch

from repro_torch.configs.base import GNN_SHAPES, ArchConfig
from repro_torch.models.gnn import GNNConfig

_MODEL = GNNConfig(
    name="meshgraphnet",
    n_layers=15, d_hidden=128, mlp_layers=2, aggregator="sum",
    d_node_in=1433, d_edge_in=4, d_out=2, dtype=torch.float32, remat=True,
)

_SMOKE = GNNConfig(
    name="meshgraphnet-smoke",
    n_layers=3, d_hidden=16, mlp_layers=2, aggregator="sum",
    d_node_in=8, d_edge_in=4, d_out=2, dtype=torch.float32, remat=False,
)

ARCH = ArchConfig(
    arch_id="meshgraphnet",
    family="gnn",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=GNN_SHAPES,
    source="arXiv:2010.03409",
    notes="Edges shard over the full mesh; receivers-side segment_sum "
          "produces partial node aggregates combined by psum (replicated "
          "node state) — ogb_products runs edge-sharded with remat.",
)
