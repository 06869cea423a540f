"""dlrm-rm2 — deep learning recommendation model [arXiv:1906.00091; paper].

n_dense=13 n_sparse=26 embed_dim=64 bot_mlp=13-512-256-64
top_mlp=512-512-256-1 interaction=dot. Table cardinalities follow the
Criteo-Kaggle display-advertising dataset (the DLRM paper's benchmark);
~33.8M fused rows.
"""
import torch

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys import RecsysConfig

CRITEO_TABLE_SIZES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

_MODEL = RecsysConfig(
    name="dlrm-rm2",
    kind="dlrm",
    table_sizes=CRITEO_TABLE_SIZES,
    embed_dim=64,
    n_dense=13,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    interaction="dot",
    dtype=torch.float32,
)

_SMOKE = RecsysConfig(
    name="dlrm-smoke",
    kind="dlrm",
    table_sizes=(100, 50, 200, 30),
    embed_dim=8,
    n_dense=13,
    bot_mlp=(32, 8),
    top_mlp=(32, 16, 1),
    interaction="dot",
    dtype=torch.float32,
)

ARCH = ArchConfig(
    arch_id="dlrm-rm2",
    family="recsys",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=RECSYS_SHAPES,
    source="arXiv:1906.00091 (Criteo cardinalities)",
    notes="Fused 33.8M-row table row-shards over `model`; lookup = "
          "shard-local masked take + psum (repro.models.recsys).",
)
