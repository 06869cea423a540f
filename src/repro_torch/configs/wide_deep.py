"""wide-deep — wide & deep learning [arXiv:1606.07792; paper].

n_sparse=40 embed_dim=32 mlp=1024-512-256 interaction=concat. Table sizes
span the app-store-scale mix of the paper: a few huge id vocabularies plus
many small categorical features (~24.7M fused rows).
"""
import torch

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys import RecsysConfig

WIDE_DEEP_TABLE_SIZES = tuple(
    [10_000_000] * 2 + [1_000_000] * 4 + [100_000] * 6 + [10_000] * 8 + [1_000] * 20
)

_MODEL = RecsysConfig(
    name="wide-deep",
    kind="wide_deep",
    table_sizes=WIDE_DEEP_TABLE_SIZES,
    embed_dim=32,
    top_mlp=(1024, 512, 256),
    interaction="concat",
    dtype=torch.float32,
)

_SMOKE = RecsysConfig(
    name="wide-deep-smoke",
    kind="wide_deep",
    table_sizes=(100,) * 5,
    embed_dim=8,
    top_mlp=(32, 16),
    interaction="concat",
    dtype=torch.float32,
)

ARCH = ArchConfig(
    arch_id="wide-deep",
    family="recsys",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=RECSYS_SHAPES,
    source="arXiv:1606.07792",
    notes="Wide (dim-1) and deep (dim-32) fused tables both row-shard over "
          "`model`.",
)
