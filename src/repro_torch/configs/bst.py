"""bst — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874; paper].

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256
interaction=transformer-seq. Item vocabulary 10M (Taobao-scale).
"""
import torch

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys import RecsysConfig

_MODEL = RecsysConfig(
    name="bst",
    kind="bst",
    table_sizes=(10_000_000,),
    embed_dim=32,
    seq_len=20,
    n_heads=8,
    n_blocks=1,
    top_mlp=(1024, 512, 256),
    interaction="transformer-seq",
    dtype=torch.float32,
)

_SMOKE = RecsysConfig(
    name="bst-smoke",
    kind="bst",
    table_sizes=(500,),
    embed_dim=32,
    seq_len=20,
    n_heads=8,
    n_blocks=1,
    top_mlp=(64, 32),
    interaction="transformer-seq",
    dtype=torch.float32,
)

ARCH = ArchConfig(
    arch_id="bst",
    family="recsys",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=RECSYS_SHAPES,
    source="arXiv:1905.06874",
    notes="Self-attention over the 20-item behavior sequence; item table "
          "row-shards over `model`.",
)
