"""minicpm-2b — llama-like dense LM trained with WSD schedule
[arXiv:2404.06395; hf]. 40L d_model=2304 36H (MHA, kv=36) d_ff=5760
vocab=122753 (odd vocab exercises uneven sharding).
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import LMConfig

_MODEL = LMConfig(
    name="minicpm-2b",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_head=64,
    d_ff=5760, vocab=122753,
    rope_theta=1e4, dtype=torch.bfloat16, remat=True,
)

_SMOKE = LMConfig(
    name="minicpm-smoke",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, d_head=12,
    d_ff=96, vocab=257,  # odd on purpose: uneven-shard path
    dtype=torch.float32, remat=False,
)

ARCH = ArchConfig(
    arch_id="minicpm-2b",
    family="lm",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=LM_SHAPES,
    source="arXiv:2404.06395",
    notes="WSD schedule (repro.optim.schedules.wsd_schedule) is this arch's "
          "training schedule; vocab=122753 is odd -> uneven vocab shards.",
)
