"""starcoder2-7b — dense GQA + RoPE code LM [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import LMConfig

_MODEL = LMConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab=49152,
    rope_theta=1e5, dtype=torch.bfloat16, remat=True,
)

_SMOKE = LMConfig(
    name="starcoder2-smoke",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_head=12,
    d_ff=96, vocab=256, dtype=torch.float32, remat=False,
)

ARCH = ArchConfig(
    arch_id="starcoder2-7b",
    family="lm",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=LM_SHAPES,
    source="arXiv:2402.19173",
    notes="36 heads do not divide the 16-way model axis: activation head "
          "sharding falls back to flat hidden-dim sharding (divisibility "
          "sanitizer in runtime.sharding).",
)
