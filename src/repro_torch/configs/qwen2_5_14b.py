"""qwen2.5-14b — dense GQA LM with QKV bias [hf:Qwen/Qwen2.5-14B; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import LMConfig

_MODEL = LMConfig(
    name="qwen2.5-14b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=13824, vocab=152064, qkv_bias=True,
    rope_theta=1e6, dtype=torch.bfloat16, remat=True,
)

_SMOKE = LMConfig(
    name="qwen2.5-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, qkv_bias=True, dtype=torch.float32, remat=False,
)

ARCH = ArchConfig(
    arch_id="qwen2.5-14b",
    family="lm",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen2.5-14B",
    notes="Dense DP x TP; QKV bias exercised in the bias-sharding path.",
)
