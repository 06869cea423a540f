"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) d_ff=768/expert vocab=151936, MoE 128e top-8.
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import LMConfig

_MODEL = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=64,
    d_ff=768, vocab=151936, n_experts=128, expert_top_k=8,
    rope_theta=1e6, dtype=torch.bfloat16, remat=True,
)

_SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=256, n_experts=8, expert_top_k=2,
    dtype=torch.float32, remat=False,
)

ARCH = ArchConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="lm",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen3-30B-A3B",
    train_moment_dtype="bf16",
    notes="EP over model axis: 8 experts/chip at 16-way TP.",
)
