"""kimi-k2-1t-a32b — trillion-parameter MoE LM [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840, MoE 384e top-8.
~1.03T total params, ~32B active. Optimizer moments run int8 (4 B/param of
standing state instead of 10) — see DESIGN.md and the dry-run memory table.
"""
import torch

from repro_torch.configs.base import LM_SHAPES, ArchConfig
from repro_torch.models.transformer import LMConfig

_MODEL = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
    d_ff=2048, vocab=163840, n_experts=384, expert_top_k=8,
    rope_theta=5e4, dtype=torch.bfloat16, remat=True,
)

_SMOKE = LMConfig(
    name="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab=512, n_experts=8, expert_top_k=2,
    dtype=torch.float32, remat=False,
)

ARCH = ArchConfig(
    arch_id="kimi-k2-1t-a32b",
    family="lm",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=LM_SHAPES,
    source="arXiv:2501.kimi2 (paper-table; unverified)",
    train_moment_dtype="int8",
    train_microbatches=8,  # gradient accumulation: peak activation memory /8
    notes="1T-param MoE: EP over model axis (24 experts/chip at 16-way), "
          "FSDP params, int8 Adam moments required to approach one-pod HBM.",
)
