"""two-tower-retrieval — sampled-softmax retrieval [RecSys'19 (YouTube)].

embed_dim=256 tower_mlp=1024-512-256 interaction=dot. The retrieval_cand
shape (1 query vs 10^6 candidates, maximum inner product) is served by the
paper's exact-kNN engine with metric="ip" — the dense-retrieval use case of
the reproduced paper, verbatim.
"""
import torch

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys import RecsysConfig

_MODEL = RecsysConfig(
    name="two-tower-retrieval",
    kind="two_tower",
    table_sizes=(33_554_432,),  # shared id vocabulary (2^25)
    embed_dim=256,
    tower_mlp=(1024, 512, 256),
    interaction="dot",
    dtype=torch.float32,
)

_SMOKE = RecsysConfig(
    name="two-tower-smoke",
    kind="two_tower",
    table_sizes=(1024,),
    embed_dim=16,
    tower_mlp=(32, 8),
    interaction="dot",
    dtype=torch.float32,
)

ARCH = ArchConfig(
    arch_id="two-tower-retrieval",
    family="recsys",
    model=_MODEL,
    smoke_model=_SMOKE,
    shapes=RECSYS_SHAPES,
    source="RecSys'19 (YouTube two-tower)",
    notes="retrieval_cand == the reproduced paper's workload: exact MIPS "
          "over a candidate corpus via FD-SQ (repro.core).",
)
