"""repro_torch.tuning — per-device autotuning of the card's scan kernels:
block shapes, end-to-end streamed-pipeline knobs, and the CUDA capability
verdict.

    AutotuneCache       JSON-persisted per-device cache (artifacts/autotune/)
                        holding three entry kinds keyed by prefix:
                        block shapes, "pipe|" pipeline knobs, "capability|"
    autotune_knn        sweep the legal (bm, bn) of knn_scan / knn_int8_scan
    autotune_pipeline   sweep (prefetch_depth, spec_trigger, rescore_factor,
                        rows_per_shard) with whole timed searches
    lookup_blocks       pure read the planner uses to fill plan blocks
    lookup_pipeline     pure read the planner uses for streamed plans
    lookup_cuda_capability / probe_cuda_capability
                        the kernels' verdict: probe once, plan() reads (and
                        raises on a persisted false)
    candidate_blocks    the legal sweep space for one key
"""
from repro_torch.tuning.autotune import (
    AutotuneCache,
    BlockShapes,
    PipelineKnobs,
    autotune_knn,
    autotune_pipeline,
    candidate_blocks,
    default_cache,
    device_kind,
    lookup_blocks,
    lookup_cuda_capability,
    lookup_pipeline,
    pipeline_key,
    probe_cuda_capability,
    set_default_cache,
    tuning_key,
)

__all__ = [
    "AutotuneCache", "BlockShapes", "PipelineKnobs", "autotune_knn",
    "autotune_pipeline", "candidate_blocks", "default_cache", "device_kind",
    "lookup_blocks", "lookup_cuda_capability", "lookup_pipeline",
    "pipeline_key", "probe_cuda_capability", "set_default_cache",
    "tuning_key",
]
