"""repro_torch.core — exact kNN search engine (the paper's primary contribution).

Public API (planner -> executors -> facade):
    ExactKNN            engine facade (FD-SQ / FQ-SD, one device or a mesh)
    plan/ExecutionPlan  pure planning layer (repro_torch.core.planner)
    execute/register_executor/list_executors/cache_info
                        executor registry + executable cache (no reflashing)
    TopK                result container (sorted scores + global indices)
    fqsd_scan           chunked streamed-dataset search (throughput)
    fdsq_search         partition-parallel resident-dataset search (latency)
    fqsd_streamed       host-streamed search with double buffering
    fdsq_sharded / fqsd_sharded / fqsd_ring / fdsq_sharded_int8
                        the same over a device mesh (repro_torch.core.mesh)
"""
from repro_torch.core.distance import (
    cosine_distance,
    inner_product,
    l2_sq,
    pairwise_scores,
    row_norms_sq,
)
from repro_torch.core.engine import ExactKNN
from repro_torch.core.executors import (
    ExecContext,
    MeshTiered,
    TieredResident,
    cache_info,
    cached_partition_step,
    clear_executable_cache,
    execute,
    get_executor,
    list_executors,
    register_executor,
    set_executable_cache_limit,
)
from repro_torch.core.fdsq import fdsq_query_stream, fdsq_search
from repro_torch.core.fqsd import fqsd_scan, fqsd_streamed, streamed_direct_scan
from repro_torch.core.partition import PaddedDataset, iter_partitions, make_padded
from repro_torch.core.planner import (
    DatasetMeta,
    DatasetStoreMeta,
    EngineConfig,
    EnginePlan,
    ExecutionPlan,
    largest_divisor_at_most,
    plan,
)
from repro_torch.core.quantized import (
    Int8Partition,
    QuantizedDataset,
    int8_lower_bounds,
    knn_quantized,
    quantize_dataset,
    quantized_norm_sq,
)
from repro_torch.core.sharded import (
    fdsq_sharded,
    fdsq_sharded_int8,
    fqsd_ring,
    fqsd_sharded,
    shard_dataset,
)
from repro_torch.core.streaming import (
    DoubleBufferedStream,
    ResilientShardSource,
    device_put_partition,
    make_ring_put,
    prefetch_to_device,
)
from repro_torch.core.topk import (
    TopK,
    empty_topk,
    knn_oracle,
    merge_topk,
    merge_two_sorted,
    topk_smallest,
    tree_merge_sorted,
)

__all__ = [
    "ExactKNN", "EnginePlan", "ExecutionPlan", "TopK",
    "plan", "DatasetMeta", "DatasetStoreMeta", "EngineConfig",
    "largest_divisor_at_most",
    "execute", "register_executor", "get_executor", "list_executors",
    "cache_info", "clear_executable_cache", "set_executable_cache_limit",
    "ExecContext",
    "TieredResident", "MeshTiered", "cached_partition_step",
    "fqsd_scan", "fqsd_streamed", "streamed_direct_scan",
    "fdsq_search", "fdsq_query_stream",
    "fdsq_sharded", "fdsq_sharded_int8", "fqsd_sharded", "fqsd_ring",
    "shard_dataset",
    "pairwise_scores", "l2_sq", "inner_product", "cosine_distance",
    "row_norms_sq", "topk_smallest", "merge_topk", "merge_two_sorted",
    "tree_merge_sorted", "empty_topk", "knn_oracle",
    "PaddedDataset", "make_padded", "iter_partitions",
    "DoubleBufferedStream", "ResilientShardSource", "prefetch_to_device",
    "device_put_partition", "make_ring_put",
    "QuantizedDataset", "Int8Partition", "quantize_dataset",
    "knn_quantized", "quantized_norm_sq", "int8_lower_bounds",
]
