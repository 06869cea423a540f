"""repro_torch.store — the dataset layer: equal padded shards in host RAM or
in files (the reference's on-disk format, read side).

    DatasetStore    equal padded shards, f32 + int8 tiers, in host RAM or
                    np.memmap files (from_array(directory=...) / open)
    Manifest        durable JSON shard table (geometry, tiers, checksums)
"""
from repro_torch.faults import FaultError, ShardCorruptError, ShardReadError
from repro_torch.store.manifest import (
    CURRENT_NAME,
    Manifest,
    ManifestError,
    ShardMeta,
    crc32_of,
    read_current,
    write_current,
)
from repro_torch.store.store import F32_TIER, INT8_TIER, JOURNAL_NAME, DatasetStore, Int8Shard

__all__ = [
    "DatasetStore", "Manifest", "ManifestError", "ShardMeta", "Int8Shard", "crc32_of",
    "JOURNAL_NAME", "CURRENT_NAME", "read_current", "write_current", "F32_TIER",
    "INT8_TIER", "FaultError", "ShardReadError", "ShardCorruptError",
]
