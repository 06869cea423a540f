"""repro_torch.store — the dataset layer: equal padded shards in host RAM or
in files (the reference's on-disk format), with online upserts and deletes,
generations and compaction.

    DatasetStore    equal padded shards, f32 + int8 tiers, in host RAM, on
                    the card or in np.memmap files (from_array(directory=...)
                    / open, which replays the journal), online
                    upsert/delete, journaled mutations and compaction into
                    a new generation
    StoreView       refcount-pinned read snapshot of one generation (what a
                    search in flight streams from across a swap)
    Manifest        durable JSON shard table (geometry, tiers, checksums,
                    generation and external-id metadata)
    Journal         CRC-framed write-ahead log (the durability point of
                    every upsert and delete)
"""
from repro_torch.faults import FaultError, ShardCorruptError, ShardReadError
from repro_torch.store.journal import JOURNAL_NAME, Journal
from repro_torch.store.manifest import (
    CURRENT_NAME,
    Manifest,
    ManifestError,
    ShardMeta,
    crc32_of,
    read_current,
    write_current,
)
from repro_torch.store.store import (
    DELTA_ROWS_DEFAULT,
    F32_TIER,
    INT8_TIER,
    DatasetStore,
    Int8Shard,
    StoreView,
)

__all__ = [
    "DatasetStore", "StoreView", "Manifest", "ManifestError", "ShardMeta", "Int8Shard",
    "crc32_of", "Journal", "JOURNAL_NAME", "CURRENT_NAME", "read_current", "write_current",
    "F32_TIER", "INT8_TIER", "DELTA_ROWS_DEFAULT", "FaultError", "ShardReadError",
    "ShardCorruptError",
]
