"""DatasetStore — the in-memory, single-shard part of the dataset layer.

One store holds one padded f32 shard: vectors zero-padded to
(rows, padded_dim) and row norms with +inf on padded rows, the mask
channel every executor honours. The shard lives on the device of the array
it was built from, so a dataset generated on the card is padded there with
no host copy.

Mutations (upsert / delete with the write-ahead journal), mmap shards,
compaction and the int8 tier are ported in the store and int8 slices;
``upsert`` and ``delete`` raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.partition import LANE, PaddedDataset, make_padded
from repro_torch.core.planner import DatasetStoreMeta

F32_TIER = "f32"


class DatasetStore:
    """A resident single-shard f32 dataset; build with :meth:`from_array`."""

    def __init__(self, vectors: torch.Tensor, norms: torch.Tensor, n_valid: int):
        self._vectors = vectors
        self._norms = norms
        self._n_valid = int(n_valid)

    @classmethod
    def from_array(cls, vectors, row_mult: int = LANE,
                   dim_mult: int = LANE) -> "DatasetStore":
        """Build a store from an (N, d) numpy array or tensor, padded on the
        tensor's own device to (round_up(N, row_mult), round_up(d, dim_mult))."""
        v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
            np.asarray(vectors, dtype=np.float32))
        if v.ndim != 2:
            raise ValueError(f"expected (N, d) dataset, got {tuple(v.shape)}")
        padded = make_padded(v.to(torch.float32), row_mult=row_mult, dim_mult=dim_mult)
        if not bool(torch.isfinite(padded.norms[:padded.n_valid]).all()):
            # +inf is the mask sentinel every executor honours: a row whose
            # norm overflows f32 would be stored yet never returnable
            raise ValueError(
                "rows with non-finite f32 squared norms cannot be stored "
                "(values this large would be silently unreturnable)")
        return cls(padded.vectors, padded.norms, padded.n_valid)

    # ------------------------------------------------------------ geometry
    @property
    def padded_dim(self) -> int:
        return int(self._vectors.shape[1])

    @property
    def rows_per_shard(self) -> int:
        return int(self._vectors.shape[0])

    @property
    def n_shards(self) -> int:
        return 1

    @property
    def n_main(self) -> int:
        """Rows in the main shard."""
        return self._n_valid

    @property
    def n_ids(self) -> int:
        """Size of the external id space (ids ever allocated)."""
        return self._n_valid

    @property
    def n_live(self) -> int:
        """Rows a query must see."""
        return self._n_valid

    @property
    def mutation_count(self) -> int:
        """Bumped on every mutation; this slice has none."""
        return 0

    def has_tier(self, tier: str) -> bool:
        return tier == F32_TIER

    def nbytes(self, tier: str = F32_TIER) -> int:
        """Scan bytes of one full pass over the main shard at `tier`."""
        per_elem = 4 if tier == F32_TIER else 1
        return self.rows_per_shard * self.padded_dim * per_elem

    def meta(self, device_resident: bool, tier: str = F32_TIER,
             sharded: bool = False) -> DatasetStoreMeta:
        """Planner-visible facts: geometry + tier + residency + shard count."""
        return DatasetStoreMeta(
            padded_rows=self.rows_per_shard, padded_dim=self.padded_dim,
            n_valid=self.n_main, sharded=sharded, resident=device_resident,
            tier=tier, n_shards=1, rows_per_shard=self.rows_per_shard, mmap=False,
        )

    def resident(self) -> PaddedDataset:
        """The shard as one PaddedDataset (the store's own tensors)."""
        return PaddedDataset(self._vectors, self._norms, self._n_valid, 0)

    # --------------------------------------------------- later slices
    def upsert(self, vectors):
        raise NotImplementedError("store mutations are ported in the store slice")

    def delete(self, ids):
        raise NotImplementedError("store mutations are ported in the store slice")
