"""DatasetStore — the in-memory, single-shard part of the dataset layer.

One store holds one padded f32 shard: vectors zero-padded to
(rows, padded_dim) and row norms with +inf on padded rows, the mask
channel every executor honours. The shard lives on the device of the array
it was built from, so a dataset generated on the card is padded there with
no host copy.

Tiers:

* ``f32``  — the exact base tier, always present;
* ``int8`` — the 1 B/element scan tier (``repro_torch.core.quantized``):
             per-row int8 codes + scales + a certified per-row error bound
             + the exact quantised norm, built by :meth:`ensure_tier` from
             the padded f32 rows on their own device, a chunk of rows at a
             time. Its padded rows carry +inf norms.

Mutations (upsert / delete with the write-ahead journal), mmap shards and
compaction are ported in the store slice; ``upsert`` and ``delete`` raise
``NotImplementedError`` until then.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.partition import LANE, PaddedDataset, make_padded
from repro_torch.core.planner import DatasetStoreMeta
from repro_torch.core.quantized import QuantizedDataset, quantize_dataset

F32_TIER = "f32"
INT8_TIER = "int8"


#: The int8 tier of one shard: a QuantizedDataset over its padded rows.
Int8Shard = QuantizedDataset


class DatasetStore:
    """A resident single-shard f32 dataset; build with :meth:`from_array`."""

    def __init__(self, vectors: torch.Tensor, norms: torch.Tensor, n_valid: int):
        self._vectors = vectors
        self._norms = norms
        self._n_valid = int(n_valid)
        self._int8: Int8Shard | None = None

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
        return tier == F32_TIER or (tier == INT8_TIER and self._int8 is not None)

    def ensure_tier(self, tier: str) -> None:
        """Materialise `tier` (idempotent). The int8 tier is quantised from
        the padded f32 rows on their own device; padded rows get +inf norms
        so the masked quantised scan can never admit them."""
        if tier == F32_TIER:
            return
        if tier != INT8_TIER:
            raise ValueError(f"unknown tier {tier!r}; known: {F32_TIER}, {INT8_TIER}")
        if self._int8 is not None:
            return
        qd = quantize_dataset(self._vectors)
        qd.norms_sq[self._n_valid:] = torch.inf
        self._int8 = qd

    def int8_resident(self) -> Int8Shard:
        """The shard's int8 tier (the store's own tensors)."""
        if self._int8 is None:
            raise RuntimeError("int8 tier not materialized; call ensure_tier('int8')")
        return self._int8

    def int8_resident_norms(self) -> torch.Tensor:
        """norms_sq of :meth:`int8_resident` alone — the only int8 channel
        mutations will touch."""
        return self.int8_resident().norms_sq

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
