"""DatasetStore — the in-memory part of the dataset layer.

A store holds equal padded f32 shards: vectors zero-padded to
(rows_per_shard, padded_dim) and row norms with +inf on padded rows, the
mask channel every executor honours. Two layouts:

* one shard (``from_array(x)``): the resident fast path. The shard lives on
  the device of the array it was built from, so a dataset generated on the
  card is padded there with no host copy;
* equal host-RAM shards (``from_array(x, rows_per_shard=...)``): the
  out-of-core layout the streamed executors read shard by shard. Each shard
  is padded (and its norms taken) on the input's device, then kept in host
  memory, page-locked when asked (``pin_memory=True`` or :meth:`pin`): the
  double buffer's copies overlap compute only from pinned memory.

Tiers:

* ``f32``  — the exact base tier, always present;
* ``int8`` — the 1 B/element scan tier (``repro_torch.core.quantized``):
             per-row int8 codes + scales + a certified per-row error bound
             + the exact quantised norm, built by :meth:`ensure_tier` shard
             by shard. Its padded rows carry +inf norms.

Mutations (upsert / delete with the write-ahead journal), mmap shards,
delta shards, CRCs and compaction are ported in the store slice: ``upsert``
and ``delete`` raise ``NotImplementedError``, :meth:`delta_shards` is empty
and ``is_mmap`` is False until then.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.core.partition import LANE, PaddedDataset, make_padded, pad_rows, round_up
from repro_torch.core.planner import DatasetStoreMeta
from repro_torch.core.quantized import Int8Partition, QuantizedDataset, quantize_dataset

F32_TIER = "f32"
INT8_TIER = "int8"


#: The int8 tier of one shard: a QuantizedDataset over its padded rows.
Int8Shard = QuantizedDataset


def _check_tier(tier: str) -> None:
    if tier not in (F32_TIER, INT8_TIER):
        raise ValueError(f"unknown tier {tier!r}; known: {F32_TIER}, {INT8_TIER}")


class _ShardSource:
    """Restartable view over one store tier: ``iter()`` opens a fresh
    :meth:`DatasetStore.iter_shards` pass, as the double buffer needs to
    re-iterate a stream."""

    def __init__(self, store, tier: str):
        self._store = store
        self._tier = tier

    def __iter__(self):
        return self._store.iter_shards(self._tier)


class DatasetStore:
    """Equal padded f32 shards (+ an optional int8 tier); build with
    :meth:`from_array`."""

    def __init__(self, shards: list[PaddedDataset], pinned: bool = False,
                 int8: list[Int8Shard] | None = None):
        """Equal padded shards (norms +inf past each shard's n_valid) and,
        optionally, their int8 tier, one QuantizedDataset a shard."""
        if not shards:
            raise ValueError("a store needs at least one shard")
        self._shards = list(shards)
        self._n_valid = sum(s.n_valid for s in self._shards)
        self._pinned = bool(pinned)
        self._int8: list[Int8Shard] | None = None
        self._int8_qnorm: list[torch.Tensor] | None = None  # validity folded in
        if int8 is not None:
            self._set_int8(list(int8))

    def _set_int8(self, int8: list[Int8Shard]) -> None:
        # validity (padding) folds onto the exact quantised norm: the one
        # channel the streamed scan step masks on
        self._int8 = int8
        folded = (torch.where(torch.isfinite(i8.norms_sq), i8.qnorm_sq, torch.inf)
                  for i8 in int8)
        self._int8_qnorm = [_host(t, True) if self._pinned else t for t in folded]

    @classmethod
    def from_array(cls, vectors, rows_per_shard: int | None = None, row_mult: int = LANE,
                   dim_mult: int = LANE, pin_memory: bool = False) -> "DatasetStore":
        """Build a store from an (N, d) numpy array or tensor.

        ``rows_per_shard=None`` builds one shard padded on the tensor's own
        device to (round_up(N, row_mult), round_up(d, dim_mult)). Otherwise
        equal shards of round_up(rows_per_shard, row_mult) rows, the last
        one padded, are made on the input's device and kept in host memory
        (page-locked with ``pin_memory=True``).
        """
        v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
            np.asarray(vectors, dtype=np.float32))
        if v.ndim != 2:
            raise ValueError(f"expected (N, d) dataset, got {tuple(v.shape)}")
        v = v.to(torch.float32)
        if rows_per_shard is None:
            shards = [make_padded(v, row_mult=row_mult, dim_mult=dim_mult)]
            pin_memory = False
        else:
            rows = round_up(max(int(rows_per_shard), 1), row_mult)
            shards = []
            for start in range(0, max(v.shape[0], 1), rows):
                nv = min(rows, max(0, v.shape[0] - start))
                p = make_padded(pad_rows(v[start: start + rows], rows), base_index=start,
                                row_mult=row_mult, dim_mult=dim_mult)
                p.norms[nv:] = torch.inf
                shards.append(PaddedDataset(_host(p.vectors, pin_memory),
                                            _host(p.norms, pin_memory), nv, start))
        for s in shards:
            if not bool(torch.isfinite(s.norms[:s.n_valid]).all()):
                # +inf is the mask sentinel every executor honours: a row whose
                # norm overflows f32 would be stored yet never returnable
                raise ValueError(
                    "rows with non-finite f32 squared norms cannot be stored "
                    "(values this large would be silently unreturnable)")
        return cls(shards, pinned=pin_memory)

    # ------------------------------------------------------------ geometry
    @property
    def padded_dim(self) -> int:
        return int(self._shards[0].vectors.shape[1])

    @property
    def rows_per_shard(self) -> int:
        return int(self._shards[0].vectors.shape[0])

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def n_main(self) -> int:
        """Rows in the main shards."""
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
    def is_mmap(self) -> bool:
        """Shards are files (the store slice); always host RAM here."""
        return False

    @property
    def is_pinned(self) -> bool:
        """Every shard (and int8 shard) is in page-locked host memory."""
        return self._pinned

    @property
    def mutation_count(self) -> int:
        """Bumped on every mutation; this slice has none."""
        return 0

    def pin(self) -> "DatasetStore":
        """Move every host shard into page-locked memory, once (idempotent).
        Raises if a shard lies on a device: only host shards stream."""
        if self._pinned:
            return self
        if any(s.vectors.device.type != "cpu" for s in self._shards):
            raise ValueError("only a host-RAM store can be pinned; this one lies on "
                             f"{self._shards[0].vectors.device}")
        self._shards = [s._replace(vectors=s.vectors.pin_memory(), norms=s.norms.pin_memory())
                        for s in self._shards]
        if self._int8 is not None:
            self._int8 = [QuantizedDataset(*(t.pin_memory() for t in i8)) for i8 in self._int8]
            self._int8_qnorm = [t.pin_memory() for t in self._int8_qnorm]
        self._pinned = True
        return self

    def has_tier(self, tier: str) -> bool:
        return tier == F32_TIER or (tier == INT8_TIER and self._int8 is not None)

    def ensure_tier(self, tier: str, device=None) -> None:
        """Materialise `tier` (idempotent). The int8 tier is quantised shard
        by shard from the padded f32 rows, on ``device`` (None: where the
        shard lies), and kept beside them; padded rows get +inf norms so the
        masked quantised scan can never admit them."""
        _check_tier(tier)
        if tier == F32_TIER or self._int8 is not None:
            return
        int8 = []
        for s in self._shards:
            home = s.vectors.device
            qd = quantize_dataset(s.vectors if device is None else s.vectors.to(device))
            qd.norms_sq[s.n_valid:] = torch.inf
            int8.append(QuantizedDataset(*(_host(t, self._pinned) if home.type == "cpu"
                                           else t.to(home) for t in qd)))
        self._set_int8(int8)

    def _require_int8(self) -> None:
        if self._int8 is None:
            raise RuntimeError("int8 tier not materialized; call ensure_tier('int8')")

    def int8_resident(self) -> Int8Shard:
        """The int8 tier as one QuantizedDataset over all shards (the
        store's own tensors for a one-shard store)."""
        self._require_int8()
        if len(self._int8) == 1:
            return self._int8[0]
        return QuantizedDataset(*(torch.cat(parts) for parts in zip(*self._int8)))

    def int8_resident_norms(self) -> torch.Tensor:
        """norms_sq of :meth:`int8_resident` alone — the only int8 channel
        mutations will touch."""
        return self.int8_resident().norms_sq

    def nbytes(self, tier: str = F32_TIER) -> int:
        """Scan bytes of one full pass over the main shards at `tier`."""
        per_elem = 4 if tier == F32_TIER else 1
        return self.n_shards * self.rows_per_shard * self.padded_dim * per_elem

    def meta(self, device_resident: bool, tier: str = F32_TIER,
             sharded: bool = False) -> DatasetStoreMeta:
        """Planner-visible facts: geometry + tier + residency + shard count."""
        return DatasetStoreMeta(
            padded_rows=self.n_shards * self.rows_per_shard, padded_dim=self.padded_dim,
            n_valid=self.n_main, sharded=sharded, resident=device_resident,
            tier=tier, n_shards=self.n_shards, rows_per_shard=self.rows_per_shard,
            mmap=self.is_mmap,
        )

    def resident(self) -> PaddedDataset:
        """The main shards as one PaddedDataset (the store's own tensors for
        a one-shard store; a concatenation otherwise)."""
        if len(self._shards) == 1:
            return self._shards[0]
        return PaddedDataset(torch.cat([s.vectors for s in self._shards]),
                             torch.cat([s.norms for s in self._shards]), self._n_valid, 0)

    # ------------------------------------------------------------- read side
    def read_shard(self, i: int, tier: str = F32_TIER):
        """One main shard at `tier`, the unit of streamed resilience: a
        PaddedDataset (f32) or an Int8Partition (int8, validity folded onto
        ``qnorm``). The store's own host tensors, never copies."""
        _check_tier(tier)
        if not 0 <= i < len(self._shards):
            raise IndexError(f"shard {i} out of range (n={len(self._shards)})")
        s = self._shards[i]
        if tier == F32_TIER:
            return s
        self._require_int8()
        i8 = self._int8[i]
        return Int8Partition(i8.q, i8.scales, i8.err, self._int8_qnorm[i], s.n_valid,
                             s.base_index)

    def delta_shards(self) -> list[PaddedDataset]:
        """Appended rows as padded shards: none until the store slice brings
        mutations."""
        return []

    def iter_shards(self, tier: str = F32_TIER) -> Iterator:
        """A fresh pass over the shards at `tier` (restartable: every call
        opens a new pass). ``f32`` yields PaddedDataset over main + delta
        shards, ``int8`` the multi-array Int8Partition over the main ones."""
        _check_tier(tier)
        if tier == INT8_TIER:
            self._require_int8()

        def gen():
            for i in range(len(self._shards)):
                yield self.read_shard(i, tier)
            if tier == F32_TIER:
                yield from self.delta_shards()

        return gen()

    def shard_source(self, tier: str = F32_TIER) -> _ShardSource:
        """A restartable iterable over :meth:`iter_shards` at `tier`."""
        _check_tier(tier)
        return _ShardSource(self, tier)

    def __iter__(self) -> Iterator[PaddedDataset]:
        return self.iter_shards()

    def gather_rows(self, ids) -> torch.Tensor:
        """Rows of the main shards by global position -> (len(ids),
        padded_dim) f32 on the host (page-locked for a pinned store). The
        rescore of the streamed int8 executors reads only these candidate
        rows of the f32 tier. Negative and out-of-range ids give zero rows
        (callers mask them by validity). A pure read, safe beside a scan's
        shard reads (the speculative gather runs it on a thread)."""
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
        rows_per = self.rows_per_shard
        out = torch.zeros((ids.shape[0], self.padded_dim), dtype=torch.float32,
                          pin_memory=self._pinned)
        ok = (ids >= 0) & (ids < len(self._shards) * rows_per)
        dest = torch.nonzero(ok).reshape(-1)
        sid, row = ids[dest] // rows_per, ids[dest] % rows_per
        for s in torch.unique(sid).tolist():
            sel = sid == s
            pos, src = dest[sel], self._shards[s].vectors
            a, b = int(pos[0]), int(pos[-1]) + 1
            if src.device.type == "cpu" and b - a == pos.numel():
                # sorted ids (the rescore's are) put a shard's rows in one
                # run of the output: one pass, straight into it
                torch.index_select(src, 0, row[sel], out=out[a:b])
            else:
                out[pos] = src[row[sel].to(src.device)].to(torch.float32).cpu()
        return out

    # --------------------------------------------------- later slices
    def upsert(self, vectors):
        raise NotImplementedError("store mutations are ported in the store slice")

    def delete(self, ids):
        raise NotImplementedError("store mutations are ported in the store slice")


def _host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    """`t` in host memory, page-locked when `pinned`."""
    if not pinned:
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out
