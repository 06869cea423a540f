"""DatasetStore — the dataset layer: equal padded shards in host RAM or in
files, with online upserts and deletes, generations and compaction.

A store holds equal padded f32 shards: vectors zero-padded to
(rows_per_shard, padded_dim) and row norms with +inf on padded rows, the
mask channel every executor honours. Three layouts:

* one shard (``from_array(x)``): the resident fast path. The shard lives on
  the device of the array it was built from, so a dataset generated on the
  card is padded there with no host copy;
* equal host-RAM shards (``from_array(x, rows_per_shard=...)``): the
  out-of-core layout the streamed executors read shard by shard. Each shard
  is padded (and its norms taken) on the input's device, then kept in host
  memory, page-locked when asked (``pin_memory=True`` or :meth:`pin`): the
  double buffer's copies overlap compute only from pinned memory;
* files (``from_array(x, directory=...)``, reopened with :meth:`open`): the
  on-disk format of the reference package, byte for byte, so a store
  written by either package opens in the other. Per shard a raw f32 file,
  its norms and a per-row CRC sidecar; a ``manifest.json`` with a CRC32 per
  file; a ``CURRENT`` generation pointer and a journal. The f32 shards (and
  the int8 codes) are read-only ``np.memmap`` arrays: the store never holds
  their bytes in RAM, and it is never pinned. The double buffer copies each
  mapped shard through page-locked banks of its own
  (``repro_torch.core.streaming``).

Tiers:

* ``f32``  — the exact base tier, always present;
* ``int8`` — the 1 B/element scan tier (``repro_torch.core.quantized``):
             per-row int8 codes + scales + a certified per-row error bound
             + the exact quantised norm, built by :meth:`ensure_tier` shard
             by shard. Its padded rows carry +inf norms. A store in files
             writes it beside the f32 tier (``shard_*.int8.bin`` codes,
             ``shard_*.int8.npz`` per-row channels, both CRC'd in the
             manifest).

**Online mutation** is an append-only delta plus a tombstone mask:

* :meth:`upsert` appends rows to fixed-geometry delta shards (blocks of
  ``min(delta_rows, rows_per_shard)`` rows, made where the main shards
  live: on the card, in page-locked or pageable host memory) and returns
  their external ids, never reused;
* :meth:`delete` flips a tombstone: a +inf norm written into the shard's
  norms (and the int8 tier's folded validity channel), in place and on the
  shard's own device. Mutations never change a shape.

**Crash-safe lifecycle** (stores in files), the reference's protocol:

* every upsert and delete is logged to the CRC-framed write-ahead journal
  (:mod:`repro_torch.store.journal`) and fsync'd *before* it is applied,
  so :meth:`open` replays acknowledged mutations and discards torn tails;
* :meth:`compact` folds the delta rows and tombstones into a new immutable
  generation (``gen_NNNNNN/``, the int8 tier quantised again when the old
  generation had one), then switches readers with one atomic ``CURRENT``
  update. Searches pin the generation they started on (:meth:`snapshot` →
  :class:`StoreView`); a retired generation's files go only when it is
  unpinned. Geometry is kept across generations.

External ids survive compaction: a generation carries an optional per-row
id table (``rowids.npy``). Positions within a generation are internal;
:class:`StoreView` translates both ways (``external_ids`` /
``positional_mask``).

Faults: :meth:`read_shard` and :meth:`gather_rows` fire the hooks of a
``repro_torch.faults.FaultInjector`` (the store's own, else the
process-wide one) and, with ``verify_on_read``, re-check the manifest's
CRCs, raising ``ShardCorruptError``; the journal and the compactor visit
the ten ``faults.CRASH_SITES``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.distance import row_norms_sq
from repro_torch.core.partition import LANE, PaddedDataset, make_padded, pad_rows, round_up
from repro_torch.core.planner import DatasetStoreMeta
from repro_torch.core.streaming import stage_threads
from repro_torch.core.quantized import (
    Int8Partition,
    QuantizedDataset,
    quantize_dataset,
    quantized_norm_sq,
)
from repro_torch.faults import ShardCorruptError
from repro_torch.store.journal import (
    JOURNAL_NAME,
    Journal,
    decode_upsert,
    encode_delete,
    encode_upsert,
)
from repro_torch.store.manifest import (
    CURRENT_NAME,
    MANIFEST_NAME,
    Manifest,
    ShardMeta,
    crc32_of,
    crc32_of_arrays,
    read_current,
    write_current,
)

F32_TIER = "f32"
INT8_TIER = "int8"

#: Default cap on delta-shard geometry: small enough that the first upsert
#: on a huge store does not allocate a main-sized block, aligned so every
#: delta shard of a store has one shape.
DELTA_ROWS_DEFAULT = 4096

#: manifest files/checksums key of the per-row CRC sidecar of the f32 tier
#: (uint32 per padded row): what lets gather_rows verify candidate rows
#: without re-hashing the whole shard
ROWCRC_KEY = "f32_rowcrc"
#: manifest files/checksums key of the int8 tier's per-row channels (npz)
INT8_META = "int8_meta"
#: npz member order of the int8 meta file, and the order its checksum
#: (crc32_of_arrays) runs over the arrays
_INT8_META_FIELDS = ("scales", "err", "norms_sq", "qnorm_sq")

#: per-generation external-id table (int64 per main row); absent / "" in
#: the manifest means identity (position == id)
ROW_IDS_NAME = "rowids.npy"
GEN_DIR_FMT = "gen_{:06d}"

#: a gather from a mapped shard splits into pieces of at least this many
#: rows, one a host thread
GATHER_PIECE_ROWS = 256

#: The int8 tier of one shard: a QuantizedDataset over its padded rows.
Int8Shard = QuantizedDataset


def _f32_name(i: int) -> str:
    return f"shard_{i:05d}.f32.bin"


def _norms_name(i: int) -> str:
    return f"shard_{i:05d}.norms.npy"


def _rowcrc_name(i: int) -> str:
    return f"shard_{i:05d}.rowcrc.npy"


def _int8_codes_name(i: int) -> str:
    return f"shard_{i:05d}.int8.bin"


def _int8_meta_name(i: int) -> str:
    return f"shard_{i:05d}.int8.npz"


def _row_crcs(block: np.ndarray) -> np.ndarray:
    """uint32 CRC32 per row of a contiguous f32 block."""
    b = np.ascontiguousarray(block, dtype=np.float32)
    return np.asarray([zlib.crc32(r.tobytes()) & 0xFFFFFFFF for r in b], dtype=np.uint32)


def _write_file(directory: str, name: str, write) -> None:
    """Write ``name`` under a temporary name, fsync it, then rename it into
    place: no reader sees a torn file, and a live mapping of an older file
    of that name keeps its own bytes (the file is replaced, not truncated)."""
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _try_remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _check_tier(tier: str) -> None:
    if tier not in (F32_TIER, INT8_TIER):
        raise ValueError(f"unknown tier {tier!r}; known: {F32_TIER}, {INT8_TIER}")


def _check_norms(norms: torch.Tensor, n_valid: int) -> None:
    if not bool(torch.isfinite(norms[:n_valid]).all()):
        # +inf is the mask sentinel every executor honours: a row whose norm
        # overflows f32 would be stored yet never returnable
        raise ValueError(
            "rows with non-finite f32 squared norms cannot be stored "
            "(values this large would be silently unreturnable)")


def _tensor(a) -> torch.Tensor:
    """A tensor as it is; an array (a mapping) read into a new host tensor."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _cat(parts) -> torch.Tensor:
    """Host tensors concatenated, or mapped arrays read once into one."""
    if all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(list(parts))
    return torch.from_numpy(np.concatenate([np.asarray(p) for p in parts]))


def _take(src: np.ndarray, rows: np.ndarray, out: np.ndarray) -> None:
    """``out[:] = src[rows]`` for a mapped shard, in row pieces over host
    threads: each row read through a mapping takes its own page faults,
    which threads overlap (numpy releases the interpreter lock)."""
    n = min(stage_threads(), len(rows) // GATHER_PIECE_ROWS)
    if n <= 1:
        np.take(src, rows, axis=0, out=out)
        return
    cuts = [len(rows) * j // n for j in range(n + 1)]
    with ThreadPoolExecutor(n, thread_name_prefix="store-gather") as pool:
        for f in [pool.submit(np.take, src, rows[a:b], 0, out[a:b])
                  for a, b in zip(cuts, cuts[1:])]:
            f.result()


def _as_rows(vectors) -> torch.Tensor:
    v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
        np.asarray(vectors, dtype=np.float32))
    return v.to(torch.float32)


def _id_list(ids) -> list[int]:
    if isinstance(ids, torch.Tensor):
        return [int(g) for g in ids.reshape(-1).tolist()]
    return [int(g) for g in np.atleast_1d(np.asarray(ids, dtype=np.int64))]


def _pad_block(v: torch.Tensor, rows: int, padded_dim: int, base_index: int) -> PaddedDataset:
    """Rows of `v` (at most `rows`) zero-padded to (rows, padded_dim) on
    v's device, with their norms and +inf on the padded rows."""
    nv = int(v.shape[0])
    block = v.new_zeros((rows, padded_dim))
    block[:nv, : v.shape[1]] = v
    norms = row_norms_sq(block)
    norms[nv:] = torch.inf
    _check_norms(norms, nv)
    return PaddedDataset(block, norms, nv, base_index)


def _write_shards(v: torch.Tensor, rows: int, padded_dim: int,
                  directory: str) -> list[ShardMeta]:
    """Write the f32 tier of one generation from (n, d) rows: per shard the
    raw f32 rows, their norms and per-row CRCs, each fsync'd (the
    reference's bytes); at least one shard. Returns their manifest entries."""
    n = int(v.shape[0])
    metas = []
    for i in range(max(1, math.ceil(n / rows))):
        start = i * rows
        p = _pad_block(v[start: start + rows], rows, padded_dim, start)
        block, norms = p.vectors.cpu().numpy(), p.norms.cpu().numpy()
        rowcrc = _row_crcs(block)
        files = {F32_TIER: _f32_name(i), "f32_norms": _norms_name(i),
                 ROWCRC_KEY: _rowcrc_name(i)}
        _write_file(directory, files[F32_TIER], block.tofile)
        _write_file(directory, files["f32_norms"], lambda f: np.save(f, norms))
        _write_file(directory, files[ROWCRC_KEY], lambda f: np.save(f, rowcrc))
        metas.append(ShardMeta(shard_id=i, row_start=start, n_valid=p.n_valid,
                               padded_rows=rows, padded_dim=padded_dim, files=files,
                               checksums={F32_TIER: crc32_of(block),
                                          ROWCRC_KEY: crc32_of(rowcrc)}))
    return metas


def _map_shards(gen_dir: str, manifest: Manifest, verify: bool):
    """The f32 shards of a generation in files as read-only mappings, their
    norms in host tensors (copies) and their row-CRC sidecars."""
    shards, rowcrcs = [], []
    for m in manifest.shards:
        vec = np.memmap(os.path.join(gen_dir, m.files[F32_TIER]), dtype=np.float32,
                        mode="r", shape=(m.padded_rows, m.padded_dim))
        norms = np.load(os.path.join(gen_dir, m.files["f32_norms"]))
        rowcrc = (np.load(os.path.join(gen_dir, m.files[ROWCRC_KEY]))
                  if ROWCRC_KEY in m.files else None)
        if verify and crc32_of(vec) != m.checksums[F32_TIER]:
            raise ValueError(f"checksum mismatch on shard {m.shard_id} "
                             f"({m.files[F32_TIER]}): file corrupt or truncated")
        if (verify and rowcrc is not None and ROWCRC_KEY in m.checksums
                and crc32_of(rowcrc) != m.checksums[ROWCRC_KEY]):
            raise ValueError(f"checksum mismatch on row-CRC sidecar of shard "
                             f"{m.shard_id} ({m.files[ROWCRC_KEY]}): file corrupt "
                             f"or truncated")
        shards.append(PaddedDataset(vec, torch.from_numpy(norms.astype(np.float32)),
                                    m.n_valid, m.row_start))
        rowcrcs.append(rowcrc)
    return shards, rowcrcs


class _ShardSource:
    """Restartable view over one store tier: ``iter()`` opens a fresh
    :meth:`DatasetStore.iter_shards` pass, as the double buffer needs to
    re-iterate a stream."""

    def __init__(self, store, tier: str):
        self._store = store
        self._tier = tier

    def __iter__(self):
        return self._store.iter_shards(self._tier)


class _Generation:
    """One shard set plus the mutable delta that rides on it.

    All per-epoch state lives here (shards, tiers, tombstones, delta rows,
    id table), so the compactor's reader swap is one reference assignment
    ``store._gen = new_gen``, and a search that pinned the old object keeps
    a consistent view until it unpins. Shards are the port's own: tensors on
    the card or in host RAM (pinned or not), or read-only mappings."""

    __slots__ = ("number", "manifest", "shards", "rowcrc", "int8", "int8_norms", "int8_qnorm", "int8_one",
                 "directory", "row_ids", "identity", "n_main", "delta", "n_delta",
                 "delta_ids", "delta_tomb", "main_tomb", "dead_main", "dead_delta",
                 "refs", "obsolete", "collected", "lut")

    def __init__(self, number: int, shards: list[PaddedDataset],
                 manifest: Manifest | None = None, directory: str | None = None,
                 rowcrc=None, row_ids: np.ndarray | None = None):
        self.number = number
        self.manifest = manifest
        self.shards = list(shards)
        self.rowcrc = list(rowcrc) if rowcrc is not None else [None] * len(self.shards)
        self.int8: list[Int8Shard] | None = None  # as built or read: never written
        # the int8 tier's validity, tombstones folded in (flipped in place):
        # norms_sq, and the exact quantised norm the streamed scan masks on
        self.int8_norms: list[torch.Tensor] | None = None
        self.int8_qnorm: list[torch.Tensor] | None = None
        self.int8_one: Int8Shard | None = None  # one shard's tier, folded norms_sq
        self.directory = directory  # the generation's directory (None in RAM)
        self.row_ids = row_ids  # (n_main,) int64, or None = identity
        self.identity = row_ids is None
        self.n_main = sum(s.n_valid for s in self.shards)
        self.delta: list[tuple[torch.Tensor, torch.Tensor]] = []  # (block, norms)
        self.n_delta = 0
        self.delta_ids: list[int] = []  # external id per delta row
        self.delta_tomb: list[bool] = []
        self.main_tomb = np.zeros(self.n_main, dtype=bool)
        self.dead_main = 0
        self.dead_delta = 0
        self.refs = 0  # pinned readers (StoreView / iter_shards passes)
        self.obsolete = False  # superseded by a newer generation
        self.collected = False
        self.lut = None  # lazy external id -> position table


class StoreView:
    """A pinned, read-only view of ONE store generation.

    Holding a view keeps the generation's shards, tombstones and id tables
    valid (not garbage-collected) until :meth:`release`, so a search keeps
    scanning while the compactor swaps generations underneath it. It has
    the read surface the executors use (``read_shard`` / ``iter_shards`` /
    ``shard_source`` / ``delta_shards`` / ``gather_rows`` / ``n_shards``),
    positional within this generation, and the two id translations the
    engine needs: ``positional_mask`` (an external mask in) and
    ``external_ids`` (positional results out)."""

    def __init__(self, store: "DatasetStore", gen: _Generation):
        self._store = store
        self._gen = gen
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store._unpin(self._gen)

    def __enter__(self) -> "StoreView":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    @property
    def generation(self) -> int:
        return self._gen.number

    @property
    def identity(self) -> bool:
        """Position == external id for every row (true until a compaction
        drops a row)."""
        return self._gen.identity

    @property
    def dim(self) -> int:
        return self._store.dim

    @property
    def padded_dim(self) -> int:
        return self._store.padded_dim

    @property
    def rows_per_shard(self) -> int:
        return self._store.rows_per_shard

    @property
    def n_shards(self) -> int:
        return len(self._gen.shards)

    @property
    def n_main(self) -> int:
        return self._gen.n_main

    @property
    def n_delta(self) -> int:
        return self._gen.n_delta

    @property
    def is_mmap(self) -> bool:
        return self._store.is_mmap

    def meta(self, device_resident: bool, tier: str = F32_TIER,
             sharded: bool = False) -> DatasetStoreMeta:
        return self._store._meta_of(self._gen, device_resident, tier, sharded)

    def read_shard(self, i: int, tier: str = F32_TIER):
        return self._store._read_shard_of(self._gen, i, tier)

    def delta_shards(self) -> list[PaddedDataset]:
        return self._store._delta_shards_of(self._gen)

    def gather_rows(self, ids) -> torch.Tensor:
        return self._store._gather_rows_of(self._gen, ids)

    def iter_shards(self, tier: str = F32_TIER) -> Iterator:
        _check_tier(tier)
        g = self._gen
        if tier == INT8_TIER and g.int8 is None:
            raise RuntimeError("int8 tier not materialized; call ensure_tier('int8')")

        def gen():
            for i in range(len(g.shards)):
                yield self.read_shard(i, tier)
            if tier == F32_TIER:
                yield from self.delta_shards()

        return gen()

    def shard_source(self, tier: str = F32_TIER) -> _ShardSource:
        _check_tier(tier)
        return _ShardSource(self, tier)

    def __iter__(self) -> Iterator[PaddedDataset]:
        return self.iter_shards()

    def external_ids(self, idx) -> np.ndarray:
        """Positional result indices of this generation as external ids (-1
        stays -1; padding positions map to -1)."""
        idx = np.asarray(idx, dtype=np.int64)
        g = self._gen
        if g.identity:
            return idx
        out = np.full(idx.shape, -1, dtype=np.int64)
        rid = g.row_ids if g.row_ids is not None else np.arange(g.n_main, dtype=np.int64)
        main = (idx >= 0) & (idx < g.n_main)
        out[main] = rid[idx[main]]
        nd = len(g.delta_ids)
        if nd:
            did = np.asarray(g.delta_ids, dtype=np.int64)
            d = (idx >= g.n_main) & (idx < g.n_main + nd)
            out[d] = did[idx[d] - g.n_main]
        return out

    def positional_mask(self, mask) -> np.ndarray:
        """An external-id-indexed boolean mask (length >= n_ids) in this
        generation's positional layout (main rows, then delta rows). Ids
        compacted away have no position."""
        g = self._gen
        mask = np.asarray(mask, dtype=bool).reshape(-1)
        if g.identity:
            n_pos = g.n_main + g.n_delta
            return mask[:n_pos] if mask.shape[0] > n_pos else mask
        rid = g.row_ids if g.row_ids is not None else np.arange(g.n_main, dtype=np.int64)
        nd = len(g.delta_ids)
        out = np.zeros(g.n_main + nd, dtype=bool)
        out[: g.n_main] = mask[rid]
        if nd:
            out[g.n_main:] = mask[np.asarray(g.delta_ids, dtype=np.int64)]
        return out


class DatasetStore:
    """Equal padded f32 shards (+ an optional int8 tier), online upserts and
    deletes, and generations; build with :meth:`from_array`, reopen a store
    in files (replaying its journal) with :meth:`open`."""

    def __init__(self, shards: list[PaddedDataset], pinned: bool = False,
                 int8: list[Int8Shard] | None = None, dim: int | None = None,
                 delta_rows: int = DELTA_ROWS_DEFAULT):
        """Equal padded shards (norms +inf past each shard's n_valid) and,
        optionally, their int8 tier, one QuantizedDataset a shard. ``dim``
        is the rows' true width (default: the padded width)."""
        if not shards:
            raise ValueError("a store needs at least one shard")
        self._gen = _Generation(0, shards)
        self._rows_per_shard, self._padded_dim = (int(v) for v in shards[0].vectors.shape)
        self._dim = self._padded_dim if dim is None else int(dim)
        v0 = shards[0].vectors
        #: where delta blocks and the shards of a compacted generation live
        self._home = v0.device if isinstance(v0, torch.Tensor) else torch.device("cpu")
        self._pinned = bool(pinned)
        self._delta_rows_cap = round_up(min(int(delta_rows), self._rows_per_shard), LANE)
        #: external-id allocation counter; ids are never reused
        self._next_id = self._gen.n_main
        self._mutations = 0  # version counter; device views sync on change
        self._lock = threading.RLock()
        self._journal: Journal | None = None
        self._retired: list[_Generation] = []  # obsolete but still pinned
        self._compact_state = {"running": False, "compactions": 0, "last": None,
                               "error": None}
        self._int8_device = None  # where ensure_tier quantised (compaction reuses it)
        self._directory: str | None = None  # the store's root (a store in files)
        self._closed, self._closed_n_shards = False, 0
        if int8 is not None:
            self._set_int8(self._gen, list(int8))
        #: when set, a mutation that leaves >= this many pending delta rows +
        #: tombstones starts a background compaction
        self.auto_compact_pending: int | None = None
        #: per-store fault injector (repro_torch.faults.FaultInjector); when
        #: None, the process-wide one (faults.install) applies
        self.fault_injector = None
        #: re-check the manifest's CRCs on every read_shard and the per-row
        #: CRCs on every gather_rows (an extra pass over the bytes read)
        self.verify_on_read = False

    def _set_int8(self, g: _Generation, int8: list[Int8Shard]) -> None:
        # validity (padding, then tombstones) folds onto copies of norms_sq
        # and of the exact quantised norm, the one channel the streamed scan
        # step masks on; the tier's own arrays (CRC'd in files) stay as read
        g.int8, g.int8_norms, g.int8_qnorm = int8, [], []
        for s, i8 in zip(g.shards, int8):
            norms = i8.norms_sq.clone()
            dead = g.main_tomb[s.base_index: s.base_index + s.n_valid]
            if dead.any():
                norms[torch.from_numpy(np.flatnonzero(dead)).to(norms.device)] = torch.inf
            qn = torch.where(torch.isfinite(norms), i8.qnorm_sq, torch.inf)
            g.int8_norms.append(_host(norms, True) if self._pinned else norms)
            g.int8_qnorm.append(_host(qn, True) if self._pinned else qn)
        g.int8_one = int8[0]._replace(norms_sq=g.int8_norms[0])

    @classmethod
    def from_array(cls, vectors, rows_per_shard: int | None = None, row_mult: int = LANE,
                   dim_mult: int = LANE, pin_memory: bool = False,
                   directory: str | None = None,
                   delta_rows: int = DELTA_ROWS_DEFAULT) -> "DatasetStore":
        """Build a store from an (N, d) numpy array or tensor.

        ``rows_per_shard=None`` builds one shard padded on the tensor's own
        device to (round_up(N, row_mult), round_up(d, dim_mult)). Otherwise
        equal shards of round_up(rows_per_shard, row_mult) rows, the last
        one padded, are made on the input's device and kept in host memory
        (page-locked with ``pin_memory=True``).

        With ``directory`` the shards (one shard of round_up(N, row_mult)
        rows when ``rows_per_shard`` is None) are written there in the
        reference's format instead, and the store returned reads them
        through read-only mappings (:meth:`open`). Such a store is never
        pinned.
        """
        v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
            np.asarray(vectors, dtype=np.float32))
        if v.ndim != 2:
            raise ValueError(f"expected (N, d) dataset, got {tuple(v.shape)}")
        v = v.to(torch.float32)
        if directory is not None:
            if pin_memory:
                raise ValueError("a store in files is never pinned: the double buffer "
                                 "stages its mapped shards through page-locked banks")
            rows = round_up(max(int(rows_per_shard or v.shape[0]), 1), row_mult)
            return cls._write(v, rows, directory, dim_mult, delta_rows)
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
            _check_norms(s.norms, s.n_valid)
        return cls(shards, pinned=pin_memory, dim=int(v.shape[1]), delta_rows=delta_rows)

    # ------------------------------------------------------------ on disk
    @classmethod
    def _write(cls, v: torch.Tensor, rows: int, directory: str, dim_mult: int,
               delta_rows: int) -> "DatasetStore":
        """Write generation 0 of a store: the shards (:func:`_write_shards`),
        then ``manifest.json``, ``CURRENT`` -> "." and an empty journal.
        Returns the store reopened from the files."""
        os.makedirs(directory, exist_ok=True)
        n, d = int(v.shape[0]), int(v.shape[1])
        metas = _write_shards(v, rows, round_up(max(d, 1), dim_mult), directory)
        Manifest(dim=d, padded_dim=metas[0].padded_dim, rows_per_shard=rows,
                 n_valid=n, tiers=(F32_TIER,), shards=tuple(metas), generation=0,
                 next_id=n).save(directory)
        write_current(directory, ".")
        _write_file(directory, JOURNAL_NAME, lambda f: None)
        return cls.open(directory, delta_rows=delta_rows)

    @classmethod
    def open(cls, directory: str, verify: bool = False, verify_on_read: bool = False,
             delta_rows: int = DELTA_ROWS_DEFAULT) -> "DatasetStore":
        """Reopen a store written in files by either package; its shards
        stay on disk (read-only ``np.memmap``).

        Recovery, in the reference's order: (1) resolve the live generation
        through ``CURRENT`` ("." or a ``gen_NNNNNN/`` directory; none means
        the root); (2) validate its manifest (``ManifestError`` names the
        field) and map every f32 shard (and the int8 codes when the manifest
        lists the tier), loading the id table of a compacted generation;
        (3) sweep what a crashed compaction left behind (orphan generation
        directories, tmp files, a superseded generation 0); (4) replay the
        generation's journal, truncating a torn tail. Every crash point
        reopens to the state before or after the interrupted operation.

        ``verify=True`` recomputes the CRC of every file and raises
        ``ValueError`` on a mismatch (it reads every shard once);
        ``verify_on_read=True`` re-checks them on every read instead.
        """
        gen_name = read_current(directory) or "."
        gen_dir = directory if gen_name == "." else os.path.join(directory, gen_name)
        manifest = Manifest.load(gen_dir).validate()
        shards, rowcrcs = _map_shards(gen_dir, manifest, verify)
        int8 = None
        if INT8_TIER in manifest.tiers:
            int8 = [cls._load_int8_shard(gen_dir, m, verify) for m in manifest.shards]
        store = cls(shards, dim=manifest.dim, delta_rows=delta_rows)
        g = store._gen
        g.number, g.manifest, g.directory, g.rowcrc = manifest.generation, manifest, gen_dir, rowcrcs
        if manifest.row_ids_file:
            g.row_ids = np.asarray(np.load(os.path.join(gen_dir, manifest.row_ids_file)),
                                   dtype=np.int64)
            g.identity = bool(np.array_equal(g.row_ids, np.arange(g.row_ids.shape[0])))
        if int8 is not None:
            store._set_int8(g, int8)
        store._directory = directory
        store._next_id = manifest.next_id if manifest.next_id >= 0 else manifest.n_valid
        store.verify_on_read = bool(verify_on_read)
        store._sweep_stale(gen_name)
        store._attach_journal(gen_dir)
        store._replay_journal()
        return store

    def _attach_journal(self, gen_dir: str) -> None:
        self._journal = Journal(os.path.join(gen_dir, JOURNAL_NAME), self._injector)

    def _replay_journal(self) -> int:
        """Apply acknowledged, uncompacted mutations from the generation's
        journal (a torn tail is truncated: ``Journal.replay``), through the
        same in-memory paths the mutations take, minus the journaling: a
        replayed store equals one that never crashed."""
        n = 0
        for rec in self._journal.replay():
            op = rec.get("op")
            if op == "upsert":
                id0, v = decode_upsert(rec)
                padded, norms = self._padded_rows(torch.from_numpy(v.copy()))
                ids = np.arange(id0, id0 + v.shape[0], dtype=np.int64)
                self._apply_upsert_gen(self._gen, padded, norms, ids)
            elif op == "delete":
                pos = self._resolve_delete_locked([int(g) for g in rec["ids"]])
                self._tombstone_gen(self._gen, pos)
            else:  # an op of a future version: fail loud, not quiet
                raise ValueError(f"unknown journal record op {op!r}")
            self._mutations += 1
            n += 1
        return n

    def _sweep_stale(self, gen_name: str) -> None:
        """Remove what a crashed compaction may have left: generation
        directories ``CURRENT`` does not name, tmp pointer and manifest
        files, and, once the pointer has left the root, generation 0's
        superseded files."""
        root = self._directory
        _try_remove(os.path.join(root, CURRENT_NAME + ".tmp"))
        for name in sorted(os.listdir(root)):
            if (name.startswith("gen_") and name != gen_name
                    and os.path.isdir(os.path.join(root, name))):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        if gen_name == ".":
            return
        root_manifest = os.path.join(root, MANIFEST_NAME)
        if os.path.exists(root_manifest):
            try:
                old = Manifest.load(root)
            except Exception:
                old = None
            if old is not None:
                for m in old.shards:
                    for fname in m.files.values():
                        _try_remove(os.path.join(root, fname))
                if old.row_ids_file:
                    _try_remove(os.path.join(root, old.row_ids_file))
            _try_remove(root_manifest)
        _try_remove(os.path.join(root, MANIFEST_NAME + ".tmp"))
        _try_remove(os.path.join(root, JOURNAL_NAME))

    @staticmethod
    def _load_int8_shard(directory: str, m: ShardMeta, verify: bool) -> Int8Shard:
        """One shard's int8 tier from its files: the codes as a read-only
        mapping, the per-row channels from their npz. ``verify=True``
        recomputes both CRCs; an unreadable meta file is corruption either
        way. The legacy format (one ``.int8.npz`` holding the codes too) is
        read into host RAM, its exact quantised norm re-derived from codes +
        scales where it is missing."""
        codes_file = m.files[INT8_TIER]
        legacy = codes_file.endswith(".npz")
        meta_file = codes_file if legacy else m.files[INT8_META]
        try:
            with np.load(os.path.join(directory, meta_file)) as z:
                meta = {name: z[name] for name in z.files}
        except Exception as e:
            raise ValueError(f"int8 meta of shard {m.shard_id} ({meta_file}) is "
                             f"unreadable: file corrupt or truncated ({e})") from e
        if legacy:
            codes = meta.pop("q")
            if verify and crc32_of(codes) != m.checksums[INT8_TIER]:
                raise ValueError(f"checksum mismatch on int8 codes of shard {m.shard_id} "
                                 f"({codes_file}): file corrupt or truncated")
            ch = {f: torch.from_numpy(meta[f].astype(np.float32)) for f in meta}
            codes = torch.from_numpy(codes)
            if "qnorm_sq" not in ch:
                ch["qnorm_sq"] = quantized_norm_sq(codes, ch["scales"])
            return Int8Shard(codes, *(ch[f] for f in _INT8_META_FIELDS))
        codes = np.memmap(os.path.join(directory, codes_file), dtype=np.int8, mode="r",
                          shape=(m.padded_rows, m.padded_dim))
        if verify:
            if crc32_of(codes) != m.checksums[INT8_TIER]:
                raise ValueError(f"checksum mismatch on int8 codes of shard {m.shard_id} "
                                 f"({codes_file}): file corrupt or truncated")
            if crc32_of_arrays(*(meta[f] for f in _INT8_META_FIELDS)) != m.checksums[INT8_META]:
                raise ValueError(f"checksum mismatch on int8 meta of shard {m.shard_id} "
                                 f"({meta_file}): file corrupt or truncated")
        return Int8Shard(codes, *(torch.from_numpy(meta[f].astype(np.float32))
                                  for f in _INT8_META_FIELDS))

    @staticmethod
    def _write_int8(g: _Generation, i: int, qd: QuantizedDataset) -> tuple[Int8Shard, ShardMeta]:
        """Persist one shard's int8 tier (host tensors) into the generation's
        directory: the codes as a raw file, the per-row channels as an npz,
        both CRC'd into the shard's manifest entry; the codes come back as a
        read-only mapping."""
        m = g.manifest.shards[i]
        codes_name, meta_name = _int8_codes_name(m.shard_id), _int8_meta_name(m.shard_id)
        codes = qd.q.numpy()
        channels = {f: getattr(qd, f).numpy() for f in _INT8_META_FIELDS}
        _write_file(g.directory, codes_name, codes.tofile)
        _write_file(g.directory, meta_name, lambda f: np.savez(f, **channels))
        meta = dataclasses.replace(
            m, files={**m.files, INT8_TIER: codes_name, INT8_META: meta_name},
            checksums={**m.checksums, INT8_TIER: crc32_of(codes),
                       INT8_META: crc32_of_arrays(*channels.values())})
        mapped = np.memmap(os.path.join(g.directory, codes_name), dtype=np.int8, mode="r",
                           shape=codes.shape)
        return qd._replace(q=mapped), meta

    # ---------------------------------------------- generation-delegating
    @property
    def _shards(self) -> list[PaddedDataset]:
        return self._gen.shards

    @property
    def _int8(self) -> list[Int8Shard] | None:
        return self._gen.int8

    # ------------------------------------------------------------ geometry
    @property
    def dim(self) -> int:
        """The rows' true width."""
        return self._dim

    @property
    def padded_dim(self) -> int:
        return self._padded_dim

    @property
    def rows_per_shard(self) -> int:
        return self._rows_per_shard

    @property
    def n_shards(self) -> int:
        return self._closed_n_shards if self._closed else len(self._gen.shards)

    @property
    def n_main(self) -> int:
        """Rows in the main shards, tombstoned or not."""
        return self._gen.n_main

    @property
    def n_delta(self) -> int:
        """Rows in the delta shards, tombstoned or not."""
        return self._gen.n_delta

    @property
    def n_ids(self) -> int:
        """Size of the external id space (ids ever allocated; compaction
        reclaims rows, never ids)."""
        return self._next_id

    @property
    def n_live(self) -> int:
        """Rows a query must see: main + delta, minus tombstones."""
        g = self._gen
        return g.n_main + g.n_delta - g.dead_main - g.dead_delta

    @property
    def generation(self) -> int:
        """Number of the live generation (bumped by every compaction):
        engines watch it beside :attr:`mutation_count` to tell a full view
        rebuild from a norms refresh."""
        return self._gen.number

    @property
    def is_mmap(self) -> bool:
        """Shards are read-only mappings of files (:meth:`open`)."""
        return self._directory is not None

    @property
    def directory(self) -> str | None:
        """The store's root directory (None for a store in host RAM)."""
        return self._directory

    @property
    def manifest(self) -> Manifest | None:
        """The live generation's manifest (None for a store in host RAM)."""
        return self._gen.manifest

    @property
    def tiers(self) -> tuple:
        """The tiers materialised: ``("f32",)`` or ``("f32", "int8")``."""
        return (F32_TIER,) if self._gen.int8 is None else (F32_TIER, INT8_TIER)

    @property
    def is_pinned(self) -> bool:
        """Every shard (and int8 shard) is in page-locked host memory."""
        return self._pinned

    @property
    def mutation_count(self) -> int:
        """Bumped on every upsert and delete, and once a generation swap;
        device views resync when it moves."""
        return self._mutations

    def close(self) -> None:
        """Release the journal and drop the store's references to its live
        generation (for a store in files: its mappings, which the OS unmaps
        once no array read from them is left). A closed store cannot be
        read; views pinned before keep their generation."""
        with self._lock:
            if self._journal is not None:
                self._journal.close()
            self._closed, self._closed_n_shards = True, len(self._gen.shards)
            self._gen = _Generation(self._gen.number, [])

    def _live(self) -> _Generation:
        if self._closed:
            raise ValueError("the store is closed")
        return self._gen

    def pin(self) -> "DatasetStore":
        """Move every host shard (main, delta and int8) into page-locked
        memory, once (idempotent). Raises if a shard lies on a device (only
        host shards stream) or in a file (a mapping is never pinned)."""
        if self._pinned:
            return self
        if self.is_mmap:
            raise ValueError("a store in files is never pinned: the double buffer stages "
                             "its mapped shards through page-locked banks of its own")
        g = self._live()
        if self._home.type != "cpu":
            raise ValueError(f"only a host-RAM store can be pinned; this one lies on "
                             f"{g.shards[0].vectors.device}")
        with self._lock:
            g.shards = [s._replace(vectors=s.vectors.pin_memory(), norms=s.norms.pin_memory())
                        for s in g.shards]
            g.delta = [(b.pin_memory(), n.pin_memory()) for b, n in g.delta]
            if g.int8 is not None:
                g.int8 = [QuantizedDataset(*(t.pin_memory() for t in i8)) for i8 in g.int8]
                g.int8_norms = [t.pin_memory() for t in g.int8_norms]
                g.int8_qnorm = [t.pin_memory() for t in g.int8_qnorm]
                g.int8_one = g.int8[0]._replace(norms_sq=g.int8_norms[0])
            self._pinned = True
        return self

    def has_tier(self, tier: str) -> bool:
        return tier == F32_TIER or (tier == INT8_TIER and self._gen.int8 is not None)

    # ------------------------------------------------------------- mutation
    def _padded_rows(self, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(m, dim) rows zero-padded to padded_dim on their device, and
        their norms; rows whose norm overflows are refused."""
        if v.ndim == 1:
            v = v[None, :]
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"upsert expects (m, {self.dim}) vectors, got {tuple(v.shape)}")
        padded = v.new_zeros((v.shape[0], self.padded_dim))
        padded[:, : self.dim] = v
        norms = row_norms_sq(padded)
        _check_norms(norms, int(v.shape[0]))
        return padded, norms

    def upsert(self, vectors) -> np.ndarray:
        """Append rows (a numpy array or a tensor, (m, dim) or (dim,));
        returns their external ids (never reused).

        Durability: on a store in files the rows are framed into the
        write-ahead journal and fsync'd BEFORE they are applied or
        acknowledged. Appended rows live in fixed-geometry delta shards
        until :meth:`compact` folds them into the next generation; queries
        see them at once and exactly. Rows are padded and their norms taken
        on their own device, then copied where the store's shards live.
        """
        v = _as_rows(vectors)
        padded, norms = self._padded_rows(v)  # refuses unreturnable rows up front
        with self._lock:
            g = self._live()
            ids = np.arange(self._next_id, self._next_id + padded.shape[0], dtype=np.int64)
            if self._journal is not None:
                self._journal.append(encode_upsert(
                    int(ids[0]), padded[:, : self.dim].cpu().numpy()))
            self._apply_upsert_gen(g, padded, norms, ids)
            self._mutations += 1
            self._maybe_auto_compact_locked()
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows by external id: a +inf norm, so the row can never
        enter a kNN queue; no shape changes, no file rewritten. Journaled
        (fsync before apply) like :meth:`upsert`.

        Atomic: every id is checked before any tombstone flips (or any
        journal record lands), so a bad id (``KeyError`` naming it) leaves
        the store and the engines attached to it untouched."""
        gids = _id_list(ids)
        with self._lock:
            self._live()
            pos = self._resolve_delete_locked(gids)
            if self._journal is not None:
                self._journal.append(encode_delete(gids))
            self._tombstone_gen(self._gen, pos)
            self._mutations += 1
            self._maybe_auto_compact_locked()

    def _new_block(self, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
        """An empty delta block and its (+inf) norms where the shards live."""
        if self._home.type != "cpu":
            return (torch.zeros((rows, self.padded_dim), device=self._home),
                    torch.full((rows,), torch.inf, device=self._home))
        return (torch.zeros((rows, self.padded_dim), pin_memory=self._pinned),
                torch.full((rows,), torch.inf, pin_memory=self._pinned))

    def _apply_upsert_gen(self, g: _Generation, padded: torch.Tensor, norms: torch.Tensor,
                          ids: np.ndarray) -> None:
        if g.identity and int(ids[0]) != g.n_main + g.n_delta:
            g.identity = False
        cap, off, m = self._delta_rows_cap, 0, int(padded.shape[0])
        while off < m:
            j, r = divmod(g.n_delta, cap)
            if j == len(g.delta):
                g.delta.append(self._new_block(cap))
            block, block_norms = g.delta[j]
            take = min(cap - r, m - off)
            block[r: r + take] = padded[off: off + take].to(block.device)
            block_norms[r: r + take] = norms[off: off + take].to(block.device)
            g.n_delta += take
            off += take
        g.delta_tomb.extend([False] * m)
        g.delta_ids.extend(int(x) for x in ids)
        g.lut = None
        self._next_id = max(self._next_id, int(ids[-1]) + 1)

    def _resolve_delete_locked(self, gids: list[int]) -> list[int]:
        """Check external ids for deletion; returns their positions in the
        live generation. Raises KeyError (naming the first bad id) without
        touching any state."""
        g = self._gen
        lut = None if g.identity else self._lut_of(g)
        seen: set[int] = set()
        out: list[int] = []
        for gid in gids:
            if not 0 <= gid < self._next_id:
                raise KeyError(f"row {gid} does not exist (n={self._next_id})")
            p = gid if lut is None else int(lut[gid])
            if p < 0:
                raise KeyError(f"row {gid} already deleted")
            already = g.main_tomb[p] if p < g.n_main else g.delta_tomb[p - g.n_main]
            if already or gid in seen:
                raise KeyError(f"row {gid} already deleted")
            seen.add(gid)
            out.append(p)
        return out

    def _tombstone_gen(self, g: _Generation, positions: list[int]) -> None:
        """Flip tombstones: +inf into the norms of each row (the f32 shard's
        or delta block's, and the int8 tier's folded validity), in place on
        the tensor's own device. Mapped files are never written."""
        rows = self._rows_per_shard
        per_main: dict[int, list[int]] = {}
        per_delta: dict[int, list[int]] = {}
        for p in positions:
            if p < g.n_main:
                if not g.main_tomb[p]:
                    g.main_tomb[p] = True
                    g.dead_main += 1
                    per_main.setdefault(p // rows, []).append(p % rows)
            else:
                j = p - g.n_main
                if not g.delta_tomb[j]:
                    g.delta_tomb[j] = True
                    g.dead_delta += 1
                    per_delta.setdefault(j // self._delta_rows_cap, []).append(
                        j % self._delta_rows_cap)
        for s, rs in per_main.items():
            targets = [g.shards[s].norms] + (
                [g.int8_norms[s], g.int8_qnorm[s]] if g.int8 is not None else [])
            for t in targets:
                t[torch.tensor(rs, device=t.device)] = torch.inf
        for j, rs in per_delta.items():
            norms = g.delta[j][1]
            norms[torch.tensor(rs, device=norms.device)] = torch.inf

    def _lut_of(self, g: _Generation) -> np.ndarray:
        """Lazy external id -> generation position table (-1 = the id has no
        row in this generation: never allocated here, or compacted away)."""
        need = max(self._next_id, 1)
        if g.lut is None or g.lut.shape[0] < need:
            lut = np.full(need, -1, dtype=np.int64)
            if g.n_main:
                rid = (g.row_ids if g.row_ids is not None
                       else np.arange(g.n_main, dtype=np.int64))
                lut[rid] = np.arange(g.n_main, dtype=np.int64)
            if g.delta_ids:
                lut[np.asarray(g.delta_ids, dtype=np.int64)] = (
                    g.n_main + np.arange(len(g.delta_ids), dtype=np.int64))
            g.lut = lut
        return g.lut

    # ------------------------------------------------------------- int8 tier
    def ensure_tier(self, tier: str, device=None) -> None:
        """Materialise `tier` (idempotent). The int8 tier is quantised shard
        by shard from the padded f32 rows, on ``device`` (None: where the
        shard lies; a mapped shard is read into host RAM first), and kept
        beside them; padded and tombstoned rows get +inf validity so the
        masked quantised scan can never admit them. A store in files writes
        the tier to its generation's directory and maps the codes back. A
        compaction quantises its new generation on the last ``device`` given."""
        _check_tier(tier)
        if tier == F32_TIER:
            return
        with self._lock:
            g = self._live()
            if device is not None:
                self._int8_device = device
            if g.int8 is None:
                self._quantize_generation(g)

    def _quantize_generation(self, g: _Generation) -> None:
        """Build (and, for a generation in files, persist) the int8 tier of
        every main shard of `g`, updating its manifest."""
        device = self._int8_device
        int8, metas = [], []
        for i, s in enumerate(g.shards):
            vec = _tensor(s.vectors)
            home = vec.device
            qd = quantize_dataset(vec if device is None else vec.to(device))
            qd.norms_sq[s.n_valid:] = torch.inf
            if g.directory is not None:
                i8, meta = self._write_int8(g, i, QuantizedDataset(*(t.cpu() for t in qd)))
                int8.append(i8)
                metas.append(meta)
            else:
                int8.append(QuantizedDataset(*(_host(t, self._pinned) if home.type == "cpu"
                                               else t.to(home) for t in qd)))
        if g.directory is not None:
            g.manifest = dataclasses.replace(
                g.manifest, tiers=tuple(dict.fromkeys((*g.manifest.tiers, INT8_TIER))),
                shards=tuple(metas))
            g.manifest.save(g.directory)
        self._set_int8(g, int8)

    def _require_int8(self, g: _Generation) -> None:
        if g.int8 is None:
            raise RuntimeError("int8 tier not materialized; call ensure_tier('int8')")

    def int8_resident(self) -> Int8Shard:
        """The int8 tier as one QuantizedDataset over all main shards, its
        ``norms_sq`` carrying the tombstones (+inf): the store's own tensors
        for a one-shard store in host memory or on a device; mapped codes
        are read once into host RAM."""
        g = self._live()
        self._require_int8(g)
        if len(g.int8) == 1 and not self.is_mmap:
            return g.int8_one
        return QuantizedDataset(*(_cat(parts) for parts in zip(*g.int8)))._replace(
            norms_sq=self.int8_resident_norms())

    def int8_resident_norms(self) -> torch.Tensor:
        """norms_sq of :meth:`int8_resident` alone, tombstones folded in: the
        only int8 channel mutations touch, so engines refresh just this."""
        g = self._live()
        self._require_int8(g)
        return g.int8_norms[0] if len(g.int8_norms) == 1 else torch.cat(g.int8_norms)

    def nbytes(self, tier: str = F32_TIER) -> int:
        """Scan bytes of one full pass over the main shards at `tier`."""
        per_elem = 4 if tier == F32_TIER else 1
        return self.n_shards * self.rows_per_shard * self.padded_dim * per_elem

    def _meta_of(self, g: _Generation, device_resident: bool, tier: str,
                 sharded: bool) -> DatasetStoreMeta:
        n_shards = len(g.shards)
        return DatasetStoreMeta(
            padded_rows=n_shards * self.rows_per_shard, padded_dim=self.padded_dim,
            n_valid=g.n_main, sharded=sharded, resident=device_resident,
            tier=tier, n_shards=n_shards, rows_per_shard=self.rows_per_shard,
            mmap=self.is_mmap,
        )

    def meta(self, device_resident: bool, tier: str = F32_TIER,
             sharded: bool = False) -> DatasetStoreMeta:
        """Planner-visible facts: geometry + tier + residency + shard count."""
        return self._meta_of(self._gen, device_resident, tier, sharded)

    def resident(self) -> PaddedDataset:
        """The main shards as one PaddedDataset, tombstones in the norms
        (the store's own tensors for a one-shard store in host memory or on
        a device; a concatenation otherwise, which reads a store in files
        once). Positions equal external ids until a compaction drops a row
        (``StoreView.identity``)."""
        g = self._live()
        if len(g.shards) == 1:
            s = g.shards[0]
            return s._replace(vectors=_tensor(s.vectors)) if self.is_mmap else s
        return PaddedDataset(_cat([s.vectors for s in g.shards]), self.resident_norms(),
                             g.n_main, 0)

    def resident_norms(self) -> torch.Tensor:
        """Norms of :meth:`resident` alone — the only channel mutations
        touch, so engines refresh this (same shape, nothing rebuilt)."""
        g = self._live()
        if len(g.shards) == 1:
            return g.shards[0].norms
        return torch.cat([s.norms for s in g.shards])

    # ------------------------------------------------------------- read side
    def _injector(self):
        return self.fault_injector if self.fault_injector is not None else faults.active()

    def _verify(self, g: _Generation, i: int, key: str, got: int, what: str,
                tier: str) -> None:
        want = g.manifest.shards[i].checksums.get(key) if g.manifest is not None else None
        if want is not None and got != want:
            raise ShardCorruptError(
                f"CRC mismatch on {what} of shard {i}: bytes changed since the manifest "
                "was written", i, tier)

    def read_shard(self, i: int, tier: str = F32_TIER):
        """One main shard of the live generation at `tier`, the unit of
        streamed resilience: a PaddedDataset (f32, tombstones in its norms)
        or an Int8Partition (int8, validity and tombstones folded onto
        ``qnorm``). The store's own arrays (tensors, or read-only mappings
        for a store in files), never copies, unless the fault injector
        corrupts one. Searches that must survive a concurrent compaction
        read through a pinned :meth:`snapshot` instead.

        The fault hooks fire here (``on_shard_read`` before the bytes are
        touched, then ``maybe_corrupt``), and ``verify_on_read`` re-hashes
        the bytes against the manifest, raising ``ShardCorruptError`` on a
        mismatch: a flipped bit mid-scan is a typed, retryable error, never
        a silently wrong top-k."""
        return self._read_shard_of(self._live(), i, tier)

    def _read_shard_of(self, g: _Generation, i: int, tier: str):
        _check_tier(tier)
        if not 0 <= i < len(g.shards):
            raise IndexError(f"shard {i} out of range (n={len(g.shards)})")
        inj = self._injector()
        if inj is not None:
            inj.on_shard_read(i, tier)
        s = g.shards[i]
        if tier == F32_TIER:
            vec = s.vectors if inj is None else inj.maybe_corrupt(s.vectors, i, tier)
            if self.verify_on_read:
                self._verify(g, i, F32_TIER, crc32_of(vec), "f32 rows", tier)
            return s if vec is s.vectors else s._replace(vectors=vec)
        self._require_int8(g)
        i8 = g.int8[i]
        codes = i8.q if inj is None else inj.maybe_corrupt(i8.q, i, tier)
        if self.verify_on_read:
            self._verify(g, i, INT8_TIER, crc32_of(codes), "int8 codes", tier)
            self._verify(g, i, INT8_META,
                         crc32_of_arrays(*(getattr(i8, f) for f in _INT8_META_FIELDS)),
                         "int8 per-row channels", tier)
        return Int8Partition(codes, i8.scales, i8.err, g.int8_qnorm[i], s.n_valid,
                             s.base_index)

    def delta_shards(self) -> list[PaddedDataset]:
        """The live generation's appended rows as fixed-geometry padded
        shards: the delta blocks themselves (tombstones in their norms, +inf
        past the rows filled), where the store's shards live. Every delta
        shard has one shape; base_index continues the positional space after
        the main rows."""
        return self._delta_shards_of(self._live())

    def _delta_shards_of(self, g: _Generation) -> list[PaddedDataset]:
        cap = self._delta_rows_cap
        return [PaddedDataset(block, norms, min(cap, g.n_delta - j * cap), g.n_main + j * cap)
                for j, (block, norms) in enumerate(g.delta)]

    def iter_shards(self, tier: str = F32_TIER) -> Iterator:
        """A fresh pass over the shards at `tier` (restartable: every call
        opens a new pass) that pins the generation it starts on, so a
        compaction swap mid-scan cannot pull shards out from under it.
        ``f32`` yields PaddedDataset over main + delta shards, ``int8`` the
        multi-array Int8Partition over the main ones (delta rows have no
        quantised form: the streamed int8 rescore merges them exactly).
        Every shard is read through :meth:`read_shard`."""
        _check_tier(tier)
        if tier == INT8_TIER:
            self._require_int8(self._live())

        def gen():
            with self.snapshot() as view:
                yield from view.iter_shards(tier)

        return gen()

    def shard_source(self, tier: str = F32_TIER) -> _ShardSource:
        """A restartable iterable over :meth:`iter_shards` at `tier`."""
        _check_tier(tier)
        return _ShardSource(self, tier)

    def __iter__(self) -> Iterator[PaddedDataset]:
        return self.iter_shards()

    def gather_rows(self, ids) -> torch.Tensor:
        """Rows of the main shards by position -> (len(ids), padded_dim) f32
        on the host (page-locked for a pinned store), or on the card where
        every main shard lives on that card (a store built from a tensor
        there): no round trip through host memory. The rescore of the
        streamed int8 executors reads only these candidate rows of the f32
        tier. Negative and out-of-range ids give zero rows (callers mask
        them by validity). The fault hook ``on_gather`` fires first; under
        ``verify_on_read`` every row read from a file is re-hashed against
        its per-row CRC (``ShardCorruptError``). A pure read, safe beside a
        scan's shard reads (the speculative gather runs it on a thread)."""
        return self._gather_rows_of(self._live(), ids)

    def _gather_rows_of(self, g: _Generation, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
        inj = self._injector()
        if inj is not None:
            inj.on_gather(int(ids.shape[0]))
        shards = g.shards
        rows_per = self.rows_per_shard
        devs = {p.vectors.device if isinstance(p.vectors, torch.Tensor) else None
                for p in shards}
        card = next(iter(devs)) if len(devs) == 1 else None
        if card is not None and card.type != "cuda":
            card = None
        # rows gathered from files for a card come back page-locked, as the
        # shards streamed from them are staged: the copy to the card is async
        pin = card is None and (self._pinned or (self.is_mmap and torch.cuda.is_available()))
        out = torch.empty((ids.shape[0], self.padded_dim), dtype=torch.float32,
                          pin_memory=pin, device=card)
        ok = (ids >= 0) & (ids < len(shards) * rows_per)
        out[(~ok).to(out.device)] = 0.0
        dest = torch.nonzero(ok).reshape(-1)
        sid, row = ids[dest] // rows_per, ids[dest] % rows_per
        for s in torch.unique(sid).tolist():
            sel = sid == s
            pos, rows, src = dest[sel], row[sel], shards[s].vectors
            a, b = int(pos[0]), int(pos[-1]) + 1
            contiguous = b - a == pos.numel()
            if isinstance(src, np.ndarray):
                # a mapped shard: only these rows are read
                got = out[a:b] if contiguous else torch.empty((pos.numel(), self.padded_dim))
                _take(src, rows.numpy(), got.numpy())
                if not contiguous:
                    out[pos] = got
            elif src.device.type == "cpu" and contiguous:
                # sorted ids (the rescore's are) put a shard's rows in one
                # run of the output: one pass, straight into it
                torch.index_select(src, 0, rows, out=out[a:b])
            else:
                out[pos.to(out.device)] = src[rows.to(src.device)].to(torch.float32).to(
                    out.device)
            crcs = g.rowcrc[s]
            if self.verify_on_read and crcs is not None:
                got_crc = _row_crcs(out[pos].numpy())
                bad = np.flatnonzero(got_crc != crcs[rows.numpy()])
                if bad.size:
                    r = int(rows[int(bad[0])])
                    raise ShardCorruptError(
                        f"per-row CRC mismatch on row {r} of f32 shard {s} (candidate "
                        "gather): bytes changed since the shard was written", s, F32_TIER)
        return out

    # ------------------------------------------------- pinning / generations
    def snapshot(self) -> StoreView:
        """Pin the live generation and return a read view of it: its shards,
        tiers and id tables cannot be collected until the view is released.
        Searches hold one for their whole run, so a concurrent compaction
        never invalidates what they read."""
        with self._lock:
            g = self._live()
            g.refs += 1
        return StoreView(self, g)

    def _unpin(self, g: _Generation) -> None:
        collect = False
        with self._lock:
            g.refs -= 1
            if g.obsolete and g.refs <= 0 and not g.collected:
                g.collected = collect = True
                if g in self._retired:
                    self._retired.remove(g)
        if collect:
            self._gc_generation(g)

    def _retire(self, g: _Generation) -> None:
        """Mark a superseded generation for collection: at once if unpinned,
        else at its last :meth:`_unpin`."""
        collect = False
        with self._lock:
            g.obsolete = True
            if g.refs <= 0 and not g.collected:
                g.collected = collect = True
            elif not g.collected and g not in self._retired:
                self._retired.append(g)
        if collect:
            self._gc_generation(g)

    def _gc_generation(self, g: _Generation) -> None:
        """Remove a dead generation's files (its tensors go with the last
        reference). Generation k > 0 owns its ``gen_NNNNNN/`` directory;
        generation 0 shares the store root, so only the files its manifest
        names (and its journal) go, never ``CURRENT`` or the live
        generation's directory. Removing a mapped file is safe: a mapping
        keeps its pages."""
        if self._directory is None or g.directory is None:
            return
        if os.path.abspath(g.directory) != os.path.abspath(self._directory):
            shutil.rmtree(g.directory, ignore_errors=True)
            return
        for m in g.manifest.shards:
            for fname in m.files.values():
                _try_remove(os.path.join(self._directory, fname))
        if g.manifest.row_ids_file:
            _try_remove(os.path.join(self._directory, g.manifest.row_ids_file))
        _try_remove(os.path.join(self._directory, JOURNAL_NAME))
        _try_remove(os.path.join(self._directory, MANIFEST_NAME))

    # ------------------------------------------------------------ compaction
    def compact(self) -> dict:
        """Fold the delta rows and tombstones into a new generation and
        switch readers to it atomically.

        The new generation is built whole first (for a store in files: its
        shards, norms, row CRCs, id table, the int8 tier if the old
        generation had one, its manifest, and a journal of the mutations
        that arrived during the build, all fsync'd in ``gen_NNNNNN/``); only
        then does ``CURRENT`` flip, one ``os.replace``. A crash before that
        leaves the old generation (the orphan directory is swept at the next
        open); a crash after it leaves the new one complete. Geometry is
        kept (rows_per_shard, padded_dim). The build runs without the store
        lock, and searches never take it: a search in flight keeps the
        generation it pinned. Returns stats (also in
        :meth:`compaction_status`)."""
        inj = self._injector()

        def crash(site: str) -> None:
            if inj is not None:
                inj.crash_point(site)

        with self._lock:
            if self._compact_state["running"]:
                raise RuntimeError("compaction already running")
            self._compact_state["running"] = True
            self._compact_state["error"] = None
        try:
            stats = self._compact_impl(crash)
            with self._lock:
                self._compact_state["compactions"] += 1
                self._compact_state["last"] = stats
            return stats
        except BaseException as e:
            with self._lock:
                self._compact_state["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            with self._lock:
                self._compact_state["running"] = False

    def _live_rows(self, g: _Generation, main_tomb: np.ndarray, n_delta: int,
                   delta_tomb: list[bool]) -> tuple[torch.Tensor, np.ndarray]:
        """The rows of `g` alive at the fold point, at true dim, in position
        order (main, then delta), where the store's shards live (a mapped
        shard's rows read into host RAM), and their external ids."""
        dim = self.dim
        rid = g.row_ids if g.row_ids is not None else np.arange(g.n_main, dtype=np.int64)
        parts, ids = [], []
        for s in g.shards:
            start, nv = s.base_index, s.n_valid
            alive = ~main_tomb[start: start + nv]
            if nv == 0 or not alive.any():
                continue
            if isinstance(s.vectors, np.ndarray):
                parts.append(torch.from_numpy(np.asarray(s.vectors[:nv][alive][:, :dim])))
            else:
                keep = torch.from_numpy(np.flatnonzero(alive)).to(s.vectors.device)
                parts.append(s.vectors[keep, :dim])
            ids.append(rid[start: start + nv][alive])
        cap = self._delta_rows_cap
        alive_j = np.flatnonzero(~np.asarray(delta_tomb[:n_delta], dtype=bool))
        for j, (block, _) in enumerate(g.delta):
            sel = alive_j[(alive_j >= j * cap) & (alive_j < (j + 1) * cap)] - j * cap
            if sel.size:
                parts.append(block[torch.from_numpy(sel).to(block.device), :dim])
        if alive_j.size:
            ids.append(np.asarray(g.delta_ids, dtype=np.int64)[alive_j])
        home = self._home if not self.is_mmap else torch.device("cpu")
        v = (torch.cat([p.to(home) for p in parts]) if parts
             else torch.zeros((0, dim), device=home))
        return v, (np.concatenate(ids) if ids else np.zeros(0, dtype=np.int64))

    def _compact_impl(self, crash) -> dict:
        t0 = time.monotonic()
        crash("compact.begin")
        # the fold point: what is before it goes into the new generation's
        # shards, what arrives after it drains into its journal
        with self._lock:
            g = self._live()
            snap_delta = g.n_delta
            snap_main_tomb = g.main_tomb.copy()
            snap_delta_tomb = list(g.delta_tomb[:snap_delta])
            snap_next_id = self._next_id
            want_int8 = g.int8 is not None
        dim, rows, padded_dim = self.dim, self.rows_per_shard, self.padded_dim
        rid_src = g.row_ids if g.row_ids is not None else np.arange(g.n_main, dtype=np.int64)
        v_live, ext_ids = self._live_rows(g, snap_main_tomb, snap_delta, snap_delta_tomb)
        n_live = int(v_live.shape[0])
        identity = bool(np.array_equal(ext_ids, np.arange(n_live)))
        new_num = g.number + 1

        # the new generation, built offline with the same geometry
        gen_name = gen_dir = None
        manifest = None
        if self._directory is not None:
            gen_name = GEN_DIR_FMT.format(new_num)
            gen_dir = os.path.join(self._directory, gen_name)
            if os.path.isdir(gen_dir):  # leftovers of a crashed compaction
                shutil.rmtree(gen_dir)
            os.makedirs(gen_dir)
            metas = _write_shards(v_live, rows, padded_dim, gen_dir)
            crash("compact.after_shards")
            row_ids_file = ""
            if not identity:
                row_ids_file = ROW_IDS_NAME
                _write_file(gen_dir, row_ids_file, lambda f: np.save(f, ext_ids))
            manifest = Manifest(dim=dim, padded_dim=padded_dim, rows_per_shard=rows,
                                n_valid=n_live, dtype=g.manifest.dtype, tiers=(F32_TIER,),
                                shards=tuple(metas), generation=new_num,
                                next_id=snap_next_id, row_ids_file=row_ids_file)
            shards, rowcrcs = _map_shards(gen_dir, manifest, verify=False)
        else:
            shards, rowcrcs = [], None
            for start in range(0, max(n_live, 1), rows):
                p = _pad_block(v_live[start: start + rows], rows, padded_dim, start)
                shards.append(p if self._home.type != "cpu" else p._replace(
                    vectors=_host(p.vectors, self._pinned), norms=_host(p.norms, self._pinned)))
        new_gen = _Generation(new_num, shards, manifest=manifest, directory=gen_dir,
                              rowcrc=rowcrcs, row_ids=None if identity else ext_ids)
        if want_int8:
            # quantised again, so streamed scans return to 1 B/element over
            # the folded rows (delta rows had no int8 form)
            self._quantize_generation(new_gen)
        elif gen_dir is not None:
            manifest.save(gen_dir)
        crash("compact.after_manifest")
        if self._home.type == "cuda":
            # the build's device work (on this thread's stream) is complete
            # before any reader of the new generation can see it
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._home))
            done.synchronize()

        # drain the mutations that arrived during the build, swap the
        # pointer, retire the old generation
        with self._lock:
            if g.int8 is not None and new_gen.int8 is None:
                self._quantize_generation(new_gen)  # ensure_tier raced the build
            new_journal = (Journal(os.path.join(gen_dir, JOURNAL_NAME), self._injector)
                           if gen_dir is not None else None)
            drained = 0
            cap = self._delta_rows_cap
            for j in range(snap_delta, g.n_delta):
                row, gid = g.delta[j // cap][0][j % cap: j % cap + 1], g.delta_ids[j]
                if new_journal is not None:
                    new_journal.append(encode_upsert(gid, row[:, :dim].cpu().numpy()))
                self._apply_upsert_gen(new_gen, row, row_norms_sq(row),
                                       np.asarray([gid], dtype=np.int64))
                drained += 1
            dead_ids = [int(rid_src[p]) for p in np.flatnonzero(g.main_tomb & ~snap_main_tomb)]
            dead_ids += [g.delta_ids[j] for j in range(snap_delta)
                         if g.delta_tomb[j] and not snap_delta_tomb[j]]
            dead_ids += [g.delta_ids[j] for j in range(snap_delta, g.n_delta)
                         if g.delta_tomb[j]]
            if dead_ids:
                if new_journal is not None:
                    new_journal.append(encode_delete(dead_ids))
                lut = self._lut_of(new_gen)
                self._tombstone_gen(new_gen, [int(lut[gid]) for gid in dead_ids])
                drained += 1
            crash("compact.before_current")
            if self._directory is not None:
                write_current(self._directory, gen_name)
            crash("compact.after_current")
            old_journal = self._journal
            self._journal = new_journal
            self._gen = new_gen  # THE swap: one reference assignment
            self._mutations += 1  # engines rebuild their device views
        if old_journal is not None:
            old_journal.close()
        reclaimed = (g.n_main + snap_delta) - n_live
        self._retire(g)
        crash("compact.after_gc")
        return {"generation": new_num, "n_live": n_live, "delta_folded": snap_delta,
                "rows_reclaimed": int(reclaimed), "drained_during_build": drained,
                "duration_s": round(time.monotonic() - t0, 6)}

    def compact_async(self) -> threading.Thread | None:
        """Start :meth:`compact` on a daemon thread (the serving trigger).
        Returns the thread, or None if a compaction is already running.
        Errors land in :meth:`compaction_status` ``["error"]``."""
        with self._lock:
            if self._compact_state["running"]:
                return None

        def run():
            try:
                self.compact()
            except BaseException:
                pass  # a lost race to another trigger, or recorded by compact()

        t = threading.Thread(target=run, name="store-compactor", daemon=True)
        t.start()
        return t

    def _maybe_auto_compact_locked(self) -> None:
        if self.auto_compact_pending is None or self._compact_state["running"]:
            return
        g = self._gen
        if g.n_delta + g.dead_main + g.dead_delta >= self.auto_compact_pending:
            self.compact_async()

    def compaction_status(self) -> dict:
        """Live compaction and generation state."""
        with self._lock:
            g = self._gen
            return {
                "running": bool(self._compact_state["running"]),
                "compactions": int(self._compact_state["compactions"]),
                "generation": g.number,
                "pending_delta": g.n_delta,
                "tombstones": int(g.dead_main + g.dead_delta),
                "auto_compact_pending": self.auto_compact_pending,
                "retired_pinned": len(self._retired),
                "last": self._compact_state["last"],
                "error": self._compact_state["error"],
            }


def _host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    """`t` in host memory, page-locked when `pinned`."""
    if not pinned:
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out
