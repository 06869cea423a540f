"""DatasetStore — the dataset layer: equal padded shards in host RAM or in
files.

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
  file; a ``CURRENT`` generation pointer and an empty journal. The f32
  shards (and the int8 codes) are read-only ``np.memmap`` arrays: the
  store never holds their bytes in RAM, and it is never pinned. The double
  buffer copies each mapped shard through page-locked banks of its own
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

Faults: :meth:`read_shard` and :meth:`gather_rows` fire the hooks of a
``repro_torch.faults.FaultInjector`` (the store's own, else the
process-wide one) and, with ``verify_on_read``, re-check the manifest's
CRCs, raising ``ShardCorruptError``.

The write side waits for its slice of the port: ``upsert`` and ``delete``
raise ``NotImplementedError``, :meth:`delta_shards` is empty, and
:meth:`open` refuses, with ``NotImplementedError``, a store whose journal
holds mutation records or whose generation remaps row ids (a compacted
one). It never sweeps what a crashed compaction left behind.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from repro_torch import faults
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
from repro_torch.store.manifest import (
    Manifest,
    ShardMeta,
    crc32_of,
    crc32_of_arrays,
    read_current,
    write_current,
)

F32_TIER = "f32"
INT8_TIER = "int8"

#: manifest files/checksums key of the per-row CRC sidecar of the f32 tier
#: (uint32 per padded row): what lets gather_rows verify candidate rows
#: without re-hashing the whole shard
ROWCRC_KEY = "f32_rowcrc"
#: manifest files/checksums key of the int8 tier's per-row channels (npz)
INT8_META = "int8_meta"
#: npz member order of the int8 meta file, and the order its checksum
#: (crc32_of_arrays) runs over the arrays
_INT8_META_FIELDS = ("scales", "err", "norms_sq", "qnorm_sq")

#: the generation's write-ahead journal: CRC-framed records, each a magic,
#: a payload length and the payload's CRC32 (little-endian), then the payload
JOURNAL_NAME = "journal.wal"
_JOURNAL_MAGIC = b"KJNL"
_JOURNAL_HEADER = struct.Struct("<4sII")


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


def _journal_records(path: str) -> int:
    """Number of whole, CRC-consistent records at the head of a journal (0
    when there is none); a torn tail after them is not a record."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return 0
    n = off = 0
    while off + _JOURNAL_HEADER.size <= len(blob):
        magic, length, crc = _JOURNAL_HEADER.unpack_from(blob, off)
        end = off + _JOURNAL_HEADER.size + length
        if magic != _JOURNAL_MAGIC or end > len(blob):
            break
        if zlib.crc32(blob[off + _JOURNAL_HEADER.size: end]) & 0xFFFFFFFF != crc:
            break
        n, off = n + 1, end
    return n


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
    :meth:`from_array`, reopen a store in files with :meth:`open`."""

    def __init__(self, shards: list[PaddedDataset], pinned: bool = False,
                 int8: list[Int8Shard] | None = None):
        """Equal padded shards (norms +inf past each shard's n_valid) and,
        optionally, their int8 tier, one QuantizedDataset a shard."""
        if not shards:
            raise ValueError("a store needs at least one shard")
        self._shards = list(shards)
        self._n_valid = sum(s.n_valid for s in self._shards)
        self._n_shards = len(self._shards)
        self._rows_per_shard, self._padded_dim = (int(v) for v in shards[0].vectors.shape)
        self._pinned = bool(pinned)
        self._int8: list[Int8Shard] | None = None
        self._int8_qnorm: list[torch.Tensor] | None = None  # validity folded in
        if int8 is not None:
            self._set_int8(list(int8))
        # a store in files (set by open): its manifest, root and generation
        # directories, and the per-row CRC sidecar of each shard
        self._manifest: Manifest | None = None
        self._directory: str | None = None
        self._gen_dir: str | None = None
        self._rowcrc: list[np.ndarray | None] = [None] * len(self._shards)
        self._closed = False
        #: per-store fault injector (repro_torch.faults.FaultInjector); when
        #: None, the process-wide one (faults.install) applies
        self.fault_injector = None
        #: re-check the manifest's CRCs on every read_shard and the per-row
        #: CRCs on every gather_rows (an extra pass over the bytes read)
        self.verify_on_read = False

    def _set_int8(self, int8: list[Int8Shard]) -> None:
        # validity (padding) folds onto the exact quantised norm: the one
        # channel the streamed scan step masks on
        self._int8 = int8
        folded = (torch.where(torch.isfinite(i8.norms_sq), i8.qnorm_sq, torch.inf)
                  for i8 in int8)
        self._int8_qnorm = [_host(t, True) if self._pinned else t for t in folded]

    @classmethod
    def from_array(cls, vectors, rows_per_shard: int | None = None, row_mult: int = LANE,
                   dim_mult: int = LANE, pin_memory: bool = False,
                   directory: str | None = None) -> "DatasetStore":
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
            return cls._write(v, rows, directory, row_mult, dim_mult)
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
        return cls(shards, pinned=pin_memory)

    # ------------------------------------------------------------ on disk
    @classmethod
    def _write(cls, v: torch.Tensor, rows: int, directory: str, row_mult: int,
               dim_mult: int) -> "DatasetStore":
        """Write generation 0 of a store: per shard the raw f32 rows, their
        norms and per-row CRCs, each fsync'd before the manifest that names
        them; then ``manifest.json``, ``CURRENT`` -> "." and an empty
        journal. Returns the store reopened from the files."""
        os.makedirs(directory, exist_ok=True)
        n, d = int(v.shape[0]), int(v.shape[1])
        metas = []
        for i, start in enumerate(range(0, max(n, 1), rows)):
            nv = min(rows, max(0, n - start))
            p = make_padded(pad_rows(v[start: start + rows], rows), base_index=start,
                            row_mult=row_mult, dim_mult=dim_mult)
            p.norms[nv:] = torch.inf
            _check_norms(p.norms, nv)
            block, norms = p.vectors.cpu().numpy(), p.norms.cpu().numpy()
            rowcrc = _row_crcs(block)
            files = {F32_TIER: _f32_name(i), "f32_norms": _norms_name(i),
                     ROWCRC_KEY: _rowcrc_name(i)}
            _write_file(directory, files[F32_TIER], block.tofile)
            _write_file(directory, files["f32_norms"], lambda f: np.save(f, norms))
            _write_file(directory, files[ROWCRC_KEY], lambda f: np.save(f, rowcrc))
            metas.append(ShardMeta(shard_id=i, row_start=start, n_valid=nv,
                                   padded_rows=int(block.shape[0]),
                                   padded_dim=int(block.shape[1]), files=files,
                                   checksums={F32_TIER: crc32_of(block),
                                              ROWCRC_KEY: crc32_of(rowcrc)}))
        Manifest(dim=d, padded_dim=metas[0].padded_dim, rows_per_shard=metas[0].padded_rows,
                 n_valid=n, tiers=(F32_TIER,), shards=tuple(metas), generation=0,
                 next_id=n).save(directory)
        write_current(directory, ".")
        _write_file(directory, JOURNAL_NAME, lambda f: None)
        return cls.open(directory)

    @classmethod
    def open(cls, directory: str, verify: bool = False,
             verify_on_read: bool = False) -> "DatasetStore":
        """Reopen a store written in files by either package; its shards
        stay on disk (read-only ``np.memmap``).

        Resolves the live generation through ``CURRENT`` ("." or a
        ``gen_NNNNNN/`` directory; none means the root), validates its
        manifest (``ManifestError`` names the field), then maps every f32
        shard (and the int8 codes when the manifest lists the tier).
        ``verify=True`` recomputes the CRC of every file and raises
        ``ValueError`` on a mismatch (it reads every shard once);
        ``verify_on_read=True`` re-checks them on every read instead.

        A generation whose journal holds mutation records, or whose rows
        carry remapped ids, needs the store's write side to be read right:
        ``NotImplementedError``, before any shard is read.
        """
        gen_name = read_current(directory) or "."
        gen_dir = directory if gen_name == "." else os.path.join(directory, gen_name)
        manifest = Manifest.load(gen_dir).validate()
        if manifest.row_ids_file:
            ids = np.load(os.path.join(gen_dir, manifest.row_ids_file))
            if not np.array_equal(ids, np.arange(ids.shape[0])):
                raise NotImplementedError(
                    f"generation {gen_name!r} remaps row ids ({manifest.row_ids_file}): "
                    "reading a compacted generation is the store's write side "
                    "(ROADMAP A7b)")
        records = _journal_records(os.path.join(gen_dir, JOURNAL_NAME))
        if records:
            raise NotImplementedError(
                f"the journal of generation {gen_name!r} holds {records} mutation "
                "record(s): replaying them is the store's write side (ROADMAP A7b)")
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
        int8 = None
        if INT8_TIER in manifest.tiers:
            int8 = [cls._load_int8_shard(gen_dir, m, verify) for m in manifest.shards]
        store = cls(shards, int8=int8)
        store._manifest, store._directory, store._gen_dir = manifest, directory, gen_dir
        store._rowcrc = rowcrcs
        store.verify_on_read = bool(verify_on_read)
        return store

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

    def _write_int8(self, i: int, qd: QuantizedDataset) -> tuple[Int8Shard, ShardMeta]:
        """Persist one shard's int8 tier (host tensors): the codes as a raw
        file, the per-row channels as an npz, both CRC'd into the shard's
        manifest entry; the codes come back as a read-only mapping."""
        m = self._manifest.shards[i]
        codes_name, meta_name = _int8_codes_name(m.shard_id), _int8_meta_name(m.shard_id)
        codes = qd.q.numpy()
        channels = {f: getattr(qd, f).numpy() for f in _INT8_META_FIELDS}
        _write_file(self._gen_dir, codes_name, codes.tofile)
        _write_file(self._gen_dir, meta_name, lambda f: np.savez(f, **channels))
        meta = dataclasses.replace(
            m, files={**m.files, INT8_TIER: codes_name, INT8_META: meta_name},
            checksums={**m.checksums, INT8_TIER: crc32_of(codes),
                       INT8_META: crc32_of_arrays(*channels.values())})
        mapped = np.memmap(os.path.join(self._gen_dir, codes_name), dtype=np.int8, mode="r",
                           shape=codes.shape)
        return qd._replace(q=mapped), meta

    # ------------------------------------------------------------ geometry
    @property
    def padded_dim(self) -> int:
        return self._padded_dim

    @property
    def rows_per_shard(self) -> int:
        return self._rows_per_shard

    @property
    def n_shards(self) -> int:
        return self._n_shards

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
        """Shards are read-only mappings of files (:meth:`open`)."""
        return self._directory is not None

    @property
    def directory(self) -> str | None:
        """The store's root directory (None for a store in host RAM)."""
        return self._directory

    @property
    def manifest(self) -> Manifest | None:
        """The live generation's manifest (None for a store in host RAM)."""
        return self._manifest

    @property
    def tiers(self) -> tuple:
        """The tiers materialised: ``("f32",)`` or ``("f32", "int8")``."""
        return (F32_TIER,) if self._int8 is None else (F32_TIER, INT8_TIER)

    @property
    def is_pinned(self) -> bool:
        """Every shard (and int8 shard) is in page-locked host memory."""
        return self._pinned

    @property
    def mutation_count(self) -> int:
        """Bumped on every mutation; this slice has none."""
        return 0

    def close(self) -> None:
        """Drop the store's references to its shards (for a store in files:
        its mappings, which the OS unmaps once no array read from them is
        left). A closed store cannot be read."""
        self._closed = True
        self._shards, self._int8, self._int8_qnorm = [], None, None

    def _live(self) -> list[PaddedDataset]:
        if self._closed:
            raise ValueError("the store is closed")
        return self._shards

    def pin(self) -> "DatasetStore":
        """Move every host shard into page-locked memory, once (idempotent).
        Raises if a shard lies on a device (only host shards stream) or in a
        file (a mapping is never pinned)."""
        if self._pinned:
            return self
        if self.is_mmap:
            raise ValueError("a store in files is never pinned: the double buffer stages "
                             "its mapped shards through page-locked banks of its own")
        if any(s.vectors.device.type != "cpu" for s in self._live()):
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
        shard lies; a mapped shard is read into host RAM first), and kept
        beside them; padded rows get +inf norms so the masked quantised scan
        can never admit them. A store in files writes the tier to its
        directory and maps the codes back."""
        _check_tier(tier)
        if tier == F32_TIER or self._int8 is not None:
            return
        int8, metas = [], []
        for i, s in enumerate(self._live()):
            vec = _tensor(s.vectors)
            home = vec.device
            qd = quantize_dataset(vec if device is None else vec.to(device))
            qd.norms_sq[s.n_valid:] = torch.inf
            if self.is_mmap:
                i8, meta = self._write_int8(i, QuantizedDataset(*(t.cpu() for t in qd)))
                int8.append(i8)
                metas.append(meta)
            else:
                int8.append(QuantizedDataset(*(_host(t, self._pinned) if home.type == "cpu"
                                               else t.to(home) for t in qd)))
        if self.is_mmap:
            self._manifest = dataclasses.replace(
                self._manifest, tiers=tuple(dict.fromkeys((*self._manifest.tiers, INT8_TIER))),
                shards=tuple(metas))
            self._manifest.save(self._gen_dir)
        self._set_int8(int8)

    def _require_int8(self) -> None:
        if self._int8 is None:
            raise RuntimeError("int8 tier not materialized; call ensure_tier('int8')")

    def int8_resident(self) -> Int8Shard:
        """The int8 tier as one QuantizedDataset over all shards (the
        store's own tensors for a one-shard store in host memory; mapped
        codes are read once into host RAM)."""
        self._live()
        self._require_int8()
        if len(self._int8) == 1 and not self.is_mmap:
            return self._int8[0]
        return QuantizedDataset(*(_cat(parts) for parts in zip(*self._int8)))

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
        a one-shard store in host memory; a concatenation otherwise, which
        reads a store in files once)."""
        shards = self._live()
        if len(shards) == 1:
            s = shards[0]
            return s._replace(vectors=_tensor(s.vectors)) if self.is_mmap else s
        return PaddedDataset(_cat([s.vectors for s in shards]),
                             torch.cat([s.norms for s in shards]), self._n_valid, 0)

    # ------------------------------------------------------------- read side
    def _injector(self):
        return self.fault_injector if self.fault_injector is not None else faults.active()

    def _verify(self, i: int, key: str, got: int, what: str, tier: str) -> None:
        want = (self._manifest.shards[i].checksums.get(key)
                if self._manifest is not None else None)
        if want is not None and got != want:
            raise ShardCorruptError(
                f"CRC mismatch on {what} of shard {i}: bytes changed since the manifest "
                "was written", i, tier)

    def read_shard(self, i: int, tier: str = F32_TIER):
        """One main shard at `tier`, the unit of streamed resilience: a
        PaddedDataset (f32) or an Int8Partition (int8, validity folded onto
        ``qnorm``). The store's own arrays (host tensors, or read-only
        mappings for a store in files), never copies, unless the fault
        injector corrupts one.

        The fault hooks fire here (``on_shard_read`` before the bytes are
        touched, then ``maybe_corrupt``), and ``verify_on_read`` re-hashes
        the bytes against the manifest, raising ``ShardCorruptError`` on a
        mismatch: a flipped bit mid-scan is a typed, retryable error, never
        a silently wrong top-k."""
        _check_tier(tier)
        shards = self._live()
        if not 0 <= i < len(shards):
            raise IndexError(f"shard {i} out of range (n={len(shards)})")
        inj = self._injector()
        if inj is not None:
            inj.on_shard_read(i, tier)
        s = shards[i]
        if tier == F32_TIER:
            vec = s.vectors if inj is None else inj.maybe_corrupt(s.vectors, i, tier)
            if self.verify_on_read:
                self._verify(i, F32_TIER, crc32_of(vec), "f32 rows", tier)
            return s if vec is s.vectors else s._replace(vectors=vec)
        self._require_int8()
        i8 = self._int8[i]
        codes = i8.q if inj is None else inj.maybe_corrupt(i8.q, i, tier)
        if self.verify_on_read:
            self._verify(i, INT8_TIER, crc32_of(codes), "int8 codes", tier)
            self._verify(i, INT8_META,
                         crc32_of_arrays(*(getattr(i8, f) for f in _INT8_META_FIELDS)),
                         "int8 per-row channels", tier)
        return Int8Partition(codes, i8.scales, i8.err, self._int8_qnorm[i], s.n_valid,
                             s.base_index)

    def delta_shards(self) -> list[PaddedDataset]:
        """Appended rows as padded shards: none until the store's write side
        brings mutations."""
        return []

    def iter_shards(self, tier: str = F32_TIER) -> Iterator:
        """A fresh pass over the shards at `tier` (restartable: every call
        opens a new pass). ``f32`` yields PaddedDataset over main + delta
        shards, ``int8`` the multi-array Int8Partition over the main ones.
        Every shard is read through :meth:`read_shard`."""
        _check_tier(tier)
        if tier == INT8_TIER:
            self._require_int8()

        def gen():
            for i in range(self.n_shards):
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
        (callers mask them by validity). The fault hook ``on_gather`` fires
        first; under ``verify_on_read`` every row read from a file is
        re-hashed against its per-row CRC (``ShardCorruptError``). A pure
        read, safe beside a scan's shard reads (the speculative gather runs
        it on a thread)."""
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
        inj = self._injector()
        if inj is not None:
            inj.on_gather(int(ids.shape[0]))
        shards = self._live()
        rows_per = self.rows_per_shard
        # rows gathered from files for a card come back page-locked, as the
        # shards streamed from them are staged: the copy to the card is async
        pin = self._pinned or (self.is_mmap and torch.cuda.is_available())
        out = torch.empty((ids.shape[0], self.padded_dim), dtype=torch.float32,
                          pin_memory=pin)
        ok = (ids >= 0) & (ids < len(shards) * rows_per)
        out[~ok] = 0.0
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
                out[pos] = src[rows.to(src.device)].to(torch.float32).cpu()
            crcs = self._rowcrc[s]
            if self.verify_on_read and crcs is not None:
                got_crc = _row_crcs(out[pos].numpy())
                bad = np.flatnonzero(got_crc != crcs[rows.numpy()])
                if bad.size:
                    r = int(rows[int(bad[0])])
                    raise ShardCorruptError(
                        f"per-row CRC mismatch on row {r} of f32 shard {s} (candidate "
                        "gather): bytes changed since the shard was written", s, F32_TIER)
        return out

    # --------------------------------------------------- later slices
    def upsert(self, vectors):
        raise NotImplementedError("store mutations are the store's write side (ROADMAP A7b)")

    def delete(self, ids):
        raise NotImplementedError("store mutations are the store's write side (ROADMAP A7b)")


def _host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    """`t` in host memory, page-locked when `pinned`."""
    if not pinned:
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out
