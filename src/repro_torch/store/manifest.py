"""Shard manifest — the durable description of a tiered dataset (the
port's own copy of the reference's format, byte for byte).

A :class:`Manifest` is what survives on disk next to the shard files: the
padding geometry every shard shares (one shape => one step for every
shard), the global row ranges, the dtype tiers materialised per shard, and
a CRC32 per file so a reopened store can prove it is scanning the bytes it
wrote.

The manifest is plain JSON (``manifest.json``). Its fields, their order,
the JSON layout and the CRCs are the reference package's exactly, so a
store written by either package opens in the other.

Generations & the ``CURRENT`` pointer
    A compacted store is a sequence of immutable *generations*, each a
    directory holding its own ``manifest.json`` + shard files (generation
    0 lives at the store root; generation k>0 in ``gen_<k>/``). A single
    root-level ``CURRENT`` file names the live generation's directory,
    updated write-tmp → fsync → ``os.replace`` → fsync(dir): readers either
    see the old pointer or the new one, never a torn file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1

#: Root-level pointer file naming the live generation's directory
#: ("." = the store root itself, i.e. generation 0's legacy layout).
CURRENT_NAME = "CURRENT"


class ManifestError(ValueError):
    """A structurally invalid manifest, named by the offending field.

    Raised by :meth:`Manifest.validate` (and therefore by
    ``DatasetStore.open``) instead of letting a malformed shard table fail
    deep inside a scan. ``field`` names the manifest field that failed.
    """

    def __init__(self, field: str, message: str):
        super().__init__(f"invalid manifest field {field!r}: {message}")
        self.field = field

#: dtype tiers a shard may materialize. "f32" is the exact base tier;
#: "int8" is the 1 B/element scan tier with certified exact rescore
#: (repro_torch.core.quantized).
TIERS = ("f32", "int8")


def crc32_of(arr: np.ndarray) -> int:
    """Checksum of an array's raw bytes (reads the whole buffer)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def crc32_of_arrays(*arrays: np.ndarray) -> int:
    """Running CRC32 over several arrays' raw bytes, in argument order.

    Checksums the *contents* rather than the container file, so formats
    whose byte layout is not reproducible (npz zip members carry
    timestamps) still verify deterministically — used for the int8 shard
    meta files (scales/err/norms/qnorm)."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ShardMeta:
    """One shard's row range, geometry, and backing files.

    ``files``/``checksums`` are empty for purely in-memory stores; for
    mmap-backed stores they map tier names ("f32", "f32_norms", "int8",
    "int8_meta") to filenames relative to the store directory.
    """

    shard_id: int
    row_start: int  # global index of row 0 of this shard
    n_valid: int  # true rows (the rest of padded_rows is alignment padding)
    padded_rows: int
    padded_dim: int
    files: dict = dataclasses.field(default_factory=dict)
    checksums: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMeta":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Everything needed to reopen a store: geometry, tiers, shard table."""

    dim: int  # true feature dim
    padded_dim: int  # lane-aligned feature dim all shards share
    rows_per_shard: int  # padded rows per shard (identical for all shards)
    n_valid: int  # total true rows at build time (upserts live past this)
    dtype: str = "float32"
    tiers: tuple = ("f32",)
    shards: tuple = ()
    version: int = MANIFEST_VERSION
    #: Compaction generation this manifest describes (0 = as-built).
    generation: int = 0
    #: External-id allocation floor when this generation was written; -1
    #: means a pre-generation manifest (treat as n_valid). The store's live
    #: counter advances past this as journal records replay.
    next_id: int = -1
    #: Per-row external-id table file (int64, n_valid entries) relative to
    #: the generation directory; "" = identity (row position == id), which
    #: holds for every generation-0 store.
    row_ids_file: str = ""

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def padded_rows_total(self) -> int:
        return self.n_shards * self.rows_per_shard

    def validate(self) -> "Manifest":
        """Structural validation; raises :class:`ManifestError` naming the
        offending field. Checks the invariants every reader assumes:
        positive geometry, known tiers, a duplicate-free shard table whose
        row ranges tile ``[0, n_shards * rows_per_shard)`` contiguously
        (no overlaps, no gaps), sequential fill (every shard before the
        last is full), and per-shard geometry equal to the store's —
        the one-padded-shape invariant every streamed step relies on."""
        if self.dim < 1:
            raise ManifestError("dim", f"must be >= 1, got {self.dim}")
        if self.padded_dim < self.dim:
            raise ManifestError(
                "padded_dim", f"must be >= dim={self.dim}, got {self.padded_dim}")
        if self.rows_per_shard < 1:
            raise ManifestError(
                "rows_per_shard", f"must be >= 1, got {self.rows_per_shard}")
        if self.n_valid < 0:
            raise ManifestError("n_valid", f"must be >= 0, got {self.n_valid}")
        if self.generation < 0:
            raise ManifestError(
                "generation", f"must be >= 0, got {self.generation}")
        if not self.tiers or "f32" not in self.tiers:
            raise ManifestError(
                "tiers", f"must include the 'f32' base tier, got {self.tiers!r}")
        for t in self.tiers:
            if t not in TIERS:
                raise ManifestError(
                    "tiers", f"unknown tier {t!r}; known: {TIERS}")
        if not self.shards:
            raise ManifestError("shards", "empty shard table")
        if self.n_valid > self.n_shards * self.rows_per_shard:
            raise ManifestError(
                "n_valid",
                f"{self.n_valid} rows cannot fit {self.n_shards} shards of "
                f"{self.rows_per_shard} rows")
        seen_ids = [s.shard_id for s in self.shards]
        if len(set(seen_ids)) != len(seen_ids):
            dup = sorted(i for i in set(seen_ids) if seen_ids.count(i) > 1)
            raise ManifestError(
                "shards", f"duplicate shard_id(s) {dup} in shard table")
        has_files = any(s.files for s in self.shards)
        for i, s in enumerate(self.shards):
            where = f"shards[{i}].{{}}"
            if s.shard_id != i:
                raise ManifestError(
                    where.format("shard_id"),
                    f"expected {i} (table must be ordered 0..n-1), "
                    f"got {s.shard_id}")
            if s.row_start != i * self.rows_per_shard:
                raise ManifestError(
                    where.format("row_start"),
                    f"expected {i * self.rows_per_shard} (shard row ranges "
                    f"must tile contiguously, no overlaps or gaps), "
                    f"got {s.row_start}")
            if s.padded_rows != self.rows_per_shard:
                raise ManifestError(
                    where.format("padded_rows"),
                    f"every shard must share the store geometry "
                    f"rows_per_shard={self.rows_per_shard}, got {s.padded_rows}")
            if s.padded_dim != self.padded_dim:
                raise ManifestError(
                    where.format("padded_dim"),
                    f"every shard must share the store geometry "
                    f"padded_dim={self.padded_dim}, got {s.padded_dim}")
            want_nv = min(self.rows_per_shard,
                          max(0, self.n_valid - s.row_start))
            if s.n_valid != want_nv:
                raise ManifestError(
                    where.format("n_valid"),
                    f"expected {want_nv} (shards fill sequentially to "
                    f"n_valid={self.n_valid}), got {s.n_valid}")
            if has_files:
                for key in ("f32", "f32_norms"):
                    if key not in s.files:
                        raise ManifestError(
                            where.format("files"),
                            f"file-backed shard table is missing the "
                            f"{key!r} file entry")
                if "int8" in self.tiers and "int8" not in s.files:
                    raise ManifestError(
                        where.format("files"),
                        "manifest lists the int8 tier but the shard has "
                        "no 'int8' file entry")
        return self

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["tiers"] = list(self.tiers)
        d["shards"] = [s.to_dict() if isinstance(s, ShardMeta) else s
                       for s in self.shards]
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        d = json.loads(text)
        if d.get("version", 0) > MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {d['version']} is newer than supported "
                f"({MANIFEST_VERSION})"
            )
        d["tiers"] = tuple(d.get("tiers", ("f32",)))
        d["shards"] = tuple(ShardMeta.from_dict(s) for s in d.get("shards", ()))
        return cls(**d)

    def save(self, directory: str) -> str:
        path = os.path.join(directory, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
            f.flush()
            os.fsync(f.fileno())  # bytes durable BEFORE the name appears
        os.replace(tmp, path)  # atomic: readers never see a torn manifest
        _fsync_dir(directory)  # the rename itself durable before callers ack
        return path

    @classmethod
    def load(cls, directory: str) -> "Manifest":
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            return cls.from_json(f.read())


def _fsync_dir(directory: str) -> None:
    """Make a directory entry change (rename/create) durable. Best-effort
    on platforms whose directory fds reject fsync (e.g. Windows)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_current(directory: str) -> str | None:
    """Read the ``CURRENT`` generation pointer; None = legacy root layout
    (a store written before generations existed — generation 0 at root)."""
    try:
        with open(os.path.join(directory, CURRENT_NAME)) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    return name or None


def write_current(directory: str, gen_name: str) -> None:
    """Atomically point ``CURRENT`` at ``gen_name`` (the generation swap).

    Protocol: write tmp → fsync(tmp) → ``os.replace`` → fsync(directory).
    A crash at any boundary leaves either the old pointer or the new one —
    never a torn file — so reopen always finds a complete generation.
    """
    path = os.path.join(directory, CURRENT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(gen_name + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)
