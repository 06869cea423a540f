"""Write-ahead journal — crash-durable upsert/delete for DatasetStore.

The port's own copy of the reference's journal (``repro/store/journal.py``):
the same framing and the same JSON, byte for byte, so a journal written by
either package replays in the other.

Delta rows and tombstones are in-memory state reconstructed at open time;
what makes a mutation *durable* is its journal record. The protocol per
mutation (``DatasetStore.upsert`` / ``delete`` on a directory-backed
store) is strictly ordered:

1. frame the record (magic + length + CRC32 + payload) and append it;
2. flush + ``fsync`` the journal file;
3. apply the mutation to the in-memory generation;
4. return to the caller — the acknowledgement.

A crash before step 2 completes leaves at most a torn tail (a prefix of
one record's bytes), which replay discards — the mutation was never
acknowledged, so "before" is a correct recovered state. A crash after
step 2 replays the record on reopen — "after". There is no third state:
records are applied in append order and each is atomic under its CRC.

One journal file (``journal.wal``) lives inside each generation
directory and logs only mutations arrived *since that generation was
written*; compaction folds the old journal's effects into the new
generation's shards and starts the next journal with the still-pending
tail (see ``DatasetStore.compact``).

Record framing (little-endian):

    magic   4 bytes  b"KJNL"
    length  uint32   payload byte count
    crc32   uint32   zlib.crc32 of the payload bytes
    payload JSON (utf-8):
        {"op": "upsert", "id0": <first external id>, "n": <rows>,
         "dim": <true dim>, "data": <base64 raw f32 rows, C order>}
        {"op": "delete", "ids": [<external ids>]}

Crash points (repro_torch.faults): ``journal.append.begin`` /
``journal.append.torn`` / ``journal.append.after_write`` /
``journal.append.after_fsync`` fire in that order inside :meth:`append`
— the kill-and-reopen matrix proves each recovers to before-or-after.
"""
from __future__ import annotations

import base64
import json
import os
import struct
import zlib

import numpy as np

JOURNAL_NAME = "journal.wal"

_MAGIC = b"KJNL"
_HEADER = struct.Struct("<4sII")  # magic, payload length, payload crc32


def encode_upsert(id0: int, vectors: np.ndarray) -> dict:
    """Journal payload for an upsert of raw (n, dim) f32 rows assigned the
    contiguous external ids [id0, id0 + n)."""
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    return {
        "op": "upsert",
        "id0": int(id0),
        "n": int(v.shape[0]),
        "dim": int(v.shape[1]),
        "data": base64.b64encode(v.tobytes()).decode("ascii"),
    }


def encode_delete(ids) -> dict:
    """Journal payload for a delete of external ids."""
    return {"op": "delete", "ids": [int(g) for g in ids]}


def decode_upsert(rec: dict) -> tuple[int, np.ndarray]:
    """(first external id, (n, dim) f32 rows) of an upsert record."""
    raw = base64.b64decode(rec["data"])
    v = np.frombuffer(raw, dtype=np.float32).reshape(rec["n"], rec["dim"])
    return int(rec["id0"]), v


class Journal:
    """Append-only CRC-framed mutation log for one store generation.

    ``append`` is the durability point of every mutation; ``replay`` is
    the recovery point of every reopen. The file handle is opened lazily
    in append mode and kept open (one fd per store, not per mutation).
    """

    def __init__(self, path: str, injector_fn=None):
        self.path = path
        #: zero-arg callable returning the active FaultInjector (or None);
        #: resolved per append so process-wide `installed` scopes apply.
        self._injector_fn = injector_fn or (lambda: None)
        self._f = None

    # ----------------------------------------------------------- write side
    def _file(self):
        if self._f is None:
            # buffering=0: bytes reach the OS on write(), so the only
            # window a crash can tear is the kernel/media one fsync closes
            self._f = open(self.path, "ab", buffering=0)
        return self._f

    def append(self, record: dict) -> None:
        """Durably log one mutation record (write → flush → fsync).

        Returns only once the record is on stable storage — the caller
        applies the mutation in memory *after* this returns, so an
        acknowledged mutation can never be lost and an unacknowledged one
        is at worst a torn tail replay discards.
        """
        payload = json.dumps(record, separators=(",", ":")).encode("utf-8")
        frame = _HEADER.pack(_MAGIC, len(payload),
                             zlib.crc32(payload) & 0xFFFFFFFF) + payload
        inj = self._injector_fn()
        f = self._file()
        if inj is not None:
            inj.crash_point("journal.append.begin")
            frac = inj.torn_write_armed("journal.append.torn")
            if frac is not None:
                # a crash mid-write: a prefix of the frame reaches the
                # file, then the process dies without fsync
                f.write(frame[: max(1, int(len(frame) * frac))])
                os.fsync(f.fileno())  # make the torn state the durable one
                inj.crash_now("journal.append.torn")
        f.write(frame)
        if inj is not None:
            inj.crash_point("journal.append.after_write")
        os.fsync(f.fileno())
        if inj is not None:
            inj.crash_point("journal.append.after_fsync")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # ---------------------------------------------------------- replay side
    def replay(self) -> list[dict]:
        """Parse the journal's valid record prefix and repair the file.

        Reads records in order, stopping at the first frame that is
        truncated, mis-magicked, or CRC-inconsistent; everything after
        that point is a torn tail from a crash mid-append — by protocol
        order it was never acknowledged, so it is *truncated away* (the
        repair keeps later appends from landing after garbage). Returns
        the decoded records for the store to apply.
        """
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return []
        records: list[dict] = []
        off = 0
        while True:
            if off + _HEADER.size > len(blob):
                break
            magic, length, crc = _HEADER.unpack_from(blob, off)
            if magic != _MAGIC or off + _HEADER.size + length > len(blob):
                break
            payload = blob[off + _HEADER.size: off + _HEADER.size + length]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                break
            try:
                records.append(json.loads(payload.decode("utf-8")))
            except ValueError:
                break
            off += _HEADER.size + length
        if off < len(blob):
            with open(self.path, "r+b") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
        return records


__all__ = ["Journal", "JOURNAL_NAME", "encode_upsert", "encode_delete",
           "decode_upsert"]
