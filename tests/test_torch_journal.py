"""The port's write-ahead journal against the reference's: the same
mutation history gives byte-equal ``journal.wal`` files, each package
replays the other's, torn tails and CRC mismatches are truncated away, and
the four ``journal.append.*`` crash points fire in the reference's order.

Inputs are made with numpy from a seed; every file lives under
``tmp_path``. Injectors go in only through ``installed(...)`` and crash by
raising (``crash_mode="raise"``), never by leaving the process.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from repro import faults as jfaults
from repro.store import DatasetStore as JStore
from repro.store.journal import Journal as JJournal
from repro.store.journal import encode_delete as j_encode_delete
from repro.store.journal import encode_upsert as j_encode_upsert
from repro_torch import faults
from repro_torch.faults import FaultInjector, FaultPlan, InjectedCrash, installed
from repro_torch.store import JOURNAL_NAME, DatasetStore, Journal
from repro_torch.store.journal import decode_upsert, encode_delete, encode_upsert

RNG_SEED = 23


@pytest.fixture(autouse=True)
def _no_injector_left_behind():
    assert faults.active() is None and jfaults.active() is None
    yield
    assert faults.active() is None and jfaults.active() is None


def _history(seed: int = RNG_SEED) -> list[tuple]:
    """A mutation history: upserts of 1, 3 and 5 Gaussian f32 rows of width
    8 (first id, rows) and deletes of one and of several ids."""
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((n, 8)).astype(np.float32) for n in (1, 3, 5)]
    return [("upsert", 10, rows[0]), ("delete", [2]), ("upsert", 11, rows[1]),
            ("delete", [10, 0, 13]), ("upsert", 14, rows[2])]


def _append_all(journal, enc_upsert, enc_delete, history) -> None:
    for rec in history:
        journal.append(enc_upsert(rec[1], rec[2]) if rec[0] == "upsert" else enc_delete(rec[1]))
    journal.close()


def _same_records(got: list[dict], history) -> None:
    assert [r["op"] for r in got] == [h[0] for h in history]
    for r, h in zip(got, history):
        if h[0] == "upsert":
            id0, v = decode_upsert(r)
            assert id0 == h[1]
            np.testing.assert_array_equal(v, h[2])
        else:
            assert r["ids"] == h[1]


def test_payloads_match_the_reference():
    v = np.random.default_rng(1).standard_normal((2, 5)).astype(np.float32)
    assert encode_upsert(7, v) == j_encode_upsert(7, v)
    assert list(encode_upsert(7, v)) == ["op", "id0", "n", "dim", "data"]
    assert encode_delete(np.asarray([4, 1])) == j_encode_delete([4, 1])
    id0, back = decode_upsert(j_encode_upsert(7, v))
    assert id0 == 7 and back.dtype == np.float32
    np.testing.assert_array_equal(back, v)


def test_journals_are_byte_equal(tmp_path):
    history = _history()
    _append_all(Journal(str(tmp_path / "torch.wal")), encode_upsert, encode_delete, history)
    _append_all(JJournal(str(tmp_path / "jax.wal")), j_encode_upsert, j_encode_delete, history)
    assert (tmp_path / "torch.wal").read_bytes() == (tmp_path / "jax.wal").read_bytes()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_replays_the_others_journal(tmp_path, writer):
    history = _history()
    path = str(tmp_path / JOURNAL_NAME)
    if writer == "torch":
        _append_all(Journal(path), encode_upsert, encode_delete, history)
    else:
        _append_all(JJournal(path), j_encode_upsert, j_encode_delete, history)
    port, ref = Journal(path).replay(), JJournal(path).replay()
    assert port == ref
    _same_records(port, history)
    assert Journal(path).replay() == port  # replay of a clean log is pure


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_torn_tail_truncated_and_appendable(tmp_path, writer):
    path = str(tmp_path / JOURNAL_NAME)
    journal = Journal(path) if writer == "torch" else JJournal(path)
    enc = encode_delete if writer == "torch" else j_encode_delete
    journal.append(enc([1]))
    journal.append(enc([2]))
    journal.close()
    clean = os.path.getsize(path)
    with open(path, "ab") as f:  # a crash mid-append: half a frame
        f.write(b"KJNL\x99\x00")
    assert [r["ids"] for r in Journal(path).replay()] == [[1], [2]]
    # the repair truncated the torn tail: a later append lands after valid
    # bytes, and the reference reads the repaired file the same way
    assert os.path.getsize(path) == clean
    again = Journal(path)
    again.append(encode_delete([3]))
    again.close()
    assert [r["ids"] for r in JJournal(path).replay()] == [[1], [2], [3]]


def test_crc_mismatch_discards_tail(tmp_path):
    path = str(tmp_path / JOURNAL_NAME)
    _append_all(Journal(path), encode_upsert, encode_delete, [("delete", [7]), ("delete", [8])])
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF  # bit rot inside the second record's payload
    open(path, "wb").write(bytes(raw))
    assert [r["ids"] for r in Journal(path).replay()] == [[7]]
    assert JJournal(path).replay() == Journal(path).replay()


def test_replay_of_missing_file_is_empty(tmp_path):
    assert Journal(str(tmp_path / "absent.wal")).replay() == []


def test_store_journals_are_byte_equal(tmp_path):
    """The same upserts and deletes on a store in files of each package
    write the same journal, and either store reopens from the other's."""
    rng = np.random.default_rng(5)
    x = rng.integers(-9, 10, (300, 12)).astype(np.float32)
    ups = [rng.integers(-9, 10, (n, 12)).astype(np.float32) for n in (1, 4, 130)]
    stores = {"torch": DatasetStore.from_array(x, rows_per_shard=128,
                                               directory=str(tmp_path / "torch")),
              "jax": JStore.from_array(x, rows_per_shard=128, directory=str(tmp_path / "jax"))}
    for store in stores.values():
        store.upsert(ups[0])
        store.delete([3, 300])
        store.upsert(ups[1][0])  # one row given as (dim,)
        store.upsert(ups[1][1:])
        store.delete(np.asarray([0, 299, 303]))
        store.upsert(ups[2])
        store.close()
    wal = {name: (tmp_path / name / JOURNAL_NAME).read_bytes() for name in stores}
    assert wal["torch"] == wal["jax"] and len(Journal(str(tmp_path / "jax" / JOURNAL_NAME))
                                               .replay()) == 6
    port = DatasetStore.open(str(tmp_path / "jax"))
    ref = JStore.open(str(tmp_path / "torch"))
    assert (port.n_live, port.n_ids, port.n_delta) == (ref.n_live, ref.n_ids, ref.n_delta) == (
        300 + 135 - 5, 435, 135)


def test_unknown_record_op_fails_loud(tmp_path):
    x = np.ones((4, 8), np.float32)
    DatasetStore.from_array(x, directory=str(tmp_path)).close()
    journal = Journal(str(tmp_path / JOURNAL_NAME))
    journal.append({"op": "merge", "ids": [1]})
    journal.close()
    with pytest.raises(ValueError, match="unknown journal record op"):
        DatasetStore.open(str(tmp_path))


#: what each append crash point leaves in the file, in the reference's
#: protocol order: nothing, a prefix of the frame, the whole frame (fsync
#: pending), the whole frame (durable, never acknowledged)
_LEFT = {"journal.append.begin": "none", "journal.append.torn": "prefix",
         "journal.append.after_write": "frame", "journal.append.after_fsync": "frame"}


@pytest.mark.parametrize("site", list(_LEFT))
def test_append_crash_points_in_order(tmp_path, site):
    path = str(tmp_path / JOURNAL_NAME)
    whole = Journal(str(tmp_path / "whole.wal"))
    whole.append(encode_delete([1, 2]))
    whole.close()
    frame = (tmp_path / "whole.wal").read_bytes()
    journal = Journal(path, faults.active)
    with installed(FaultInjector(FaultPlan(crash_site=site))) as inj:
        with pytest.raises(InjectedCrash, match=site):
            journal.append(encode_delete([1, 2]))
    journal.close()
    left = open(path, "rb").read()
    want = {"none": b"", "prefix": frame[: max(1, int(len(frame) * 0.5))], "frame": frame}
    assert left == want[_LEFT[site]]
    assert [e["tier"] for e in inj.events if e["op"] == "crash"] == [site]
    assert Journal(path).replay() == ([] if _LEFT[site] != "frame" else [{"op": "delete",
                                                                          "ids": [1, 2]}])
