"""The port's store in files against the reference's: the manifest, the
on-disk format, CRC checks, and stores written by either package opened
and searched by the other.

Inputs are made with numpy from a seed and go through both packages on the
CPU (the port with ``device="cpu"``: its kernel steps run their plain
versions). The rows are integers in [-127, 127] with one entry at ±127, so
every score is exact and every row's int8 scale is exactly 1: both packages
must give bit-identical top-k, certificates and ``health``, and write
byte-equal shard files, norms, row-CRC sidecars and manifests.

Every file lives under ``tmp_path``. Corruption is written into a file in
place (one byte flipped through ``r+b``), never by truncating or rewriting
a file a live mapping reads.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import crash_child as cc
from repro.api.types import SearchRequest as JRequest
from repro.core.engine import ExactKNN as JExactKNN
from repro.store import DatasetStore as JStore
from repro.store import Manifest as JManifest
from repro.store import ManifestError as JManifestError
from repro.store import ShardMeta as JShardMeta
from repro_torch import ExactKNN, SearchRequest
from repro_torch.core.quantized import quantized_norm_sq
from repro_torch.faults import ShardCorruptError
from repro_torch.store import (
    DatasetStore,
    Manifest,
    ManifestError,
    ShardMeta,
    read_current,
    write_current,
)

N, D, ROWS, K_ = 700, 40, 256, 6  # 3 shards of 256 rows, the last 188 valid


def _np(t):
    return np.asarray(t)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    x = rng.integers(-127, 128, (N, D)).astype(np.float32)
    x[np.arange(N), rng.integers(0, D, N)] = 127.0 * rng.choice([-1.0, 1.0], N)
    x[300], x[650] = x[12], x[12]  # exact ties across shards
    q = rng.integers(-40, 41, (4, D)).astype(np.float32)
    q[0] = x[12]
    return x, q


def _flip(path, offset: int) -> None:
    """Flip one byte of a file in place (a mapping of it sees the change)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _write_port(x, directory, int8=False, rows=ROWS):
    store = DatasetStore.from_array(x, rows_per_shard=rows, directory=str(directory))
    if int8:
        store.ensure_tier("int8")
    return store


def _write_ref(x, directory, int8=False, rows=ROWS):
    tiers = ("f32", "int8") if int8 else ("f32",)
    return JStore.from_array(x, rows_per_shard=rows, directory=str(directory), tiers=tiers)


def _engines(tstore, jstore, int8=False, **kw):
    teng = ExactKNN(k=K_, backend="cuda", device="cpu", retry_backoff_s=0.0,
                    **kw).fit_store(tstore, resident=False)
    jeng = JExactKNN(k=K_, retry_backoff_s=0.0, **kw).fit_store(jstore, resident=False)
    if int8:
        teng.enable_int8()
        jeng.enable_int8()
    return teng, jeng


def _same_result(got, want):
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)
    _same(got.certified, want.certified)
    for key in ("transfers", "restarts", "bytes_scanned", "partial"):
        assert got.stats[key] == want.stats[key], key
    # slow_shards is a wall-clock observation, not a result
    g, w = dict(got.stats["health"]), dict(want.stats["health"])
    g.pop("slow_shards"), w.pop("slow_shards")
    assert g == w


def _search_both(teng, jeng, q, tier, **req):
    got = teng.search(SearchRequest(queries=q, tier=tier, **req))
    want = jeng.search(JRequest(queries=q, tier=tier, **req))
    return got, want


# ------------------------------------------------------------- manifest
def _manifest_fields(n_valid=700, rows=256, n_shards=3):
    shards = []
    for i in range(n_shards):
        nv = min(rows, max(0, n_valid - i * rows))
        files = {"f32": f"shard_{i:05d}.f32.bin", "f32_norms": f"shard_{i:05d}.norms.npy"}
        shards.append(dict(shard_id=i, row_start=i * rows, n_valid=nv, padded_rows=rows,
                           padded_dim=128, files=files, checksums={"f32": 7 * i + 1}))
    return dict(dim=40, padded_dim=128, rows_per_shard=rows, n_valid=n_valid,
                tiers=("f32",), shards=shards, generation=0, next_id=n_valid)


def _both_manifests(fields):
    tm = Manifest(**{**fields, "shards": tuple(ShardMeta(**s) for s in fields["shards"])})
    jm = JManifest(**{**fields, "shards": tuple(JShardMeta(**s) for s in fields["shards"])})
    return tm, jm


def test_manifest_json_matches_reference(tmp_path):
    tm, jm = _both_manifests(_manifest_fields())
    assert tm.to_json() == jm.to_json()
    back = Manifest.from_json(jm.to_json())
    assert back == tm and back.n_shards == 3 and back.padded_rows_total == 768
    tm.save(str(tmp_path))
    assert Manifest.load(str(tmp_path)) == tm
    assert JManifest.load(str(tmp_path)) == jm
    assert not os.path.exists(tmp_path / "manifest.json.tmp")


def test_manifest_future_version_rejected():
    m = Manifest(dim=8, padded_dim=128, rows_per_shard=128, n_valid=8)
    with pytest.raises(ValueError, match="version"):
        Manifest.from_json(m.to_json().replace('"version": 1', '"version": 99'))


def _shard(fields, i, **kw):
    shards = [dict(s) for s in fields["shards"]]
    shards[i].update(kw)
    return {**fields, "shards": shards}


#: one structural fault per case, and the field the error must name
INVALID = {
    "dim": lambda f: {**f, "dim": 0},
    "padded_dim": lambda f: {**f, "padded_dim": 32},
    "rows_per_shard": lambda f: {**f, "rows_per_shard": 0},
    "n_valid": lambda f: {**f, "n_valid": 900},
    "generation": lambda f: {**f, "generation": -1},
    "tiers": lambda f: {**f, "tiers": ("int8",)},
    "tiers-unknown": lambda f: {**f, "tiers": ("f32", "bf16")},
    "shards": lambda f: {**f, "shards": []},
    "shards-duplicate": lambda f: _shard(f, 2, shard_id=1),
    "shards[1].shard_id": lambda f: {**f, "shards": [f["shards"][0], f["shards"][2],
                                                      f["shards"][1]]},
    "shards[1].row_start": lambda f: _shard(f, 1, row_start=300),
    "shards[0].padded_rows": lambda f: _shard(f, 0, padded_rows=128),
    "shards[2].padded_dim": lambda f: _shard(f, 2, padded_dim=256),
    "shards[2].n_valid": lambda f: _shard(f, 2, n_valid=256),
    "shards[1].files": lambda f: _shard(f, 1, files={"f32": "x.bin"}),
    "shards[0].files-int8": lambda f: {**f, "tiers": ("f32", "int8")},
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_manifest_validation_names_the_field(case):
    tm, jm = _both_manifests(INVALID[case](_manifest_fields()))
    with pytest.raises(ManifestError) as got:
        tm.validate()
    with pytest.raises(JManifestError) as want:
        jm.validate()
    assert got.value.field == want.value.field == case.split("-")[0]
    assert isinstance(got.value, ValueError)


def test_valid_manifest_passes_both():
    tm, jm = _both_manifests(_manifest_fields())
    assert tm.validate() is tm and jm.validate() is jm


def test_current_pointer_round_trip(tmp_path):
    assert read_current(str(tmp_path)) is None
    write_current(str(tmp_path), "gen_000003")
    assert read_current(str(tmp_path)) == "gen_000003"
    assert (tmp_path / "CURRENT").read_text() == "gen_000003\n"
    assert not os.path.exists(tmp_path / "CURRENT.tmp")


# ------------------------------------------------------ the on-disk format
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "f32+int8"])
def test_written_files_are_byte_equal(data, tmp_path, int8):
    x, _ = data
    _write_port(x, tmp_path / "torch", int8)
    _write_ref(x, tmp_path / "jax", int8)
    names = ["CURRENT", "manifest.json"] + [
        f"shard_{i:05d}.{kind}" for i in range(3)
        for kind in ("f32.bin", "norms.npy", "rowcrc.npy") + (("int8.bin",) if int8 else ())]
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "torch" / "journal.wal").read_bytes() == b""
    m = json.loads((tmp_path / "torch" / "manifest.json").read_text())
    assert m["tiers"] == (["f32", "int8"] if int8 else ["f32"])
    assert [s["n_valid"] for s in m["shards"]] == [256, 256, 188]
    if int8:  # npz bytes carry zip timestamps: their contents must agree
        for i in range(3):
            with np.load(tmp_path / "torch" / f"shard_{i:05d}.int8.npz") as a, \
                    np.load(tmp_path / "jax" / f"shard_{i:05d}.int8.npz") as b:
                assert a.files == b.files == ["scales", "err", "norms_sq", "qnorm_sq"]
                for f in a.files:
                    _same(a[f], b[f])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_reference_store_opens_in_the_port(data, tmp_path, int8):
    x, q = data
    _write_ref(x, tmp_path, int8)
    tstore = DatasetStore.open(str(tmp_path), verify=True)
    assert tstore.is_mmap and tstore.tiers == (("f32", "int8") if int8 else ("f32",))
    teng, jeng = _engines(tstore, JStore.open(str(tmp_path), verify=True), int8)
    tier = "int8" if int8 else "f32"
    got, want = _search_both(teng, jeng, q, tier)
    assert got.plan.executor == want.plan.executor == (
        "fqsd-int8-mmap-streamed" if int8 else "fqsd-mmap-streamed")
    _same_result(got, want)
    assert got.stats["transfers"] == 3


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_port_store_opens_in_the_reference(data, tmp_path, int8):
    x, q = data
    tstore = _write_port(x, tmp_path, int8)
    jstore = JStore.open(str(tmp_path), verify=True)
    assert jstore.is_mmap and jstore.has_tier("int8") == int8
    teng, jeng = _engines(tstore, jstore, int8)
    got, want = _search_both(teng, jeng, q, "int8" if int8 else "f32", spec_trigger=0.5)
    _same_result(got, want)


def test_opened_store_matches_host_ram_store(data, tmp_path):
    """The same rows from files and from host RAM: the same answers, and a
    resident fit of the opened store equals its streamed search."""
    x, q = data
    opened = _write_port(x, tmp_path, int8=True)
    ram = DatasetStore.from_array(x, rows_per_shard=ROWS)
    for tier in ("f32", "int8"):
        a = ExactKNN(k=K_, backend="cuda", device="cpu").fit_store(opened, resident=False)
        b = ExactKNN(k=K_, backend="cuda", device="cpu").fit_store(ram, resident=False)
        if tier == "int8":
            a.enable_int8(), b.enable_int8()
        got, want = (e.search(SearchRequest(queries=q, tier=tier)) for e in (a, b))
        assert got.plan.executor.endswith("mmap-streamed")
        assert want.plan.executor in ("fqsd-mmap-streamed", "fqsd-int8-streamed")
        _same(got.topk.scores, want.topk.scores)
        _same(got.topk.indices, want.topk.indices)
        assert got.stats["bytes_scanned"] == want.stats["bytes_scanned"]
    resident = ExactKNN(k=K_, backend="cuda", device="cpu").fit_store(opened, resident=True)
    assert isinstance(resident._ds.vectors, torch.Tensor)
    _same(resident._ds.vectors[:N, :D], x)
    got = resident.search(SearchRequest(queries=q, mode_hint="fqsd"))
    _same(got.topk.indices, want.topk.indices)


def test_one_shard_store_in_files(data, tmp_path):
    x, q = data
    store = DatasetStore.from_array(x[:300], directory=str(tmp_path))
    jstore = JStore.from_array(x[:300], directory=str(tmp_path / "jax"))
    assert store.n_shards == jstore.n_shards == 1
    assert store.rows_per_shard == jstore.rows_per_shard == 384
    got, want = _search_both(*_engines(store, jstore), q, "f32")
    _same_result(got, want)


def test_generation_directory_through_current(data, tmp_path):
    """CURRENT naming a gen_NNNNNN/ directory (a compaction with nothing to
    fold keeps identity row ids): the port opens that generation."""
    x, q = data
    jstore = _write_ref(x, tmp_path)
    jstore.compact()
    assert read_current(str(tmp_path)) == "gen_000001"
    store = DatasetStore.open(str(tmp_path), verify=True)
    assert store.manifest.generation == 1 and store.directory == str(tmp_path)
    got, want = _search_both(*_engines(store, JStore.open(str(tmp_path))), q, "f32")
    _same_result(got, want)


@pytest.mark.parametrize("piece_rows", [256, 2], ids=["one-thread", "threaded"])
def test_gather_rows_reads_the_mapping(data, tmp_path, monkeypatch, piece_rows):
    from repro_torch.store import store as store_module

    monkeypatch.setattr(store_module, "GATHER_PIECE_ROWS", piece_rows)
    x, _ = data
    _write_port(x, tmp_path)
    store = DatasetStore.open(str(tmp_path), verify_on_read=True)
    jstore = JStore.open(str(tmp_path))
    ids = np.array([-1, 3, 700, 260, 259, 5, 10_000, 699], dtype=np.int64)
    got = store.gather_rows(ids)
    _same(got, jstore.gather_rows(ids))
    _same(got[1, :D], x[3])
    assert not got[[0, 2, 6]].any()
    many = np.sort(np.random.default_rng(3).choice(N, 300, replace=False))
    _same(store.gather_rows(many), jstore.gather_rows(many))
    _flip(tmp_path / "shard_00001.f32.bin", (int(many[many >= ROWS][7]) - ROWS) * 512 + 4)
    with pytest.raises(ShardCorruptError, match=f"row {int(many[many >= ROWS][7]) - ROWS} "):
        store.gather_rows(many)


def test_int8_codes_come_back_mapped(data, tmp_path):
    x, _ = data
    _write_port(x, tmp_path, int8=True)
    store = DatasetStore.open(str(tmp_path), verify=True)
    for i8 in store._int8:
        assert isinstance(i8.q, np.memmap) and i8.q.dtype == np.int8
        _same(i8.qnorm_sq, quantized_norm_sq(torch.from_numpy(np.array(i8.q)), i8.scales))
    res = store.int8_resident()
    assert isinstance(res.q, torch.Tensor) and res.q.shape == (768, 128)


def test_legacy_single_npz_int8_format(data, tmp_path):
    """The format before the codes/meta split: one .int8.npz holding the
    codes, no qnorm_sq. Both packages re-derive qnorm and answer alike."""
    x, q = data
    _write_port(x, tmp_path, int8=True)
    m = Manifest.load(str(tmp_path))
    shards = []
    for s in m.shards:
        codes = np.fromfile(tmp_path / s.files["int8"], dtype=np.int8).reshape(
            s.padded_rows, s.padded_dim)
        with np.load(tmp_path / s.files["int8_meta"]) as z:
            meta = {f: z[f] for f in ("scales", "err", "norms_sq")}
        name = f"shard_{s.shard_id:05d}.legacy.int8.npz"
        np.savez(tmp_path / name, q=codes, **meta)
        files = {k: v for k, v in s.files.items() if k != "int8_meta"}
        checks = {k: v for k, v in s.checksums.items() if k != "int8_meta"}
        shards.append(dataclasses.replace(s, files={**files, "int8": name}, checksums=checks))
    dataclasses.replace(m, shards=tuple(shards)).save(str(tmp_path))
    store = DatasetStore.open(str(tmp_path), verify=True)
    assert isinstance(store._int8[0].q, torch.Tensor)
    got, want = _search_both(*_engines(store, JStore.open(str(tmp_path), verify=True), True),
                             q, "int8")
    _same_result(got, want)


# ------------------------------------------------------------- integrity
@pytest.mark.parametrize("victim,match", [
    ("shard_00001.f32.bin", "checksum mismatch on shard 1"),
    ("shard_00002.rowcrc.npy", "row-CRC sidecar of shard 2"),
    ("shard_00001.int8.bin", "int8 codes of shard 1"),
    ("shard_00002.int8.npz", "corrupt|checksum"),
])
def test_verified_open_detects_a_flipped_byte(data, tmp_path, victim, match):
    x, _ = data
    _write_port(x, tmp_path, int8=True)
    DatasetStore.open(str(tmp_path), verify=True)  # pristine: fine
    path = tmp_path / victim
    _flip(path, os.path.getsize(path) // 2)
    with pytest.raises(ValueError, match=match):
        DatasetStore.open(str(tmp_path), verify=True)
    with pytest.raises(ValueError):
        JStore.open(str(tmp_path), verify=True)
    if not victim.endswith(".npz"):  # an unverified open stays lazy
        assert DatasetStore.open(str(tmp_path)).n_shards == 3


def _open_streamed(x, tmp_path):
    _write_port(x, tmp_path, int8=True)
    tstore = DatasetStore.open(str(tmp_path), verify_on_read=True)
    jstore = JStore.open(str(tmp_path), verify_on_read=True)
    return _engines(tstore, jstore, int8=True)


def test_mid_scan_int8_codes_corruption_quarantines_to_f32(data, tmp_path):
    """Bytes flipped after open, seen through the live mappings: with CRCs
    checked on read the int8 shard falls back to its exact f32 rows."""
    x, q = data
    teng, jeng = _open_streamed(x, tmp_path)
    baseline = teng.search(SearchRequest(queries=q, tier="int8"))
    _flip(tmp_path / "shard_00001.int8.bin", 500)
    got, want = _search_both(teng, jeng, q, "int8")
    _same(got.topk.scores, baseline.topk.scores)
    _same(got.topk.indices, baseline.topk.indices)
    assert got.stats["health"]["degraded"] == [1] and got.stats["health"]["retries"] >= 1
    assert not got.stats["partial"]
    _same_result(got, want)


def test_mid_scan_f32_corruption_is_loud_or_partial(data, tmp_path):
    x, q = data
    teng, jeng = _open_streamed(x, tmp_path)
    _flip(tmp_path / "shard_00002.f32.bin", 64)
    with pytest.raises(ShardCorruptError) as err:
        teng.search(SearchRequest(queries=q))
    assert err.value.shard_id == 2 and err.value.tier == "f32"
    got, want = _search_both(teng, jeng, q, "f32", allow_partial=True)
    assert got.stats["partial"] and got.stats["health"]["failed_shards"] == [2]
    assert not (_np(got.topk.indices) >= 2 * ROWS).any()
    _same_result(got, want)


def test_mid_scan_candidate_row_corruption_fails_the_gather(data, tmp_path):
    """A flipped byte in a candidate's f32 row: the int8 scan never reads
    it, the candidate gather's per-row CRC does."""
    x, q = data
    teng, jeng = _open_streamed(x, tmp_path)
    row = 12  # query 0's own row: always a candidate
    _flip(tmp_path / "shard_00000.f32.bin", row * 128 * 4 + 8)
    with pytest.raises(ShardCorruptError, match=f"row {row} of f32 shard 0"):
        teng.search(SearchRequest(queries=q, tier="int8", spec_trigger=1.0))
    with pytest.raises(Exception, match=f"row {row} of f32 shard 0"):
        jeng.search(JRequest(queries=q, tier="int8", spec_trigger=1.0))


# ------------------------------------- what open once refused, replayed
def test_open_refuses_a_journal_with_records(data, tmp_path):
    """Refused before the store's write side was ported: a reference store
    whose journal holds mutation records now opens in the port and replays
    them to the reference's digest and answers."""
    x, q = data
    jstore = _write_ref(x, tmp_path)
    jstore.upsert(x[:2] + 1)  # durable records in the journal
    jstore.delete([5, N])
    jstore.close()
    want = JStore.open(str(tmp_path))
    store = DatasetStore.open(str(tmp_path))
    assert cc.digest(store) == cc.digest(want)
    assert (store.n_delta, store.n_live, store.n_ids) == (2, N, N + 2)
    got, exp = _search_both(*_engines(store, want), q, "f32")
    _same_result(got, exp)


def test_open_reads_past_a_torn_journal_tail(data, tmp_path):
    """A torn tail is no record: the store opens as written and replay
    truncates the tail away, as the reference's does; a whole record
    after it replays."""
    x, q = data
    _write_port(x, tmp_path)
    payload = b'{"op":"delete","ids":[3]}'
    frame = struct.pack("<4sII", b"KJNL", len(payload), zlib.crc32(payload)) + payload
    (tmp_path / "journal.wal").write_bytes(frame[:10])
    store = DatasetStore.open(str(tmp_path))
    assert (tmp_path / "journal.wal").read_bytes() == b""
    got = ExactKNN(k=K_, device="cpu").fit_store(store, resident=False).search(
        SearchRequest(queries=x[3:4]))
    assert int(got.topk.indices[0, 0]) == 3  # the torn delete never happened
    store.close()
    (tmp_path / "journal.wal").write_bytes(frame)
    store = DatasetStore.open(str(tmp_path))
    assert store.n_live == N - 1
    got = ExactKNN(k=K_, device="cpu").fit_store(store, resident=False).search(
        SearchRequest(queries=x[3:4]))
    assert 3 not in got.topk.indices[0].tolist()


def test_open_refuses_remapped_row_ids(data, tmp_path):
    """Refused before: a compacted reference generation whose rows carry
    remapped ids (rowids.npy) opens in the port with the reference's
    digest, and both answer in external ids."""
    x, q = data
    jstore = _write_ref(x, tmp_path)
    jstore.delete([5])
    jstore.compact()
    jstore.close()
    store = DatasetStore.open(str(tmp_path))
    want = JStore.open(str(tmp_path))
    assert store.generation == 1 and store.manifest.row_ids_file == "rowids.npy"
    with store.snapshot() as view:
        assert not view.identity and view.external_ids([4, 5]).tolist() == [4, 6]
    assert cc.digest(store) == cc.digest(want)
    got, exp = _search_both(*_engines(store, want), q, "f32")
    _same_result(got, exp)


# ------------------------------------------------------------- surface
def test_read_surface_and_close(data, tmp_path):
    x, _ = data
    store = _write_port(x, tmp_path)
    assert store.is_mmap and store.directory == str(tmp_path)
    assert store.tiers == ("f32",) and not store.is_pinned
    assert store.nbytes("f32") == 3 * 256 * 128 * 4 and store.nbytes("int8") == 3 * 256 * 128
    assert store.manifest == Manifest.load(str(tmp_path))
    assert store.meta(device_resident=False).mmap
    assert store.fault_injector is None and not store.verify_on_read
    with pytest.raises(ValueError, match="never pinned"):
        store.pin()
    with pytest.raises(ValueError, match="never pinned"):
        DatasetStore.from_array(x, rows_per_shard=ROWS, directory=str(tmp_path / "b"),
                                pin_memory=True)
    assert store.upsert(x[:1]).tolist() == [N] and store.n_delta == 1
    assert (tmp_path / "journal.wal").stat().st_size > 0  # journaled first
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.read_shard(0)
    with pytest.raises(ValueError, match="closed"):
        store.gather_rows([1])
    assert store.n_shards == 3
    assert not DatasetStore.from_array(x, rows_per_shard=ROWS).is_mmap


def test_fit_store_plans_mmap_executors_and_never_pins(data, tmp_path, monkeypatch):
    """A non-resident store in files plans the mmap executors, and
    fit_store on a CUDA engine does not pin it (that would read every file
    into page-locked RAM)."""
    x, _ = data
    store = _write_port(x, tmp_path, int8=True)
    monkeypatch.setattr(store, "pin", lambda: pytest.fail("fit_store pinned a store in files"))
    eng = ExactKNN(k=K_, backend="cuda", device="cuda").fit_store(store, resident=False)
    assert not store.is_pinned
    assert eng.plan_for("fqsd", m=4).executor == "fqsd-mmap-streamed"
    assert eng.plan_for("fqsd", m=4, tier="int8").executor == "fqsd-int8-mmap-streamed"
    ram = ExactKNN(k=K_, backend="cuda", device="cpu").fit_store(
        DatasetStore.from_array(x, rows_per_shard=ROWS), resident=False).enable_int8()
    assert ram.plan_for("fqsd", m=4, tier="int8").executor == "fqsd-int8-streamed"


def test_rewriting_a_directory_leaves_live_mappings_intact(data, tmp_path):
    """Files are replaced, never truncated: a store still reading the old
    files keeps its bytes when the directory is written again."""
    x, _ = data
    old = _write_port(x, tmp_path)
    new = _write_port(-x, tmp_path)
    _same(old.read_shard(1).vectors[:, :D], x[256:512])
    _same(new.read_shard(1).vectors[:, :D], -x[256:512])


def test_staging_copies_a_mapping_in_pieces(data, tmp_path, monkeypatch):
    """The double buffer's staging copy (run on the card into page-locked
    banks) splits a mapped shard into row pieces over its thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import streaming

    class Counting(ThreadPoolExecutor):
        submitted = 0

        def submit(self, *args, **kw):
            self.submitted += 1
            return super().submit(*args, **kw)

    x, _ = data
    src = _write_port(x, tmp_path).read_shard(1).vectors
    assert isinstance(src, np.memmap) and not src.flags.writeable
    monkeypatch.setattr(streaming, "STAGE_PIECE_BYTES", 4096)
    monkeypatch.setattr(streaming, "stage_threads", lambda: 4)
    dst = torch.empty(src.shape)
    with Counting(4) as pool:
        streaming.stage(dst, src, pool)
        _same(dst, src)
        assert pool.submitted == 4
        bumped = torch.from_numpy(np.array(src)) + 1
        streaming.stage(dst, bumped, pool)
        _same(dst, bumped)
    streaming.stage(dst, src, None)
    _same(dst, src)


def test_the_cpu_stream_hands_over_copies_of_a_mapping(data, tmp_path):
    """On the CPU a mapped shard becomes a tensor of its own: a tensor over
    a read-only mapping would fault on the first write."""
    from repro_torch.core.streaming import DoubleBufferedStream

    x, _ = data
    store = _write_port(x, tmp_path)
    got = list(DoubleBufferedStream(store.shard_source(), device="cpu"))
    for p, host in zip(got, store.shard_source()):
        assert isinstance(p.vectors, torch.Tensor)
        assert p.vectors.data_ptr() != host.vectors.ctypes.data
        _same(p.vectors, host.vectors)
