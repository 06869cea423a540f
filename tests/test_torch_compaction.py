"""Compaction in the port against the reference: the delta rows and
tombstones folded into a new generation, the ``CURRENT`` swap, collection
of the old generation, and reopening.

The same seeded numpy history goes through a store in files of each
package on the CPU; the compacted generation's files (shards, norms, row
CRCs, ``rowids.npy``, ``manifest.json``, int8 codes, the journal of what
arrived during the build) must be byte-equal, the int8 ``.npz`` channels
equal by contents (their zip members carry timestamps), and either package
must open the other's ``gen_NNNNNN/`` to the same digest
(``crash_child.digest``: the id space and a CRC of every live row).
Modelled on ``TestCompaction`` and ``TestEngineAcrossCompaction`` in
``tests/test_compaction.py``.

Hygiene: files under ``tmp_path``; injectors only through ``installed``;
every background compaction thread joined with a timeout before its test
ends.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

import crash_child as cc
from repro import faults as jfaults
from repro.api.types import SearchRequest as JRequest
from repro.core.engine import ExactKNN as JExactKNN
from repro.store import DatasetStore as JStore
from repro_torch import ExactKNN, SearchRequest, faults
from repro_torch.core.executors import cache_info
from repro_torch.faults import FaultInjector, FaultPlan
from repro_torch.store import DatasetStore, read_current

N, D, ROWS = 300, 16, 128


@pytest.fixture(autouse=True)
def _no_injector_or_compactor_left_behind():
    assert faults.active() is None and jfaults.active() is None
    yield
    for t in threading.enumerate():
        if t.name == "store-compactor":
            t.join(timeout=60)
            assert not t.is_alive(), "a compaction thread outlived its test"
    assert faults.active() is None and jfaults.active() is None


def _rows(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, D)).astype(np.float32)
    x[np.arange(n), rng.integers(0, D, n)] = 127.0 * rng.choice([-1.0, 1.0], n)
    return x


def _history(store) -> None:
    """40 upserted rows (one delta shard), three deletes (two main, one
    delta), as in the reference's ``_mutated_store``."""
    store.upsert(_rows(2, 40))
    store.delete([3, 310, 17])


def _mutated(tmp_path, package: str, int8: bool = False):
    d = str(tmp_path / package)
    if package == "torch":
        store = DatasetStore.from_array(_rows(1, N), rows_per_shard=ROWS, directory=d)
        if int8:
            store.ensure_tier("int8")
    else:
        store = JStore.from_array(_rows(1, N), rows_per_shard=ROWS, directory=d,
                                  tiers=("f32", "int8") if int8 else ("f32",))
    _history(store)
    return store


def test_fold_swap_gc_and_reopen(tmp_path):
    store = _mutated(tmp_path, "torch", int8=True)
    dig0 = cc.digest(store)
    stats = store.compact()
    assert stats["generation"] == 1 and stats["delta_folded"] == 40
    assert stats["rows_reclaimed"] == 3 and stats["drained_during_build"] == 0
    assert store.generation == 1 and store.n_delta == 0
    assert store.n_live == 337 and store.n_ids == 340
    assert cc.digest(store) == dig0  # logical state untouched
    d = tmp_path / "torch"
    assert read_current(str(d)) == "gen_000001"
    assert (d / "gen_000001" / "manifest.json").exists()
    assert not (d / "manifest.json").exists() and not (d / "shard_00000.f32.bin").exists()
    reopened = DatasetStore.open(str(d), verify=True)
    assert cc.digest(reopened) == dig0 and reopened.has_tier("int8")
    reopened.delete([5])  # external ids are stable across the fold...
    assert reopened.upsert(np.ones((1, D), np.float32)).tolist() == [340]  # ...never reused


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "f32+int8"])
def test_compacted_generation_files_are_byte_equal(tmp_path, int8):
    stores = {p: _mutated(tmp_path, p, int8) for p in ("torch", "jax")}
    for store in stores.values():
        store.compact()
        store.close()
    gen = {p: tmp_path / p / "gen_000001" for p in stores}
    names = sorted(os.listdir(gen["jax"]))
    assert sorted(os.listdir(gen["torch"])) == names
    assert "rowids.npy" in names and "journal.wal" not in names  # nothing drained
    for name in names:
        if name.endswith(".npz"):  # zip members carry timestamps: compare contents
            with np.load(gen["torch"] / name) as a, np.load(gen["jax"] / name) as b:
                assert a.files == b.files
                for f in a.files:
                    np.testing.assert_array_equal(a[f], b[f])
        else:
            assert (gen["torch"] / name).read_bytes() == (gen["jax"] / name).read_bytes(), name
    assert (tmp_path / "torch" / "CURRENT").read_bytes() == (tmp_path / "jax" / "CURRENT").read_bytes()
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_either_package_opens_the_others_generation(tmp_path, writer):
    store = _mutated(tmp_path, writer, int8=True)
    store.compact()
    store.upsert(_rows(3, 2))  # journaled into the new generation
    store.delete([4])
    store.close()
    d = str(tmp_path / writer)
    port, ref = DatasetStore.open(d, verify=True), JStore.open(d, verify=True)
    assert cc.digest(port) == cc.digest(ref)
    assert port.generation == ref.generation == 1 and port.n_ids == ref.n_ids == 342
    q = _rows(4, 3)
    teng = ExactKNN(k=5, backend="cuda", device="cpu").fit_store(port, resident=False)
    jeng = JExactKNN(k=5).fit_store(ref, resident=False)
    for tier in ("f32", "int8"):
        if tier == "int8":
            teng.enable_int8()
            jeng.enable_int8()
        got = teng.search(SearchRequest(queries=q, tier=tier))
        want = jeng.search(JRequest(queries=q, tier=tier))
        np.testing.assert_array_equal(got.topk.scores.numpy(), np.asarray(want.topk.scores))
        np.testing.assert_array_equal(got.topk.indices.numpy(), np.asarray(want.topk.indices))


class _MutateDuringBuild:
    """An injector whose compact.after_manifest visit (the build done, the
    lock not yet taken) runs mutations, as a writer racing the compactor
    would: they must drain into the new generation's journal."""

    def __init__(self, base, store):
        self.base, self.store, self.done = base, store, False

    def __getattr__(self, name):
        return getattr(self.base, name)

    def crash_point(self, site: str) -> None:
        if site == "compact.after_manifest" and not self.done:
            self.done = True
            self.store.upsert(_rows(5, 3))
            self.store.delete([20, 305, 341])  # main, old delta, new delta
        self.base.crash_point(site)


def test_mutations_during_the_build_drain_into_the_new_journal(tmp_path):
    stores = {p: _mutated(tmp_path, p) for p in ("torch", "jax")}
    installs = {"torch": (faults, FaultInjector(FaultPlan())),
                "jax": (jfaults, jfaults.FaultInjector(jfaults.FaultPlan()))}
    stats = {}
    for p, store in stores.items():
        mod, base = installs[p]
        with mod.installed(_MutateDuringBuild(base, store)):
            stats[p] = store.compact()
    assert stats["torch"]["drained_during_build"] == stats["jax"]["drained_during_build"] == 4
    assert cc.digest(stores["torch"]) == cc.digest(stores["jax"])
    wal = [(tmp_path / p / "gen_000001" / "journal.wal").read_bytes() for p in stores]
    assert wal[0] == wal[1] and len(wal[0]) > 0
    for store in stores.values():
        store.close()
    assert cc.digest(DatasetStore.open(str(tmp_path / "jax"))) == cc.digest(
        JStore.open(str(tmp_path / "torch")))


def test_repeated_compactions_keep_one_generation_on_disk(tmp_path):
    store = _mutated(tmp_path, "torch")
    for gen in (1, 2, 3):
        store.upsert(_rows(10 + gen, 4))
        assert store.compact()["generation"] == gen
    assert sorted(p for p in os.listdir(tmp_path / "torch") if p.startswith("gen_")) == [
        "gen_000003"]
    assert store.compaction_status()["retired_pinned"] == 0


def test_pinned_view_defers_gc_until_released(tmp_path):
    store = _mutated(tmp_path, "torch")
    view = store.snapshot()  # a search in flight
    before = cc.digest(store)
    first = np.array(view.read_shard(0).vectors)
    store.compact()
    assert store.compaction_status()["retired_pinned"] == 1
    assert (tmp_path / "torch" / "manifest.json").exists()
    np.testing.assert_array_equal(np.asarray(view.read_shard(0).vectors), first)
    assert view.generation == 0 and len(view.delta_shards()) == 1
    view.release()
    assert store.compaction_status()["retired_pinned"] == 0
    assert not (tmp_path / "torch" / "manifest.json").exists()  # collected on unpin
    assert cc.digest(store) == before


def test_concurrent_compact_rejected(tmp_path):
    store = _mutated(tmp_path, "torch")
    with store._lock:
        store._compact_state["running"] = True
    try:
        with pytest.raises(RuntimeError, match="already running"):
            store.compact()
        assert store.compact_async() is None
    finally:
        with store._lock:
            store._compact_state["running"] = False


def test_auto_compact_pending_triggers_background_fold(tmp_path):
    store = _mutated(tmp_path, "torch")
    store.auto_compact_pending = 8  # 40 delta rows + 3 tombstones pending
    store.upsert(_rows(6, 1))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = store.compaction_status()
        if st["compactions"] >= 1 and not st["running"]:
            break
        time.sleep(0.02)
    st = store.compaction_status()
    assert st["compactions"] >= 1 and st["error"] is None
    assert store.generation >= 1 and st["pending_delta"] == 0


def test_ram_store_compaction_keeps_geometry():
    """A store in host RAM compacts in memory to the reference's digest,
    with the same shard geometry and the tombstones gone."""
    port = DatasetStore.from_array(_rows(1, N), rows_per_shard=ROWS)
    ref = JStore.from_array(_rows(1, N), rows_per_shard=ROWS)
    for store in (port, ref):
        _history(store)
        store.compact()
    assert cc.digest(port) == cc.digest(ref)
    assert (port.n_shards, port.rows_per_shard, port.generation) == (3, ROWS, 1)
    assert port.directory is None and not port.is_mmap
    assert sum(int(np.isfinite(port.read_shard(i).norms.numpy()).sum())
               for i in range(port.n_shards)) == 337


# ------------------------------------------------ the engine across a swap
def _engine(tmp_path, n=1500, d=32):
    rng = np.random.default_rng(9)
    x = rng.integers(-9, 10, (n, d)).astype(np.float32)
    q = rng.integers(-9, 10, (6, d)).astype(np.float32)
    DatasetStore.from_array(x, rows_per_shard=512, directory=str(tmp_path))
    store = DatasetStore.open(str(tmp_path))
    eng = ExactKNN(k=5, backend="cuda", device="cpu", device_budget_bytes=1,
                   retry_backoff_s=0.0).fit_store(store)
    return eng, store, q


def test_zero_new_cache_entries_and_stable_external_ids(tmp_path):
    eng, store, q = _engine(tmp_path)
    ids = eng.upsert(q[:3] + 1)
    eng.delete([int(ids[1]), 7])
    r1 = eng.search(SearchRequest(queries=q))
    warm = cache_info()
    assert store.compact()["rows_reclaimed"] == 2
    r2 = eng.search(SearchRequest(queries=q))  # the engine refits on the swap
    assert cache_info()["misses"] == warm["misses"] and cache_info()["size"] == warm["size"]
    np.testing.assert_array_equal(r1.topk.indices.numpy(), r2.topk.indices.numpy())
    np.testing.assert_array_equal(r1.topk.scores.numpy(), r2.topk.scores.numpy())
    assert int(r2.topk.indices[0, 0]) == int(ids[0])


def test_search_keeps_serving_during_background_compaction(tmp_path):
    eng, store, q = _engine(tmp_path)
    eng.upsert(np.random.default_rng(2).integers(-9, 10, (30, 32)).astype(np.float32))
    eng.delete([11, 12])
    baseline = eng.search(SearchRequest(queries=q))
    t = store.compact_async()
    assert t is not None
    try:
        while t.is_alive():  # searches never wait on the compactor
            res = eng.search(SearchRequest(queries=q))
            np.testing.assert_array_equal(res.topk.indices.numpy(),
                                          baseline.topk.indices.numpy())
    finally:
        t.join(timeout=60)
    assert not t.is_alive() and store.compaction_status()["error"] is None
    assert store.generation == 1
    after = eng.search(SearchRequest(queries=q))
    np.testing.assert_array_equal(after.topk.indices.numpy(), baseline.topk.indices.numpy())
    np.testing.assert_array_equal(after.topk.scores.numpy(), baseline.topk.scores.numpy())
