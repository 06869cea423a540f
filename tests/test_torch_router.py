"""The port's multi-collection Router against the reference's.

The cases of ``tests/test_router.py``: named engines over one shared
executable cache. The same numpy rows (integers, so every score is exact)
go to a reference Router (``backend="xla"``) and to the port's
(``backend="torch"``, ``device="cpu"``); answers must be bit-identical, and
the cache counters must move alike: two collections of one geometry share
entries, and mode switches and mutations across collections add none for
shapes already seen.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from repro.api import Router as JRouter
from repro.api import SearchRequest as JRequest
from repro.core import cache_info as jcache_info
from repro.core import clear_executable_cache as jclear
from repro.serving import AdaptiveScheduler as JScheduler
from repro.serving import bursty_requests as jbursty
from repro.store import DatasetStore as JStore
from repro_torch.api import Router, SearchRequest
from repro_torch.core import ExactKNN, cache_info, clear_executable_cache
from repro_torch.core import set_executable_cache_limit
from repro_torch.serving import AdaptiveScheduler, bursty_requests
from repro_torch.store import DatasetStore

D = 32
TKW = dict(device="cpu")


def _mk(rng, n=1280, d=D):
    return rng.integers(-4, 5, (n, d)).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _same(got, want):
    np.testing.assert_array_equal(got.scores.cpu().numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.indices.cpu().numpy(), np.asarray(want.indices))


def _both(xs: dict, k=5, **kw):
    """A reference and a port Router holding the same collections."""
    jr, tr = JRouter(), Router()
    for name, x in xs.items():
        jr.create(name, x, k=k, **kw)
        tr.create(name, x, k=k, **kw, **TKW)
    return jr, tr


class TestCollections:
    def test_create_attach_drop(self, rng):
        router = Router()
        router.create("a", _mk(rng), k=5, **TKW)
        eng = ExactKNN(k=5, **TKW).fit(_mk(rng))
        assert router.attach("b", eng) is eng
        assert router.collections() == ("a", "b") and list(router) == ["a", "b"]
        assert "a" in router and len(router) == 2
        assert router.engine("b") is eng
        router.drop("a")
        assert router.collections() == ("b",)

    def test_duplicate_and_unknown_names(self, rng):
        router = Router()
        router.create("a", _mk(rng), k=5, **TKW)
        with pytest.raises(ValueError, match="already exists"):
            router.create("a", _mk(rng), k=5, **TKW)
        with pytest.raises(KeyError, match="unknown collection"):
            router.search("zzz", SearchRequest(queries=np.zeros(D)))
        with pytest.raises(ValueError, match="fitted"):
            router.attach("c", ExactKNN(k=2, **TKW))
        with pytest.raises(ValueError):
            router.create("d")  # neither vectors nor store
        with pytest.raises(ValueError, match="non-empty"):
            router.create("", _mk(rng), k=5, **TKW)

    def test_devices_need_the_mesh(self, rng):
        """devices= places the collection on a ("data",) mesh of the group
        (logical devices may repeat; tests/test_torch_mesh_engine.py)."""
        router = Router()
        eng = router.create("a", _mk(rng), k=5, devices=["cpu"] * 2, **TKW)
        assert eng.mesh.shape == {"data": 2} and eng.mesh_axes == ("data",)
        assert router.stats()["collections"]["a"]["devices"] == ["cpu", "cpu"]

    def test_tensor_vectors_are_fitted_as_they_are(self, rng):
        """create(vectors=tensor) hands the tensor to fit (no numpy round trip)
        and answers as the numpy corpus does."""
        x = _mk(rng)
        jr, tr = _both({"a": x})
        tr.create("t", torch.from_numpy(x), k=5, **TKW)
        q = x[:8] + 1
        want = jr.search("a", JRequest(queries=q, mode_hint="fqsd"))
        for name in ("a", "t"):
            _same(tr.search(name, SearchRequest(queries=q, mode_hint="fqsd")), want)

    def test_store_backed_collection(self, rng, tmp_path):
        x = _mk(rng)
        res = []
        for i, (router, store_cls, req) in enumerate(((JRouter(), JStore, JRequest),
                                                      (Router(), DatasetStore, SearchRequest))):
            store = store_cls.from_array(x, rows_per_shard=512, directory=str(tmp_path / str(i)))
            kw = TKW if i else {}
            router.create("ooc", store=store, k=4, device_budget_bytes=4096, **kw)
            res.append(router.search("ooc", req(queries=x[7])))
        want, got = res
        assert got.plan.executor == want.plan.executor == "fqsd-mmap-streamed"
        assert int(got.indices[0, 0]) == 7
        _same(got, want)

    def test_per_collection_stats(self, rng):
        xs = {"a": _mk(rng), "b": _mk(rng)}
        q = _mk(rng, n=8)
        stats = []
        for router, req in zip(_both(xs), (JRequest, SearchRequest)):
            router.search("a", req(queries=q, mode_hint="fqsd"))
            router.search("a", req(queries=q[0]))
            router.search("b", req(queries=q, mode_hint="fqsd"))
            stats.append(router.stats())
        want, got = stats
        a = got["collections"]["a"]
        assert a["requests"] == 2 and a["queries"] == 9
        assert got["collections"]["b"]["requests"] == 1
        assert a["bytes_scanned"]["f32"] > 0 and a["tiers"] == ["f32"]
        assert got["executable_cache"] == cache_info()
        for name in xs:
            g, w = got["collections"][name], want["collections"][name]
            for key in ("requests", "queries", "bytes_scanned", "tiers", "n_rows", "devices",
                        "compaction"):
                assert g[key] == w[key], (name, key)


class TestSharedExecutableCache:
    def test_identical_shapes_share_cache_entries(self, rng):
        """Two collections of one geometry: the second collection's first
        query is a cache hit, in both packages."""
        jr, tr = _both({"a": _mk(rng), "b": _mk(rng)})
        q = _mk(rng, n=8)
        counts = []
        for router, req, clear, info in ((jr, JRequest, jclear, jcache_info),
                                         (tr, SearchRequest, clear_executable_cache, cache_info)):
            clear()
            router.search("a", req(queries=q, mode_hint="fqsd"))
            after_a = info()
            router.search("b", req(queries=q, mode_hint="fqsd"))
            after_b = info()
            assert after_a["misses"] == 1 and after_b["misses"] == after_a["misses"]
            assert after_b["hits"] == after_a["hits"] + 1
            counts.append((after_a["misses"], after_b["hits"] - after_a["hits"]))
        assert counts[0] == counts[1]

    def test_interleaved_mode_switches_and_upserts_never_recompile(self, rng):
        """FD-SQ/FQ-SD flips and mutations across two collections: after the
        warm-up pass no cache entry is added, and every answer equals the
        reference's."""
        xa, xb = _mk(rng), _mk(rng)
        q = _mk(rng, n=8)
        delta = _mk(rng, n=3) + 1
        jr, tr = _both({"a": xa, "b": xb})
        results = {0: [], 1: []}
        warm, after = [], []
        for pkg, (router, req, clear, info) in enumerate((
                (jr, JRequest, jclear, jcache_info),
                (tr, SearchRequest, clear_executable_cache, cache_info))):
            out = results[pkg]

            def traffic():
                for name in ("a", "b"):
                    out.append(router.search(name, req(queries=q, mode_hint="fqsd")))
                    out.append(router.search(name, req(queries=q[0], mode_hint="fdsq")))

            clear()
            traffic()
            ids = router.upsert("a", delta)  # warm the delta-merge step too
            router.upsert("b", delta)
            traffic()
            warm.append(info())
            for i in range(3):
                traffic()
                router.upsert("a", delta[i % 3])
                router.delete("b", [int(ids[0])])  # ids exist in b too
                traffic()
                router.upsert("b", delta[i % 3])
                ids = [int(ids[0]) + 1]
            after.append(info())
        for w, a in zip(warm, after):
            assert a["misses"] == w["misses"] and a["hits"] > w["hits"]
        assert warm[1]["misses"] >= 2
        for want, got in zip(*results.values()):
            np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))

    def test_cross_collection_upsert_visibility(self, rng):
        """Mutations stay collection-local: each collection sees only its own
        upserts."""
        jr, tr = _both({"a": _mk(rng), "b": _mk(rng)}, k=3)
        probe = _mk(rng, n=1)[0] + 5
        res = []
        for router, req in ((jr, JRequest), (tr, SearchRequest)):
            ids_a = router.upsert("a", probe)
            ra = router.search("a", req(queries=probe))
            rb = router.search("b", req(queries=probe))
            assert int(ra.indices[0, 0]) == int(ids_a[0])
            assert float(rb.scores[0, 0]) > float(ra.scores[0, 0])
            res.append((ra, rb))
        for want, got in zip(*res):
            _same(got, want)

    def test_cache_limit_constructor(self):
        try:
            Router(executable_cache_entries=7)
            assert cache_info()["max_entries"] == 7
        finally:
            set_executable_cache_limit(256)  # restore the process default


class TestRouterCompaction:
    def test_upsert_delete_compact_match_the_reference(self, rng):
        """Upserts and deletes through the Router, then compact(wait=True) and
        compact() in the background (joined with a timeout): answers equal
        the reference's at every step and the generation moves alike."""
        x = _mk(rng)
        q = _mk(rng, n=4) + 1
        jr, tr = _both({"a": x})
        for router, req in ((jr, JRequest), (tr, SearchRequest)):
            ids = router.upsert("a", q)
            router.delete("a", [int(ids[0]), 5])
        _same(tr.search("a", SearchRequest(queries=q)), jr.search("a", JRequest(queries=q)))
        status = [jr.compact("a", wait=True), tr.compact("a", wait=True)]
        assert status[1]["generation"] == status[0]["generation"] == 1
        _same(tr.search("a", SearchRequest(queries=q)), jr.search("a", JRequest(queries=q)))
        for router in (jr, tr):
            router.upsert("a", q[:1])
            done = router.compaction_status("a")["compactions"] + 1
            router.compact("a")  # on the store's background thread
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                st = router.compaction_status("a")
                if st["compactions"] >= done and not st["running"]:
                    break
                time.sleep(0.01)
            assert st["compactions"] == done and st["error"] is None, st
        _same(tr.search("a", SearchRequest(queries=q)), jr.search("a", JRequest(queries=q)))
        assert (tr.compaction_status("a")["generation"]
                == jr.compaction_status("a")["generation"])


class TestRouterServing:
    def test_scheduler_routes_through_router(self, rng):
        """AdaptiveScheduler(router=..., collection=...) serves through
        Router.search: per-collection stats accumulate and the answers equal
        the reference's by rid."""
        x = _mk(rng, n=2048)
        jr, tr = _both({"passages": x})
        js = JScheduler(policy="throughput", router=jr, collection="passages")
        ts = AdaptiveScheduler(policy="throughput", router=tr, collection="passages")
        want = {r.rid: r for r in js.serve(jbursty(x[:40], burst_size=40, trickle=0))}
        got = {r.rid: r for r in ts.serve(bursty_requests(x[:40], burst_size=40, trickle=0))}
        assert len(got) == 40 and all(int(r.indices[0]) == r.rid for r in got.values())
        for rid in want:
            _same(got[rid], want[rid])
        assert ts.stats()["collection"] == "passages"
        rs = tr.stats()["collections"]["passages"]
        assert rs["requests"] >= 1 and rs["queries"] == 64  # 40 padded to 64
        assert ts.stats()["health"]["compaction"] == js.stats()["health"]["compaction"]

    def test_scheduler_requires_collection_with_router(self, rng):
        router = Router()
        router.create("a", _mk(rng), k=5, **TKW)
        with pytest.raises(ValueError, match="collection"):
            AdaptiveScheduler(router=router)
        with pytest.raises(ValueError):
            AdaptiveScheduler()  # neither engine nor router
