"""Out-of-core FQ-SD in the port against the reference: the double buffer,
the streamed f32 and int8 scans, and the streamed executors end to end.

Inputs are made with numpy from a seed and go through both packages on the
CPU (the port with ``device="cpu"``: its kernel steps run their plain
versions). A JAX ``DatasetStore`` of equal shards is carried into the port
with ``repro_torch.convert.store_from_numpy``, so both stream the identical
padded state. Integer data keeps every score exact: l2 and ip results must
be bit-identical (values, indices, tie order); cos agrees within the
reference's tolerance (rtol=1e-5, atol=1e-4; the two packages normalise in
another order). The int8 cases use integer rows whose largest entry is
±127, so every row's scale is exactly 1 and its bounds are exact in both
packages. The streamed int8 bound queue keeps the lexicographically
smallest indices among equal bounds, where the reference's ``lax.top_k``
may keep others, so bound steps are compared on their values.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.types import SearchRequest as JRequest
from repro.core import planner as jplanner
from repro.core.engine import ExactKNN as JExactKNN
from repro.core.fqsd import fqsd_streamed as jfqsd_streamed
from repro.core.fqsd import streamed_direct_scan as jstreamed_direct_scan
from repro.core.partition import iter_partitions as jiter_partitions
from repro.core.quantized import make_int8_bound_step as jmake_int8_bound_step
from repro.core.quantized import quantize_dataset as jquantize
from repro.store import DatasetStore as JStore
from repro_torch import ExactKNN, SearchRequest
from repro_torch.convert import padded_from_numpy, store_from_numpy
from repro_torch.core import executors as tex
from repro_torch.core import planner as tplanner
from repro_torch.core.fqsd import fqsd_streamed, make_partition_step, streamed_direct_scan
from repro_torch.core.partition import iter_partitions
from repro_torch.core.quantized import make_int8_bound_step, quantize_dataset
from repro_torch.core.streaming import (
    DoubleBufferedStream,
    ResilientShardSource,
    SpeculativeGather,
    prefetch_to_device,
)
from repro_torch.kernels.knn import kernel as K
from repro_torch.store import DatasetStore

N, D, ROWS, K_ = 3000, 96, 1024, 10  # 3 shards of 1024 rows, the last 952 valid
RTOL, ATOL = 1e-5, 1e-4
BACKENDS = ("torch", "cuda")


def _np(t):
    return np.asarray(t)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _unit_scale_rows(rng, n, d):
    """Integer rows in [-127, 127] with one entry at ±127: scale 1, error 0."""
    x = _ints(rng, (n, d), -127, 128)
    x[np.arange(n), rng.integers(0, d, n)] = 127.0 * rng.choice([-1.0, 1.0], n)
    return x


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    x = _ints(rng, (N, D))
    x[2100], x[2999] = x[12], x[12]  # exact ties across shards
    q = _ints(rng, (6, D))
    q[0] = x[12]
    return x, q, rng.random(N) > 0.3


@pytest.fixture(scope="module")
def int8_data():
    rng = np.random.default_rng(32)
    x = _unit_scale_rows(rng, N, D)
    x[1500], x[2500] = x[40], x[40]
    q = _ints(rng, (5, D), -40, 41)
    q[0] = x[40]
    return x, q


def _stores(x, int8=False):
    """A JAX store of equal shards, and the port's store over its arrays."""
    js = JStore.from_array(x, rows_per_shard=ROWS)
    if int8:
        js.ensure_tier("int8")
    return js, store_from_numpy(js)


def _engines(x, backend, int8=False, metric="l2", **kw):
    js, ts = _stores(x, int8)
    jeng = JExactKNN(k=K_, metric=metric, retry_backoff_s=0.0, **kw).fit_store(js, resident=False)
    teng = ExactKNN(k=K_, metric=metric, backend=backend, device="cpu", retry_backoff_s=0.0,
                    **kw).fit_store(ts, resident=False)
    if int8:
        jeng.enable_int8()
        teng.enable_int8()
    return jeng, teng


def _same_stats(got, want):
    for key in ("transfers", "restarts", "bytes_scanned", "partial"):
        assert got.stats[key] == want.stats[key], key
    # slow_shards is a wall-clock observation (a read slower than 4x the
    # running mean), not a result: every other health entry must agree
    g, w = dict(got.stats["health"]), dict(want.stats["health"])
    g.pop("slow_shards"), w.pop("slow_shards")
    assert g == w


# ------------------------------------------------------- the double buffer
def test_single_pass_order_and_transfers():
    items = [np.full((4,), i, np.float32) for i in range(5)]
    s = DoubleBufferedStream(items, depth=2, device="cpu")
    assert [int(x[0]) for x in s] == [0, 1, 2, 3, 4]
    assert s.transfers == 5


def test_restartable_source_reiterates():
    items = [np.full((2,), i, np.float32) for i in range(4)]
    s = DoubleBufferedStream(items, depth=3, device="cpu")
    first = [int(x[0]) for x in s]
    second = [int(x[0]) for x in s]
    assert first == second == [0, 1, 2, 3]
    assert s.transfers == 8 and s.restarts == 1


def test_one_shot_iterator_raises_instead_of_yielding_nothing():
    gen = (np.zeros((2,), np.float32) for _ in range(3))
    s = DoubleBufferedStream(gen, depth=2, device="cpu")
    assert len(list(s)) == 3
    with pytest.raises(RuntimeError, match="one-shot iterator"):
        list(s)


def test_partially_consumed_restartable_restarts_from_the_top():
    s = DoubleBufferedStream(list(range(6)), depth=2, put_fn=lambda x: x, device="cpu")
    it = iter(s)
    assert next(it) == 0 and next(it) == 1
    assert list(s) == [0, 1, 2, 3, 4, 5]  # fresh pass, not a resume


def test_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        DoubleBufferedStream([1, 2], depth=0, device="cpu")


def test_prefetch_to_device_alias():
    out = list(prefetch_to_device([np.ones(3, np.float32)], depth=2, device="cpu"))
    assert len(out) == 1 and isinstance(out[0], torch.Tensor)


def test_failed_put_is_retried_with_backoff_and_counted():
    calls = {"n": 0}

    def flaky_put(x):
        calls["n"] += 1
        if calls["n"] in (2, 3):  # the second item fails twice
            raise RuntimeError("transient transfer failure")
        return x

    health = {"retries": 0}
    items = [np.full(2, i, np.float32) for i in range(3)]
    s = DoubleBufferedStream(items, depth=2, put_fn=flaky_put, put_retries=2,
                             retry_backoff_s=0.001, health=health, device="cpu")
    assert [int(x[0]) for x in s] == [0, 1, 2]
    assert health["retries"] == 2 and s.transfers == 3

    def dead(x):
        raise RuntimeError("dead link")

    s = DoubleBufferedStream(items, depth=2, put_fn=dead, put_retries=1,
                             retry_backoff_s=0.0, health=health, device="cpu")
    with pytest.raises(RuntimeError, match="dead link") as err:
        list(s)
    assert err.value.shard_index == 0 and health["retries"] == 4 and s.transfers == 0


# ----------------------------------------------------- partitions and store
def test_iter_partitions_matches_reference(data):
    x = data[0]
    got = list(iter_partitions(x, ROWS))
    want = list(jiter_partitions(x, ROWS))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g.vectors, w.vectors)
        _same(g.norms, w.norms)
        assert (g.n_valid, g.base_index) == (w.n_valid, w.base_index)


def test_store_shards_match_reference(int8_data):
    x = int8_data[0]
    js = JStore.from_array(x, rows_per_shard=ROWS)
    js.ensure_tier("int8")
    ts = DatasetStore.from_array(x, rows_per_shard=ROWS)
    ts.ensure_tier("int8")
    assert (ts.n_shards, ts.rows_per_shard, ts.padded_dim) == (3, ROWS, 128)
    assert ts.meta(device_resident=False, tier="int8") == ts.meta(False, "int8")
    assert dataclasses.asdict(ts.meta(False, "int8")) == dataclasses.asdict(
        js.meta(False, "int8"))
    for i in range(3):
        for tier in ("f32", "int8"):
            for a, b in zip(ts.read_shard(i, tier), js.read_shard(i, tier)):
                _same(a, b) if hasattr(b, "shape") else None
                assert hasattr(b, "shape") or a == b
    for a, b in zip(ts.int8_resident(), js.int8_resident()):
        _same(a, b)
    ids = np.array([-1, 0, 1023, 1024, 2999, 3071, 3072, 5000])
    _same(ts.gather_rows(ids), js.gather_rows(ids))
    _same(ts.gather_rows(ids[::-1].copy()), js.gather_rows(ids[::-1].copy()))
    assert ts.delta_shards() == [] and not ts.is_mmap and not ts.is_pinned
    assert [p.base_index for p in ts.shard_source("f32")] == [0, 1024, 2048]
    assert len(list(ts.shard_source("int8"))) == 3


def test_store_from_numpy_carries_every_array(int8_data):
    js, ts = _stores(int8_data[0], int8=True)
    assert ts.n_shards == js.n_shards and ts.n_main == js.n_main
    for i, q8 in enumerate(js._int8):
        for a, b in zip(ts._int8[i], q8):
            _same(a, b)
    _same(ts.resident().vectors, js.resident().vectors)
    _same(ts.resident().norms, js.resident().norms)


# ------------------------------------------------------------- the scans
def _parts(x):
    """The reference's partitions, and the same arrays in the port."""
    jp = list(jiter_partitions(x, ROWS))
    return jp, [padded_from_numpy(p.vectors, p.norms, p.n_valid, p.base_index, device="cpu")
                for p in jp]


def _pad_q(q):
    return np.pad(q, ((0, 0), (0, 128 - q.shape[1])))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_fqsd_streamed_matches_reference(data, backend, metric):
    x, q, _ = data
    jp, tp = _parts(x)
    qp = _pad_q(q)
    want = jfqsd_streamed(jnp.asarray(qp), jp, K_, metric)
    stats: dict = {}
    got = fqsd_streamed(torch.from_numpy(qp), tp, K_, metric, stream_stats=stats,
                        step_fn=make_partition_step(K_, metric, backend))
    assert stats == {"transfers": 3, "restarts": 0}
    if metric == "cos":
        np.testing.assert_allclose(_np(got.scores), _np(want.scores), rtol=RTOL, atol=ATOL)
    else:
        _same(got.scores, want.scores)
        _same(got.indices, want.indices)


def test_streamed_direct_scan_matches_reference(data):
    x, q, _ = data
    jp, tp = _parts(x)
    qp = _pad_q(q)
    want = jstreamed_direct_scan(jnp.asarray(qp), jp, K_)
    got = streamed_direct_scan(torch.from_numpy(qp), tp, K_, prefetch_depth=1)
    _same(got.scores, want.scores)
    _same(got.indices, want.indices)


@pytest.mark.parametrize("backend", BACKENDS)
def test_int8_bound_step_matches_reference(int8_data, backend):
    x, q = int8_data
    r = 40
    jq = jquantize(jnp.asarray(np.pad(x, ((0, 72), (0, 32)))))
    tq = quantize_dataset(torch.from_numpy(np.pad(x, ((0, 72), (0, 32)))))
    for a, b in zip(tq, jq):
        _same(a, b)
    qp = _pad_q(q)
    jstep, tstep = jmake_int8_bound_step(r), make_int8_bound_step(r, backend)
    jlb = jnp.full((5, r + 1), jnp.inf)
    jli = jnp.full((5, r + 1), -1, jnp.int32)
    tlb = torch.full((5, r + 1), torch.inf)
    tli = torch.full((5, r + 1), -1, dtype=torch.int32)
    qnorm = tq.qnorm_sq.clone()
    qnorm[N:] = torch.inf
    for base in range(0, 3 * ROWS, ROWS):
        sl = slice(base, base + ROWS)
        jlb, jli = jstep(jlb, jli, jnp.asarray(qp), jq.q[sl], jq.scales[sl], jq.err[sl],
                         jnp.asarray(qnorm[sl].numpy()), base)
        tlb, tli = tstep(tlb, tli, torch.from_numpy(qp), tq.q[sl], tq.scales[sl], tq.err[sl],
                         qnorm[sl], base)
        _same(tlb, jlb)  # bounds equal; indices at boundary ties may differ
    assert ((tli >= 0) & (tli < N)).all()
    lower = np.sort(((qp[:, None, :] - np.pad(x, ((0, 0), (0, 32)))[None]) ** 2).sum(-1), -1)
    # scale 1, error 0: the bounds are the distances, up to sqrt and square
    np.testing.assert_allclose(_np(tlb), lower[:, : r + 1], rtol=1e-6)


# ------------------------------------------------------------- the engine
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_engine_f32_streamed_matches_reference(data, backend, metric):
    x, q, _ = data
    jeng, teng = _engines(x, backend, metric=metric)
    want = jeng.search(JRequest(queries=q))
    got = teng.search(SearchRequest(queries=q))
    assert got.plan.executor == want.plan.executor == "fqsd-mmap-streamed"
    assert got.plan.mode == want.plan.mode == "fqsd-streamed"
    if metric == "cos":
        np.testing.assert_allclose(_np(got.topk.scores), _np(want.topk.scores),
                                   rtol=RTOL, atol=ATOL)
    else:
        _same(got.topk.scores, want.topk.scores)
        _same(got.topk.indices, want.topk.indices)
    _same_stats(got, want)
    assert got.stats["transfers"] == 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_int8_streamed_matches_reference(int8_data, backend):
    x, q = int8_data
    jeng, teng = _engines(x, backend, int8=True)
    want = jeng.search(JRequest(queries=q, tier="int8"))
    got = teng.search(SearchRequest(queries=q, tier="int8"))
    assert got.plan.executor == want.plan.executor == "fqsd-int8-streamed"
    assert got.plan.mode == "fqsd-int8-streamed" and got.tier == "int8"
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)
    _same(got.certified, want.certified)
    _same_stats(got, want)
    assert got.stats["speculation"] == want.stats["speculation"]
    for key in ("scan_ms", "gather_ms", "rescore_ms"):
        assert got.stats[key] >= 0.0
    oracle = streamed_direct_scan(teng._pad_queries(q), teng.store.shard_source("f32"), K_)
    _same(got.topk.scores, oracle.scores)
    _same(got.topk.indices, oracle.indices)


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_streamed_equals_resident(data, backend):
    """On one store, the streamed search returns the resident one."""
    x, q, _ = data
    ts = DatasetStore.from_array(x, rows_per_shard=ROWS)
    res = ExactKNN(k=K_, backend=backend, device="cpu").fit_store(ts, resident=True)
    streamed = ExactKNN(k=K_, backend=backend, device="cpu").fit_store(ts, resident=False)
    want = res.search(SearchRequest(queries=q, mode_hint="fqsd"))
    got = streamed.search(SearchRequest(queries=q))
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_engine_streamed_filter_mask(data, int8_data, tier):
    x, q = (data[0], data[1]) if tier == "f32" else int8_data
    mask = data[2]
    jeng, teng = _engines(x, "cuda", int8=tier == "int8")
    want = jeng.search(JRequest(queries=q, tier=tier, filter_mask=mask))
    got = teng.search(SearchRequest(queries=q, tier=tier, filter_mask=mask))
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)
    assert mask[_np(got.topk.indices)].all()
    _same_stats(got, want)


def test_engine_uncertified_rows_take_the_streamed_fallback():
    """rescore_factor=1 with query 0's row stored 13 times: its (r+1)-th
    bound ties its k-th exact distance (0), the certificate fails and the
    streamed direct-form fallback answers that row; the others certify."""
    rng = np.random.default_rng(33)
    x = _unit_scale_rows(rng, 2000, 64)
    x[1500:1512] = x[0]  # twelve copies in the other shard
    q = x[:4] + 0.0
    jeng, teng = _engines(x, "cuda", int8=True, rescore_factor=1)
    want = jeng.search(JRequest(queries=q, tier="int8"))
    got = teng.search(SearchRequest(queries=q, tier="int8"))
    assert got.certified.tolist() == [False, True, True, True]
    _same(got.certified, want.certified)
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)
    _same_stats(got, want)
    assert got.stats["transfers"] == 4  # 2 int8 shards + 2 fallback f32 shards


def test_streamed_plans_match_reference():
    for tier, mmap in (("f32", False), ("int8", False), ("int8", True)):
        kw = dict(padded_rows=1048576, padded_dim=1024, n_valid=1000000, tier=tier,
                  rows_per_shard=65536, n_shards=16, resident=False, mmap=mmap)
        for backend, jbackend in (("torch", "xla"), ("cuda", "pallas")):
            tp = tplanner.plan((16, 1024), tplanner.DatasetStoreMeta(**kw),
                               tplanner.EngineConfig(k=1024, backend=backend), "fqsd")
            jp = jplanner.plan((16, 1024), jplanner.DatasetStoreMeta(**kw),
                               jplanner.EngineConfig(k=1024, backend=jbackend), "fqsd")
            got = dataclasses.asdict(tp)
            got["backend"] = jbackend
            assert got == dataclasses.asdict(jp)
            assert tp.executor in tex.list_executors()
    meta = dict(padded_rows=3000, padded_dim=128, n_valid=3000, resident=False)
    tp = tplanner.plan((4, 128), tplanner.DatasetMeta(**meta), tplanner.EngineConfig(k=3),
                       "fqsd-streamed", stream_rows=1024)
    jp = jplanner.plan((4, 128), jplanner.DatasetMeta(**meta), jplanner.EngineConfig(k=3),
                       "fqsd-streamed", stream_rows=1024)
    assert tp.executor == jp.executor == "fqsd-streamed" and tp.chunk_rows == 1024
    assert set(tplanner.PIPELINE_TUNABLE_EXECUTORS) <= set(jplanner.PIPELINE_TUNABLE_EXECUTORS)


@pytest.mark.parametrize("backend", BACKENDS)
def test_search_streamed_shim_runs_fqsd_streamed(data, backend):
    x, q, _ = data
    teng = ExactKNN(k=K_, backend=backend, device="cpu").fit(x[:10])
    with pytest.warns(DeprecationWarning):
        got = teng.search_streamed(q, x, rows_per_partition=ROWS)
    assert teng.plans[-1].executor == "fqsd-streamed"
    jeng = JExactKNN(k=K_).fit(x[:10])
    with pytest.warns(DeprecationWarning):
        want = jeng.search_streamed(q, x, rows_per_partition=ROWS)
    _same(got.scores, want.scores)
    _same(got.indices, want.indices)


# ------------------------------------------------------------- resilience
class _Flaky:
    """A store whose reads of given (shard, tier) fail a number of times
    (-1: always). It hides the reference store's ``snapshot``, so both
    engines read through this wrapper."""

    def __init__(self, store, fail: dict):
        self._store, self._fail = store, dict(fail)

    def __getattr__(self, name):
        if name == "snapshot":
            raise AttributeError(name)
        return getattr(self._store, name)

    def read_shard(self, i, tier="f32"):
        left = self._fail.get((i, tier), 0)
        if left:
            self._fail[(i, tier)] = left - 1
            raise OSError(f"flaky read of shard {i} ({tier})")
        return self._store.read_shard(i, tier)


def _flaky_engines(x, fail, **kw):
    js, ts = _stores(x, int8=True)
    mk = dict(k=K_, retry_backoff_s=0.0, max_retries=1)
    jeng = JExactKNN(**mk).fit_store(_Flaky(js, fail), resident=False)
    teng = ExactKNN(device="cpu", backend="cuda", **mk).fit_store(_Flaky(ts, fail),
                                                                  resident=False)
    return jeng, teng


def test_transient_shard_read_is_retried(int8_data):
    x, q = int8_data
    jeng, teng = _flaky_engines(x, {(1, "f32"): 1})
    want = jeng.search(JRequest(queries=q))
    got = teng.search(SearchRequest(queries=q))
    _same(got.topk.indices, want.topk.indices)
    assert got.stats["health"]["retries"] == 1
    _same_stats(got, want)


def test_dead_int8_shard_degrades_to_f32_exactly(int8_data):
    x, q = int8_data
    jeng, teng = _flaky_engines(x, {(2, "int8"): -1})
    want = jeng.search(JRequest(queries=q, tier="int8"))
    got = teng.search(SearchRequest(queries=q, tier="int8"))
    assert got.stats["health"]["degraded"] == [2]
    _same(got.topk.scores, want.topk.scores)
    _same(got.topk.indices, want.topk.indices)
    _same(got.certified, want.certified)
    _same_stats(got, want)
    oracle = streamed_direct_scan(teng._pad_queries(q), teng.store.shard_source("f32"), K_)
    _same(got.topk.scores, oracle.scores)
    _same(got.topk.indices, oracle.indices)


def test_dead_f32_shard_raises_or_goes_partial(int8_data):
    x, q = int8_data
    jeng, teng = _flaky_engines(x, {(1, "f32"): -1})
    with pytest.raises(OSError, match="shard 1") as err:
        teng.search(SearchRequest(queries=q))
    assert err.value.shard_index == 1
    want = jeng.search(JRequest(queries=q, allow_partial=True))
    got = teng.search(SearchRequest(queries=q, allow_partial=True))
    assert got.partial and got.stats["health"]["failed_shards"] == [1]
    assert not ((_np(got.topk.indices) >= ROWS) & (_np(got.topk.indices) < 2 * ROWS)).any()
    _same(got.topk.indices, want.topk.indices)
    _same_stats(got, want)


def test_resilient_source_notes_stragglers():
    """Shard 4 reads 20 clock units, the others 1: only shard 4 is over
    4x the EWMA. The source reads a fake clock that each read advances, so
    no scheduler of the host can flag another shard."""
    now = [0.0]

    class Slow:
        n_shards = 6

        def read_shard(self, i, tier):
            now[0] += 20.0 if i == 4 else 1.0
            return i

        def delta_shards(self):
            return []

    src = ResilientShardSource(Slow(), "f32", straggler_factor=4.0, clock=lambda: now[0])
    assert list(src) == list(range(6))
    assert src.health["slow_shards"] == [4]


# ------------------------------------------------------------- speculation
def test_speculation_triggers_are_bit_identical_and_never_rebuild(int8_data):
    x, q = int8_data
    _, teng = _engines(x, "cuda", int8=True)
    results = [teng.search(SearchRequest(queries=q, tier="int8", spec_trigger=t))
               for t in (0.0, 0.5, 1.0)]
    for r in results[1:]:
        _same(r.topk.scores, results[0].topk.scores)
        _same(r.topk.indices, results[0].topk.indices)
    assert results[0].stats["speculation"]["rows_speculated"] > 0
    assert results[2].stats["speculation"]["rows_speculated"] == 0
    misses = tex.cache_info()["misses"]
    for trigger in (0.0, 0.25, 0.5, 1.0):
        teng.search(SearchRequest(queries=q, tier="int8", spec_trigger=trigger,
                                  prefetch_depth=1 + int(4 * trigger)))
    assert tex.cache_info()["misses"] == misses


def test_speculative_gather_dedups_and_degrades():
    store = DatasetStore.from_array(np.arange(20, dtype=np.float32).reshape(10, 2),
                                    rows_per_shard=128)
    g = SpeculativeGather(torch.tensor([[3, 1, -1], [1, 7, 3]], dtype=torch.int32), store)
    ids, rows = g.result()
    assert ids.tolist() == [-1, 1, 3, 7]
    assert rows[:, :2].tolist() == [[0, 0], [2, 3], [6, 7], [14, 15]]

    class Broken:
        def gather_rows(self, ids):
            raise OSError("disk gone")

    bad = SpeculativeGather(torch.zeros((1, 2), dtype=torch.int32), Broken())
    assert bad.result() is None and isinstance(bad.error, OSError)


def test_launch_counters_untouched_on_cpu(data):
    x, q, _ = data
    _, teng = _engines(x, "cuda")
    K.reset_launch_counts()
    teng.search(SearchRequest(queries=q))
    assert sum(K.LAUNCHES.values()) == 0
