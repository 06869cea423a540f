"""The port's AdaptiveScheduler and RetrievalServer against the reference's.

The cases of ``tests/test_scheduler.py``, plus deadline shedding and the
circuit breaker of ``tests/test_faults.py``. Each trace is built once with
numpy from a seed and handed to both packages: a reference engine
(``backend="xla"``) and the port's (``backend="torch"``, or ``"cuda"``
where the reference case runs its fused kernel; ``device="cpu"``) fitted on
the same array. Rows and queries are integers, so every score is exact and
the served answers must be bit-identical by ``rid``: values, indices, tier
and certificate. Plan labels are compared only where the trace makes them
independent of the measured service times (the latency and throughput
policies, or adaptive with no deadlines and gaps far above a dispatch).
"""
from __future__ import annotations

from collections import deque

import numpy as np
import pytest
import torch

from repro.api import SearchRequest as JRequest
from repro.core import ExactKNN as JExactKNN
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import FaultPlan as JFaultPlan
from repro.serving import AdaptiveScheduler as JScheduler
from repro.serving import RetrievalServer as JServer
from repro.store import DatasetStore as JStore
from repro_torch.api import SearchRequest
from repro_torch.core import ExactKNN, cache_info, clear_executable_cache
from repro_torch.faults import FaultError, FaultInjector, FaultPlan
from repro_torch.serving import AdaptiveScheduler, Request, RetrievalServer, bursty_requests
from repro_torch.store import DatasetStore

D = 32
#: the port's executor for each of the reference's
_EXEC = {"fdsq-xla": "fdsq-torch", "fqsd-xla": "fqsd-torch", "fqsd-int8": "fqsd-int8-torch"}


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _unit_scale_rows(rng, n, d):
    """Integer rows in [-127, 127] with one entry at ±127: int8 scale 1."""
    x = _ints(rng, (n, d), -127, 128)
    x[np.arange(n), rng.integers(0, d, n)] = 127.0 * rng.choice([-1.0, 1.0], n)
    return x


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    x = _ints(rng, (2000, D))
    x[1500] = x[3]  # an exact tie, broken to the smaller index
    return x


@pytest.fixture(scope="module")
def corpus8():
    return _unit_scale_rows(np.random.default_rng(40), 2000, D)


def _engines(x, int8=False, backend="torch", k=5, partitions=4):
    jeng = JExactKNN(k=k, n_partitions=partitions).fit(x)
    teng = ExactKNN(k=k, n_partitions=partitions, backend=backend, device="cpu").fit(x)
    if int8:
        jeng.enable_int8()
        teng.enable_int8()
    return jeng, teng


def _trace(rng, burst=40, trickle=6, gap_s=10.0, **opts):
    """One dense burst at t=0, then sparse arrivals far apart: the fields of
    each request (the same numpy rows go to both packages)."""
    reqs = [dict(queries=_ints(rng, D), rid=i, arrival_s=0.0, **opts) for i in range(burst)]
    reqs += [dict(queries=_ints(rng, D), rid=burst + j, arrival_s=gap_s * (j + 1), **opts)
             for j in range(trickle)]
    return reqs


def _serve(jsched, tsched, trace):
    """Serve the trace through both schedulers; answers by rid."""
    want = {r.rid: r for r in jsched.serve(iter([JRequest(**t) for t in trace]))}
    got = {r.rid: r for r in tsched.serve(iter([SearchRequest(**t) for t in trace]))}
    assert got.keys() == want.keys()
    return got, want


def _oracle(x, q, k):
    """Full-sort l2 kNN in float64 (exact on integer data), ties to the
    smaller index: the documented contract."""
    s = ((q[None, :].astype(np.float64) - x.astype(np.float64)) ** 2).sum(-1)
    return np.lexsort((np.arange(len(x)), s))[:k]


def _same(got, want, modes=True, x=None, trace=None):
    """Bit-identical values and indices by rid. With the corpus ``x`` and the
    ``trace``, indices tied with the last score may differ from the
    reference's: its plain FD-SQ merge (``lax.top_k``) can break a tie at
    the k boundary by position, so there the port must give the full-sort
    order of the oracle."""
    rows = {t["rid"]: t["queries"] for t in trace or ()}
    for rid, w in want.items():
        g = got[rid]
        v, i = g.scores.numpy(), g.indices.numpy()
        wv, wi = np.asarray(w.scores), np.asarray(w.indices)
        np.testing.assert_array_equal(v, wv, err_msg=f"rid {rid}")
        if x is None or not np.isfinite(wv[-1]):
            np.testing.assert_array_equal(i, wi, err_msg=f"rid {rid}")
        else:
            inside = wv < wv[-1]
            np.testing.assert_array_equal(i[inside], wi[inside], err_msg=f"rid {rid}")
            np.testing.assert_array_equal(i, _oracle(x, rows[rid], len(i)), err_msg=f"rid {rid}")
        assert isinstance(g.scores, torch.Tensor) and g.scores.device.type == "cpu"
        assert (g.tier, g.exact) == (w.tier, w.exact)
        if modes:
            assert (g.stats["mode"], g.batched) == (w.stats["mode"], w.batched), rid


def _same_stats(tsched, jsched, executors=True):
    ts, js = tsched.stats(), jsched.stats()
    for key in ("served", "deadline_misses", "shed", "mode_switches", "bytes_scanned",
                "transfers", "restarts", "policy", "dispatches", "circuit_breaker"):
        assert ts[key] == js[key], key
    assert ts["per_plan"].keys() == js["per_plan"].keys()
    for mode, j in js["per_plan"].items():
        t = ts["per_plan"][mode]
        for key in ("count", "tier", "certified_exact", "bytes_scanned"):
            assert t[key] == j[key], (mode, key)
        if executors:
            assert t["executors"] == [_EXEC[e] for e in j["executors"]]


class TestPolicies:
    @pytest.mark.parametrize("policy,modes", [("latency", {"fdsq"}), ("throughput", {"fqsd"}),
                                              ("adaptive", {"fdsq", "fqsd"})])
    def test_policy_routes_and_serves_the_reference_answers(self, corpus, policy, modes):
        rng = np.random.default_rng(1)
        jeng, teng = _engines(corpus)
        trace = _trace(rng)
        kw = dict(policy=policy, fdsq_max_batch=4, fqsd_min_depth=32)
        js, ts = JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw)
        got, want = _serve(js, ts, trace)
        _same(got, want, x=corpus, trace=trace)
        assert {r.mode for r in got.values()} == modes
        if policy == "latency":
            assert all(r.batched <= 4 for r in got.values())
        if policy == "adaptive":
            # the burst went through the throughput plan, the trickle did not
            assert all(r.mode == "fqsd" for r in got.values() if r.rid < 40)
            assert all(r.mode == "fdsq" for r in got.values() if r.rid >= 40)
            st = ts.stats()
            assert st["mode_switches"] >= 1
            assert st["per_plan"]["fqsd"]["executors"] == ["fqsd-torch"]
            assert st["served"] == 46 and len(got) == 46
        _same_stats(ts, js)

    def test_results_are_exact(self, corpus):
        """Scheduling must not change answers: dataset rows find themselves
        (row 3 has a duplicate at 1500 and must still find 3)."""
        jeng, teng = _engines(corpus)
        trace = [dict(queries=corpus[i], rid=i, arrival_s=0.0) for i in range(40)]
        kw = dict(policy="adaptive", fqsd_min_depth=32)
        got, want = _serve(JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw), trace)
        _same(got, want, x=corpus, trace=trace)
        for r in got.values():
            assert int(r.indices[0]) == r.rid

    def test_unknown_policy_rejected(self, corpus):
        _, teng = _engines(corpus[:256])
        with pytest.raises(ValueError):
            AdaptiveScheduler(teng, policy="bursty")


class TestDeadlines:
    @pytest.mark.parametrize("ema_s,deadline_ms,mode", [(0.5, 100.0, "fdsq"),
                                                         (0.001, 60_000.0, "fqsd")])
    def test_deadline_budget_decides(self, corpus, ema_s, deadline_ms, mode):
        jeng, teng = _engines(corpus[:256])
        rng = np.random.default_rng(5)
        rows = [_ints(rng, D) for _ in range(64)]
        decided = []
        for sched, req in ((JScheduler(jeng, policy="adaptive", fqsd_min_depth=2), JRequest),
                           (AdaptiveScheduler(teng, policy="adaptive", fqsd_min_depth=2),
                            SearchRequest)):
            sched._ema_s["fqsd"] = ema_s  # pretend the deep scan takes this long
            pending = deque(req(queries=v, rid=i, arrival_s=0.0, deadline_ms=deadline_ms)
                            for i, v in enumerate(rows))
            decided.append(sched.choose_mode(pending, clock_s=0.0))
        assert decided == [mode, mode]


class TestBatchBucketing:
    def test_arbitrary_depths_bound_executables(self, corpus):
        """Batches are padded to power-of-two buckets, so cache entries stay
        O(log max_batch), not O(depth), and padding rows never leak out."""
        rng = np.random.default_rng(8)
        _, teng = _engines(corpus)
        s = AdaptiveScheduler(teng, policy="throughput")
        clear_executable_cache()
        for depth in (3, 5, 6, 7):  # four odd depths, all bucket to 4 or 8
            reqs = [Request(i, _ints(rng, D), arrival_s=0.0) for i in range(depth)]
            assert len(list(s.serve(iter(reqs)))) == depth
        assert cache_info()["misses"] == 2  # buckets {4, 8}, nothing per depth
        assert {p.m for p in teng.plans[-4:]} == {4, 8}

    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    def test_padded_rows_do_not_change_answers(self, corpus, backend):
        jeng, teng = _engines(corpus, backend=backend)
        trace = [dict(queries=corpus[i], rid=i, arrival_s=0.0) for i in range(5)]  # pads to 8
        got, want = _serve(JScheduler(jeng, policy="throughput"),
                           AdaptiveScheduler(teng, policy="throughput"), trace)
        _same(got, want, x=corpus, trace=trace)
        for r in got.values():
            assert int(r.indices[0]) == r.rid
        assert teng.plans[-1].m == 8

    def test_tensor_rows_are_stacked_on_the_engine_device(self, corpus):
        """Requests may carry tensors: the batch is built as a tensor and the
        answers equal those of the same rows as numpy arrays."""
        _, teng = _engines(corpus)
        rng = np.random.default_rng(11)
        rows = [_ints(rng, D) for _ in range(6)]
        a = {r.rid: r for r in AdaptiveScheduler(teng, policy="throughput").serve(
            iter([SearchRequest(queries=v, rid=i) for i, v in enumerate(rows)]))}
        b = {r.rid: r for r in AdaptiveScheduler(teng, policy="throughput").serve(
            iter([SearchRequest(queries=torch.from_numpy(v)[None], rid=i)
                  for i, v in enumerate(rows)]))}
        for rid in a:
            assert torch.equal(a[rid].scores, b[rid].scores)
            assert torch.equal(a[rid].indices, b[rid].indices)


class TestRetrievalServerCompat:
    def test_wall_clock_latency_ignores_arrival_stamps(self, corpus):
        """The legacy server accounts service time only; arrival stamps must
        not produce negative latencies or suppress deadline misses."""
        rng = np.random.default_rng(10)
        jeng, teng = _engines(corpus)
        trace = [dict(queries=_ints(rng, D), rid=i, arrival_s=5.0, deadline_ms=1e-6)
                 for i in range(3)]
        js, ts = JServer(jeng, batch_window_s=0.0, max_batch=1), RetrievalServer(
            teng, batch_window_s=0.0, max_batch=1)
        got, want = _serve(js, ts, trace)
        _same(got, want, x=corpus, trace=trace)
        assert all(r.latency_ms > 0 for r in got.values())
        assert ts.stats()["deadline_misses"] == js.stats()["deadline_misses"] == 3

    def test_retrieval_server_rejects_unservable_pins(self, corpus):
        _, teng = _engines(corpus[:256], int8=True)
        srv = RetrievalServer(teng, max_batch=1)
        v = np.zeros(D, np.float32)
        for pin in (dict(tier="int8"), dict(mode_hint="fqsd")):
            with pytest.raises(ValueError, match="AdaptiveScheduler"):
                list(srv.serve(iter([SearchRequest(queries=v, **pin)])))

    def test_retrieval_server_groups_mixed_options(self, corpus):
        """A flush window mixing per-request k serves each request with ITS
        k, not the head's."""
        rng = np.random.default_rng(35)
        jeng, teng = _engines(corpus)
        trace = [dict(queries=_ints(rng, D), rid=i, k=3 if i % 2 else 5) for i in range(8)]
        got, want = _serve(JServer(jeng, batch_window_s=60.0, max_batch=8),
                           RetrievalServer(teng, batch_window_s=60.0, max_batch=8), trace)
        _same(got, want, x=corpus, trace=trace)
        for rid, r in got.items():
            assert len(r.indices) == (3 if rid % 2 else 5)


def test_bursty_requests_matches_the_reference():
    from repro.serving import bursty_requests as jbursty

    q = np.arange(40 * 4, dtype=np.float32).reshape(40, 4)
    got = [(r.rid, r.arrival_s, r.k) for r in bursty_requests(q, 16, 3, k=2)]
    want = [(r.rid, r.arrival_s, r.k) for r in jbursty(q, 16, 3, k=2)]
    assert got == want
    with pytest.raises(ValueError):
        next(bursty_requests(np.zeros((4, 8), np.float32), 0, 0))


class TestInt8TierRouting:
    def test_deep_backlog_routes_to_int8_with_certificates(self, corpus8):
        """The bandwidth-aware hook sends deep backlogs to the int8 tier;
        served results carry certificates and stats report bytes per tier."""
        jeng, teng = _engines(corpus8, int8=True)
        rng = np.random.default_rng(12)
        kw = dict(policy="adaptive", fqsd_min_depth=8, int8_min_depth=16)
        js, ts = JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw)
        trace = _trace(rng, burst=40, trickle=4)
        got, want = _serve(js, ts, trace)
        _same(got, want, x=corpus8, trace=trace)
        int8 = [r for r in got.values() if r.mode == "fqsd-int8"]
        assert int8 and all(r.exact for r in int8)
        assert all(r.executor == "fqsd-int8-torch" for r in int8)
        st = ts.stats()
        assert st["per_plan"]["fqsd-int8"]["certified_exact"] == 1.0
        per_pass = teng.store.nbytes("int8")
        assert st["bytes_scanned"]["int8"] > 0 and st["bytes_scanned"]["int8"] % per_pass == 0
        assert teng.store.nbytes("f32") == 4 * per_pass
        _same_stats(ts, js)

    def test_results_identical_across_tiers(self, corpus8):
        jeng, teng = _engines(corpus8, int8=True)
        trace = [dict(queries=corpus8[i], rid=i, arrival_s=0.0) for i in range(40)]
        kw = dict(policy="throughput", int8_min_depth=8)
        got, want = _serve(JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw), trace)
        _same(got, want, x=corpus8, trace=trace)
        for r in got.values():
            assert r.mode == "fqsd-int8" and int(r.indices[0]) == r.rid

    def test_deep_backlog_routes_to_fused_int8_on_cuda_backend(self, corpus8):
        """With backend='cuda' the hook lands deep backlogs on the int8 kernel
        (fqsd-int8-cuda; its plain version on the CPU), certified, with the
        kernel's pruning skip rate in stats(); answers equal the reference's
        int8 tier."""
        jeng, teng = _engines(corpus8[:1500], int8=True, backend="cuda")
        rng = np.random.default_rng(21)
        kw = dict(policy="throughput", int8_min_depth=8)
        trace = _trace(rng, burst=24, trickle=0)
        got, want = _serve(JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw), trace)
        _same(got, want, x=corpus8[:1500], trace=trace)
        assert {r.mode for r in got.values()} == {"fqsd-int8"}
        assert {r.executor for r in got.values()} == {"fqsd-int8-cuda"}
        st = AdaptiveScheduler(teng, **kw)
        list(st.serve(iter([SearchRequest(queries=corpus8[i], rid=i) for i in range(24)])))
        s = st.stats()
        assert s["per_plan"]["fqsd-int8"]["executors"] == ["fqsd-int8-cuda"]
        assert s["bytes_scanned"]["int8"] > 0
        assert 0.0 <= s["prune_skip_rate"] <= 1.0

    def test_tier_hook_disabled_by_default(self, corpus8):
        jeng, teng = _engines(corpus8, int8=True)
        rng = np.random.default_rng(13)
        trace = _trace(rng)
        got, want = _serve(JScheduler(jeng, policy="throughput"),
                           AdaptiveScheduler(teng, policy="throughput"), trace)
        _same(got, want, x=corpus8, trace=trace)
        assert {r.mode for r in got.values()} == {"fqsd"}  # no opt-in, no int8


class TestUniformStats:
    def test_f32_paths_report_tier_certified_and_bytes(self, corpus):
        rng = np.random.default_rng(30)
        jeng, teng = _engines(corpus)
        kw = dict(policy="adaptive", fqsd_min_depth=32)
        js, ts = JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw)
        _serve(js, ts, _trace(rng))
        st = ts.stats()
        assert set(st["per_plan"]) == {"fdsq", "fqsd"}
        for r in st["per_plan"].values():
            assert r["tier"] == ["f32"] and r["certified_exact"] == 1.0 and r["bytes_scanned"] > 0
        total = sum(r["bytes_scanned"] for r in st["per_plan"].values())
        assert total == st["bytes_scanned"]["f32"] and st["bytes_scanned"]["int8"] == 0
        _same_stats(ts, js)

    def test_int8_path_reports_same_keys(self, corpus8):
        rng = np.random.default_rng(31)
        jeng, teng = _engines(corpus8, int8=True)
        kw = dict(policy="throughput", int8_min_depth=8)
        js, ts = JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw)
        _serve(js, ts, _trace(rng, burst=24, trickle=0))
        r = ts.stats()["per_plan"]["fqsd-int8"]
        assert r["tier"] == ["int8"] and 0.0 <= r["certified_exact"] <= 1.0
        assert r["bytes_scanned"] == ts.stats()["bytes_scanned"]["int8"] > 0
        _same_stats(ts, js)


class TestPerRequestPins:
    @pytest.mark.parametrize("pin,int8,mode", [(dict(mode_hint="fdsq"), False, "fdsq"),
                                               (dict(tier="int8"), True, "fqsd-int8"),
                                               (dict(k=None), False, "fqsd")])
    def test_pins_beat_policy(self, corpus8, pin, int8, mode):
        """mode_hint='fdsq' wins over the throughput policy; tier='int8' is
        served with the hook disabled; per-request k splits batches."""
        rng = np.random.default_rng(32)
        jeng, teng = _engines(corpus8, int8=int8)
        trace = [dict(queries=_ints(rng, D), rid=i, arrival_s=0.0, **pin) for i in range(16)]
        if pin == dict(k=None):  # mixed options never batch together
            for t in trace:
                t["k"] = 3 if t["rid"] % 2 else 5
        js, ts = JScheduler(jeng, policy="throughput"), AdaptiveScheduler(teng, policy="throughput")
        got, want = _serve(js, ts, trace)
        _same(got, want, x=corpus8, trace=trace)
        assert {r.mode for r in got.values()} == {mode}
        if mode == "fdsq":
            assert all(r.batched <= ts.fdsq_max_batch for r in got.values())
        if "k" in pin:
            for rid, r in got.items():
                assert len(r.indices) == (3 if rid % 2 else 5)

    def test_conflicting_pins_and_multi_row_requests_rejected(self, corpus):
        _, teng = _engines(corpus[:256], int8=True)
        s = AdaptiveScheduler(teng, policy="throughput")
        bad = SearchRequest(queries=np.zeros(D, np.float32), rid=0, tier="int8",
                            mode_hint="fdsq")
        with pytest.raises(ValueError, match="fdsq"):
            list(s.serve(iter([bad])))
        with pytest.raises(ValueError, match="single-query"):
            list(s.serve(iter([SearchRequest(queries=np.zeros((2, D), np.float32), rid=0)])))


def test_dispatch_batch_matches_the_reference(corpus):
    """The live-batching entry point: expired requests shed, one decision
    for the rest, results in request order."""
    rng = np.random.default_rng(36)
    jeng, teng = _engines(corpus)
    trace = [dict(queries=_ints(rng, D), rid=i, arrival_s=0.0,
                  deadline_ms=1.0 if i % 3 == 0 else None) for i in range(6)]
    js, ts = JScheduler(jeng, policy="latency"), AdaptiveScheduler(teng, policy="latency")
    want = js.dispatch_batch([JRequest(**t) for t in trace], clock_s=1.0)
    got = ts.dispatch_batch([SearchRequest(**t) for t in trace], clock_s=1.0)
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(6))
    _same({r.rid: r for r in got}, {r.rid: r for r in want})
    assert ts.shed == js.shed == 2


class TestNoReflashingUnderScheduling:
    def test_mode_switches_hit_executable_cache(self, corpus):
        """Serving the same bursty trace twice: the second pass switches modes
        just as often but adds no cache entry."""
        rng = np.random.default_rng(7)
        _, teng = _engines(corpus)
        trace = [SearchRequest(**t) for t in _trace(rng)]
        s = AdaptiveScheduler(teng, policy="adaptive", fqsd_min_depth=32)
        clear_executable_cache()
        list(s.serve(iter(trace)))
        first = cache_info()
        assert first["misses"] >= 2  # at least one per logical configuration
        list(s.serve(iter(trace)))
        second = cache_info()
        assert second["misses"] == first["misses"] and second["hits"] > first["hits"]


class TestDeadlineShedding:
    @pytest.mark.parametrize("shed_expired", [True, False])
    def test_expired_requests(self, corpus, shed_expired):
        """shed_expired: the first dispatch runs, the rest have expired and
        are answered empty (inf, -1) and flagged; off, everything is served."""
        x = corpus[:256]
        jeng, teng = _engines(x, k=3, partitions=2)
        trace = [dict(queries=x[i], rid=i, arrival_s=0.0, deadline_ms=1e-6) for i in range(8)]
        kw = dict(policy="latency", fdsq_max_batch=4, shed_expired=shed_expired)
        js, ts = JScheduler(jeng, **kw), AdaptiveScheduler(teng, **kw)
        got, want = _serve(js, ts, trace)
        _same(got, want, x=x, trace=trace)
        shed = [r for r in got.values() if r.stats.get("shed")]
        assert len(shed) == (4 if shed_expired else 0) == ts.shed == js.shed
        for r in shed:
            assert r.stats["mode"] == "shed" and r.stats["health"]["shed"] is True
            assert (r.topk.indices == -1).all() and torch.isinf(r.topk.scores).all()
        st = ts.stats()
        assert st["health"]["shed"] == st["shed"] and st["deadline_misses"] == 8


class TestCircuitBreaker:
    def test_opens_serves_degraded_and_recovers(self, tmp_path):
        """Below the threshold a dead shard raises; at it the breaker trips and
        the dispatch is retried degraded; a failed probe keeps it open; once
        the disk heals the probe closes it. Both packages step alike."""
        x = _ints(np.random.default_rng(42), (512, 16))
        scheds, stores = [], []
        for pkg, (store_cls, eng_cls, sched_cls, inj, plan) in enumerate((
                (JStore, JExactKNN, JScheduler, JFaultInjector, JFaultPlan),
                (DatasetStore, ExactKNN, AdaptiveScheduler, FaultInjector, FaultPlan))):
            d = tmp_path / str(pkg)
            store_cls.from_array(x, rows_per_shard=128, directory=str(d))
            store = store_cls.open(str(d), verify_on_read=True)
            kw = dict(k=5, device_budget_bytes=1, retry_backoff_s=0.0, max_retries=0)
            if pkg:
                kw["device"] = "cpu"
            eng = eng_cls(**kw).fit_store(store)
            store.fault_injector = inj(plan(fail_shards=(0,), fail_tier="f32"))
            scheds.append(sched_cls(eng, policy="latency", breaker_threshold=2))
            stores.append(store)
        req = (JRequest, SearchRequest)

        def one(rid):
            return [list(s.serve([req[i](queries=x[rid], rid=rid, arrival_s=0.0)]))[0]
                    for i, s in enumerate(scheds)]

        for s in scheds:  # below the threshold strict semantics stay loud
            with pytest.raises(Exception) as err:
                list(s.serve([req[scheds.index(s)](queries=x[0], rid=0, arrival_s=0.0)]))
            assert "fail" in str(err.value)
        assert isinstance(err.value, FaultError)
        for rid, partial in ((1, True), (2, True)):  # tripped, then a failed probe
            want, got = one(rid)
            _same({rid: got}, {rid: want})
            assert got.stats["partial"] is want.stats["partial"] is partial
        for s in stores:  # the disk heals: the next probe closes the breaker
            s.fault_injector = None
        want, got = one(3)
        _same({3: got}, {3: want})
        assert not got.stats["partial"]
        jst, tst = scheds[0].stats(), scheds[1].stats()
        assert tst["circuit_breaker"] == jst["circuit_breaker"]
        assert not tst["circuit_breaker"]["open"] and tst["circuit_breaker"]["probes"] >= 2
        assert tst["health"]["failed_shards"] == jst["health"]["failed_shards"] == [0]
