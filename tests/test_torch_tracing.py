"""repro_torch.runtime.tracing: spans and counters on the search path,
recorded only while a torch profiler records.

The serving path is driven as a live front end drives it: requests
submitted to a ``ContinuousBatcher`` on an event loop, dispatched on one
worker thread through ``AdaptiveScheduler`` into ``ExactKNN`` (the plain
``torch`` backend on the CPU, a small fit).
"""
from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import ExactKNN, SearchRequest
from repro_torch.core import engine as engine_mod
from repro_torch.core.partition import next_pow2
from repro_torch.runtime import tracing
from repro_torch.server.batching import ContinuousBatcher
from repro_torch.serving import retrieval
from repro_torch.serving.retrieval import AdaptiveScheduler

D = 16


@pytest.fixture(autouse=True)
def _empty_record():
    tracing.clear()
    yield
    tracing.clear()


def _engine(n: int = 512) -> ExactKNN:
    x = np.random.default_rng(0).integers(-8, 9, (n, D)).astype(np.float32)
    return ExactKNN(k=5, backend="torch", device="cpu").fit(x)


def _queries(m: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(-8, 9, (m, D)).astype(np.float32)


def _serve(sched: AdaptiveScheduler, queries: np.ndarray, waves: int = 3) -> list:
    """Submit ``queries`` to a batcher in ``waves`` bursts, each answered
    before the next is sent; the results."""
    async def run():
        pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="knn-dispatch")
        batcher = ContinuousBatcher(sched, pool)
        batcher.start()
        try:
            out = []
            for part in np.array_split(queries, waves):
                futs = [batcher.submit(SearchRequest(queries=q)) for q in part]
                out += await asyncio.wait_for(asyncio.gather(*futs), 60)
            return out
        finally:
            await batcher.stop()
            pool.shutdown(wait=True)

    return asyncio.run(run())


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _profiling() -> bool:
    """The flag every site reads."""
    return torch.autograd.profiler._is_profiler_enabled


def _by_name(spans) -> dict[str, list]:
    out: dict[str, list] = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_no_profiler_records_nothing_and_sites_get_the_shared_noop():
    sched = AdaptiveScheduler(_engine(), policy="latency")
    results = _serve(sched, _queries(24))
    assert len(results) == 24 and sched.dispatches >= 3
    assert tracing.spans() == [] and tracing.counters() == {}
    assert not _profiling()
    off = tracing.span("engine.search")
    assert off is tracing.span("scheduler.dispatch", 1.0) is tracing.handoff([None])
    assert not off
    with off as inside:
        assert inside is off
    assert tracing.begin("batcher.wait") is None
    tracing.count("scheduler.rows", 3)
    assert tracing.counters() == {}


def test_each_request_waits_once_under_the_dispatch_that_served_it():
    sched = AdaptiveScheduler(_engine(), policy="latency")
    with _cpu_profile():
        assert _profiling()
        results = _serve(sched, _queries(30))
    assert not _profiling()
    spans = tracing.spans()
    by = _by_name(spans)
    waits, dispatches = by["batcher.wait"], by["scheduler.dispatch"]
    assert len(results) == len(waits) == 30
    assert len({w.id for w in waits}) == 30
    assert all(w.request == w.id and w.end >= w.start for w in waits)
    served_by = {d.id: d for d in dispatches}
    assert len(dispatches) == sched.dispatches
    for w in waits:
        d = served_by[w.parent]
        # the wait ends as the dispatch's worker starts it, before its span
        assert w.start <= w.end <= d.start
    per_dispatch = {d.id: sum(w.parent == d.id for w in waits) for d in dispatches}
    assert all(per_dispatch[d.id] == d.attrs["rows"] for d in dispatches)
    for d in dispatches:
        assert d.parent is None and d.request == d.id
        assert d.attrs["padded_rows"] == next_pow2(d.attrs["rows"]) - d.attrs["rows"]
        assert d.attrs["mode"] in AdaptiveScheduler.MODES and d.attrs["tier"] == "f32"


def test_on_the_worker_dispatch_holds_search_holds_launch():
    sched = AdaptiveScheduler(_engine(), policy="latency")
    with _cpu_profile():
        _serve(sched, _queries(12))
    by = _by_name(tracing.spans())
    ids = {s.id: s for spans in by.values() for s in spans}
    dispatches = by["scheduler.dispatch"]
    assert len(by["engine.search"]) == len(by["executor.launch"]) == len(dispatches)
    assert len(by["scheduler.device_wait"]) == len(dispatches)
    for name, parent_name in (("engine.search", "scheduler.dispatch"),
                              ("scheduler.device_wait", "scheduler.dispatch"),
                              ("executor.launch", "engine.search")):
        for s in by[name]:
            p = ids[s.parent]
            assert p.name == parent_name
            assert p.start <= s.start <= s.end <= p.end
            assert s.thread == p.thread and s.request == p.request
    worker = {d.thread for d in dispatches}
    assert len(worker) == 1 and worker != {w.thread for w in by["batcher.wait"]}


def test_a_search_from_the_callers_thread_is_a_root():
    eng = _engine()
    with _cpu_profile():
        eng.search(SearchRequest(queries=_queries(16), mode_hint="fqsd"))
    search, launch = tracing.spans()[1], tracing.spans()[0]
    assert (search.name, launch.name) == ("engine.search", "executor.launch")
    assert search.parent is None and search.request == search.id
    assert launch.parent == search.id and launch.request == search.id


def test_counters_are_the_power_of_two_padding_of_each_dispatch():
    sched = AdaptiveScheduler(_engine(), policy="latency")
    sizes = [1, 3, 5, 8, 17, 2]
    q = _queries(sum(sizes))
    with _cpu_profile():
        i = 0
        for b in sizes:
            sched.dispatch_batch([SearchRequest(queries=v) for v in q[i:i + b]], clock_s=None)
            i += b
    assert tracing.counters() == {
        "scheduler.rows": sum(sizes),
        "scheduler.padded_rows": sum(next_pow2(b) - b for b in sizes),
    }
    rows = [s.attrs["rows"] for s in tracing.spans() if s.name == "scheduler.dispatch"]
    assert rows == sizes


def test_the_ring_keeps_its_bound_and_clear_empties_it():
    rec = tracing.Recorder(ring=8)
    with _cpu_profile():
        for i in range(20):
            with rec.span(f"s{i}"):
                pass
        rec.count("c", 2)
        rec.count("c", 3)
    assert [s.name for s in rec.spans()] == [f"s{i}" for i in range(12, 20)]
    assert rec.counters() == {"c": 5}
    assert tracing.RING == 1 << 20
    rec.clear()
    assert rec.spans() == [] and rec.counters() == {}


def test_a_counted_tensor_is_read_with_the_counters_and_recording_follows_the_profiler():
    rec = tracing.Recorder()
    assert not tracing.recording()
    rec.count("scan.survivors", torch.tensor(4))  # off: nothing kept
    with _cpu_profile():
        assert tracing.recording()
        survivors = torch.tensor([3, 4], dtype=torch.int32).sum()
        rec.count("scan.survivors", survivors)
        survivors += 100  # the count was summed into the counter's own tensor
        rec.count("scan.survivors", torch.tensor(5))
        rec.count("scan.lanes", 64)
        assert list(rec._unread) == ["scan.survivors"]  # one tensor a counter
    assert not tracing.recording()
    assert rec.counters() == {"scan.survivors": 12, "scan.lanes": 64}
    assert rec.counters() == {"scan.survivors": 12, "scan.lanes": 64}  # read once
    with _cpu_profile():
        rec.count("scan.survivors", torch.tensor(1))
    rec.clear()
    assert rec.counters() == {}


def test_the_per_search_logs_keep_their_last_values(monkeypatch):
    monkeypatch.setattr(engine_mod, "PLANS_KEPT", 3)
    monkeypatch.setattr(retrieval, "LATENCY_SAMPLES", 5)
    eng = _engine()
    sched = AdaptiveScheduler(eng, policy="latency")
    q = _queries(8)
    for m in (1, 2, 4, 8):
        eng.search(SearchRequest(queries=q[:m], mode_hint="fqsd"))
    assert [p.m for p in eng.plans] == [2, 4, 8] and isinstance(eng.plans, list)
    for v in q:
        sched.dispatch_batch([SearchRequest(queries=v)], clock_s=None)
    assert len(sched._lat_ms["fdsq"]) == 5
    st = sched.stats()["per_plan"]["fdsq"]
    assert st["count"] == 8 and np.isfinite(st["p50_ms"])
    assert torch.is_tensor(eng.search(SearchRequest(queries=q[0])).topk.scores)


def test_a_ring_search_records_its_steps_shipments_and_gather():
    """The FQ-SD ring on four logical CPU positions (``Router.create``'s
    ``devices``): a ``ring.step`` span a step, each but the last holding a
    ``ring.ship``; one ``mesh.gather``; the counters count the D - 1 = 3
    steps' shipments of 4 blocks, each its vectors and norms. Without a
    profiler nothing is recorded."""
    from repro_torch.api import Router

    x = np.random.default_rng(3).integers(-8, 9, (2048, D)).astype(np.float32)
    eng = Router().create("c", x, devices=["cpu"] * 4, k=5, backend="torch", device="cpu")
    req = SearchRequest(queries=_queries(8), mode_hint="fqsd")
    eng.search(req)
    assert tracing.spans() == [] and tracing.counters() == {}
    with _cpu_profile():
        res = eng.search(req)
    assert res.plan.executor == "fqsd-sharded"
    by = _by_name(tracing.spans())
    steps = by["ring.step"]
    assert [s.attrs for s in steps] == [{"step": s, "positions": 4} for s in range(4)]
    (launch,) = by["executor.launch"]
    assert all(s.parent == launch.id for s in steps)
    ships = by["ring.ship"]
    assert sorted(s.parent for s in ships) == [s.id for s in steps[:3]]
    (gather,) = by["mesh.gather"]
    assert gather.parent == launch.id and gather.start >= steps[-1].end
    vec, nrm = eng._ds.vectors, eng._ds.norms
    block = vec.local[0].nbytes + nrm.local[0].nbytes
    assert tracing.counters() == {"ring.blocks_shipped": 12, "ring.bytes_shipped": 12 * block}
