"""The port's network front end (repro_torch.server) on the CPU.

Two parts. First, every case of ``tests/test_server.py`` against the
port's :class:`KnnServer` over a Router on the card's executors
(``backend="cuda", device="cpu"``: the kernels' plain versions), through
real sockets on an ephemeral port. Second, parity with the reference: the
same seeded numpy inputs sent to the reference's ``KnnServer`` over
``repro.api.Router`` and to the port's must give equal statuses and equal
JSON bodies (answers bit-equal on integer rows; only ``latency_ms`` and
``retry_after_ms`` are wall-clock and left out), and the codec pieces
(parse, responses, frames, admission verdicts) must agree byte for byte.

No pytest-asyncio: each test is a sync function around ``asyncio.run``.
Every scenario runs under ``asyncio.wait_for`` and every request of the
client helpers under its own, so a hang fails its own test and cannot
stall a test worker.
"""
from __future__ import annotations

import asyncio
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Router as JRouter
from repro.server import AdmissionController as JAdmission
from repro.server import KnnServer as JKnnServer
from repro.server import protocol as jprotocol
from repro.server.loadgen import Connection as JConnection
from repro.server.loadgen import LoadReport as JLoadReport
from repro_torch.api import Router, SearchRequest
from repro_torch.launch import serve
from repro_torch.server import (
    AdmissionController,
    KnnServer,
    ServerClosed,
    loadgen,
    protocol,
)
from repro_torch.server.loadgen import (
    Connection,
    LoadReport,
    closed_loop,
    stats_stream_probe,
)

ROOT = Path(__file__).resolve().parents[1]
#: seconds any one request of the client helpers may take
WAIT_S = 20.0
#: seconds any one scenario may take
SCENARIO_S = 60.0
PORT = dict(backend="cuda", device="cpu")


def _run(coro, timeout: float = SCENARIO_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _router(n=256, d=16, k=5, names=("docs",)):
    rng = np.random.default_rng(0)
    router = Router()
    for name in names:
        x = rng.standard_normal((n, d)).astype(np.float32)
        router.create(name, x, k=k, n_partitions=2, **PORT)
    return router


def _query(d=16, seed=1, **extra):
    rng = np.random.default_rng(seed)
    body = {"queries": rng.standard_normal(d).astype(np.float32).tolist()}
    body.update(extra)
    return body


class _Client:
    """The loadgen's persistent connection, each request under a timeout."""

    def __init__(self, address, conn_cls=Connection, report_cls=LoadReport):
        self.conn = conn_cls(*address, report_cls(mode="test", duration_s=1))

    async def request(self, method, path, payload=None, headers=None):
        return await asyncio.wait_for(
            self.conn.request(method, path, payload, headers=headers), WAIT_S)

    async def close(self):
        await asyncio.wait_for(self.conn.close(), WAIT_S)


async def _client(server):
    return _Client(server.address)


async def _raw_roundtrip(server, raw: bytes) -> tuple[int, bytes]:
    """Write raw bytes, read one full response (status, body)."""
    async def go():
        reader, writer = await asyncio.open_connection(*server.address)
        writer.write(raw)
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        n = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                n = int(line.split(b":", 1)[1])
        body = await reader.readexactly(n) if n else b""
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
        return status, body

    return await asyncio.wait_for(go(), WAIT_S)


def _post(path: str, body: bytes, extra_headers: str = "") -> bytes:
    return (f"POST {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n{extra_headers}\r\n"
            ).encode() + body


async def _wait_until(cond, timeout_s=5.0):
    t_end = time.perf_counter() + timeout_s
    while not cond() and time.perf_counter() < t_end:
        await asyncio.sleep(0.01)
    return cond()


# =================================================== the reference's cases
# --------------------------------------------------------------- round trip
def test_search_roundtrip_is_exact_over_the_wire():
    async def run():
        router = _router()
        async with KnnServer(router, port=0) as srv:
            conn = await _client(srv)
            body = _query(k=3, rid=7)
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/search", body)
            await conn.close()
            assert st == 200
            assert resp["rid"] == 7 and resp["shed"] is False
            assert len(resp["indices"]) == 3 == len(resp["scores"])
            # the network path returns the engine's exact answer
            direct = router.search("docs", SearchRequest(
                queries=np.asarray(body["queries"], np.float32), k=3))
            assert resp["indices"] == direct.topk.indices[0].tolist()
            assert resp["scores"] == direct.topk.scores[0].tolist()
    _run(run())


def test_keepalive_serves_many_requests_per_connection():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            conn = await _client(srv)
            for i in range(5):
                st, resp = await conn.request(
                    "POST", "/v1/collections/docs/search",
                    _query(seed=i, k=2, rid=i))
                assert st == 200 and resp["rid"] == i
            await conn.close()
            assert srv.connections == 1  # one socket served all five
    _run(run())


# ---------------------------------------------------------- boundary: 4xx
def test_malformed_json_is_400_and_connection_survives():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            st, body = await _raw_roundtrip(
                srv, _post("/v1/collections/docs/search", b"{not json"))
            assert st == 400
            assert b"error" in body
            conn = await _client(srv)
            st, _ = await conn.request(
                "POST", "/v1/collections/docs/search", _query())
            await conn.close()
            assert st == 200
    _run(run())


def test_oversized_body_is_413_before_reading_it():
    async def run():
        async with KnnServer(_router(), port=0, max_body_bytes=1024) as srv:
            st, body = await _raw_roundtrip(
                srv, _post("/v1/collections/docs/search", b"x" * 4096))
            assert st == 413
            assert b"1024" in body  # names the limit
    _run(run())


def test_unknown_collection_is_404_with_known_names():
    async def run():
        async with KnnServer(_router(names=("docs", "imgs")), port=0) as srv:
            conn = await _client(srv)
            st, resp = await conn.request(
                "POST", "/v1/collections/nope/search", _query())
            await conn.close()
            assert st == 404
            assert resp["collections"] == ["docs", "imgs"]
    _run(run())


#: the reference's validation cases, each a 400
VALIDATION_CASES = [
    _query(metric="hamming"),            # unknown metric
    _query(frobnicate=1),                # unknown field
    _query(deadline_ms=-5),              # negative deadline
    {"queries": [float("nan")] * 16},    # non-finite query
    {"queries": []},                     # empty query
    {"queries": [[0.1] * 16] * 4},       # multi-row batch
    _query(tenant=""),                   # empty tenant
    _query(tier="int8", mode_hint="fdsq"),  # incompatible pair
]


def test_validation_rejections_are_typed_400s():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            conn = await _client(srv)
            for body in VALIDATION_CASES:
                st, resp = await conn.request(
                    "POST", "/v1/collections/docs/search", body)
                assert st == 400, (body, resp)
                assert "error" in resp
            st, _ = await conn.request(
                "POST", "/v1/collections/docs/search", _query())
            await conn.close()
            assert st == 200
    _run(run())


def test_wrong_method_is_405():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            st, _ = await _raw_roundtrip(
                srv, b"GET /v1/collections/docs/search HTTP/1.1\r\n"
                     b"Host: t\r\nContent-Length: 0\r\n\r\n")
            assert st == 405
    _run(run())


# ------------------------------------------------------------ deadlines
def test_expired_deadline_returns_shed_envelope_over_the_wire():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            conn = await _client(srv)
            await conn.request("POST", "/v1/collections/docs/search", _query())
            # admit it cold (admission's deadline check would 429 it on the
            # warmed wait estimate); the scheduler then sheds it at dispatch
            srv.batchers["docs"]._ewma_dispatch_s = None
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/search",
                _query(deadline_ms=1e-3, rid=42))
            await conn.close()
            assert st == 200
            assert resp["shed"] is True and resp["rid"] == 42
            assert resp["scores"] == [] and resp["indices"] == []
            assert resp["certified"] is False
            assert srv.schedulers["docs"].shed >= 1
    _run(run())


def test_unmeetable_deadline_is_rejected_at_admission_with_retry_after():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            conn = await _client(srv)
            await conn.request("POST", "/v1/collections/docs/search", _query())
            batcher = srv.batchers["docs"]
            assert batcher.predicted_wait_s() > 0  # EWMA warmed
            batcher._ewma_dispatch_s = 10.0  # a deep backlog's wait
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/search", _query(deadline_ms=5.0))
            await conn.close()
            assert st == 429
            assert resp["reason"] == "deadline"
            assert resp["retry_after_ms"] > 0
            assert srv.admission.rejected["deadline"] == 1
            assert srv.admission.inflight == 0  # nothing leaked
    _run(run())


# -------------------------------------------------- disconnects and leaks
def _slowed(sched, delay_s):
    real = sched.dispatch_batch

    def slow(reqs, clock_s=None):
        time.sleep(delay_s)
        return real(reqs, clock_s)

    sched.dispatch_batch = slow


def test_mid_connection_disconnect_leaks_nothing():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            _slowed(srv.schedulers["docs"], 0.15)
            reader, writer = await asyncio.open_connection(*srv.address)
            body = json.dumps(_query()).encode()
            writer.write(_post("/v1/collections/docs/search", body))
            await writer.drain()
            assert await _wait_until(lambda: srv.admission.inflight == 1)
            writer.close()                 # client walks away mid-flight
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            assert await _wait_until(
                lambda: srv.admission.inflight == 0 and srv.connections == 0)
            conn = await _client(srv)
            st, _ = await conn.request(
                "POST", "/v1/collections/docs/search", _query())
            await conn.close()
            assert st == 200
    _run(run())


def test_queue_timeout_is_503_and_releases_the_slot():
    async def run():
        async with KnnServer(_router(), port=0, queue_timeout_ms=40.0) as srv:
            conn = await _client(srv)
            await conn.request("POST", "/v1/collections/docs/search", _query())
            _slowed(srv.schedulers["docs"], 0.2)  # past the 40 ms budget
            t0 = time.perf_counter()
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/search", _query())
            dt_ms = (time.perf_counter() - t0) * 1e3
            await conn.close()
            assert st == 503
            assert resp["reason"] == "queue_timeout"
            assert dt_ms < 150, f"timeout answered late: {dt_ms:.0f}ms"
            assert srv.admission.inflight == 0
    _run(run())


# ------------------------------------------------------------ multi-tenant
def test_concurrent_tenants_exceeding_quota_get_429():
    async def run():
        async with KnnServer(_router(), port=0, tenant_qps=3.0) as srv:
            async def tenant_storm(tenant):
                conn = await _client(srv)
                statuses = []
                for i in range(8):
                    st, resp = await conn.request(
                        "POST", "/v1/collections/docs/search",
                        _query(seed=i), headers={"X-Tenant": tenant})
                    if st == 429:
                        assert resp["reason"] == "rate_limit"
                        assert resp["retry_after_ms"] > 0
                    statuses.append(st)
                await conn.close()
                return statuses

            a, b = await asyncio.gather(
                tenant_storm("tenant-a"), tenant_storm("tenant-b"))
            for statuses in (a, b):
                assert statuses.count(200) >= 3   # the window's allowance
                assert statuses.count(429) >= 1   # the excess, rejected
                assert set(statuses) <= {200, 429}
            st = srv.admission.stats()
            assert st["inflight"] == 0
            assert st["tenants"]["tenant-a"]["rejected"] >= 1
            assert st["tenants"]["tenant-b"]["admitted"] >= 3
    _run(run())


def test_tenant_inflight_quota_rejects_second_concurrent_request():
    async def run():
        async with KnnServer(_router(), port=0, tenant_max_inflight=1) as srv:
            conn0 = await _client(srv)
            await conn0.request("POST", "/v1/collections/docs/search", _query())
            _slowed(srv.schedulers["docs"], 0.2)

            async def one(tenant, seed):
                conn = await _client(srv)
                st, resp = await conn.request(
                    "POST", "/v1/collections/docs/search",
                    _query(seed=seed), headers={"X-Tenant": tenant})
                await conn.close()
                return st, resp

            first = asyncio.create_task(one("hog", 1))
            assert await _wait_until(lambda: srv.admission.inflight == 1)
            st2, resp2 = await one("hog", 2)
            st3, _ = await one("polite", 3)
            st1, _ = await first
            await conn0.close()
            assert st1 == 200
            assert st2 == 429 and resp2["reason"] == "quota"
            assert st3 == 200  # other tenants unaffected
            assert srv.admission.inflight == 0
    _run(run())


# --------------------------------------------------- batching under load
def test_closed_loop_batches_across_connections():
    async def run():
        async with KnnServer(_router(n=512), port=0) as srv:
            rep = await closed_loop(
                *srv.address, "docs", connections=16, duration_s=1.5,
                d=16, k=5)
            assert rep.errors == 0 and rep.ok > 0
            sched = srv.schedulers["docs"]
            # continuous batching amortized dispatches
            assert sched.dispatches < sched.served
            assert sched.stats()["queue_depth"] == 0  # drained
    _run(run())


# -------------------------------------------------------------- stats/WS
def test_stats_and_healthz_report_live_counters():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            conn = await _client(srv)
            await conn.request("POST", "/v1/collections/docs/search", _query())
            st, stats = await conn.request("GET", "/stats")
            assert st == 200
            assert stats["schedulers"]["docs"]["served"] == 1
            assert stats["schedulers"]["docs"]["dispatches"] == 1
            assert "queue_depth" in stats["schedulers"]["docs"]
            assert stats["admission"]["admitted"] == 1
            assert stats["router"]["collections"]["docs"]["requests"] == 1
            st, health = await conn.request("GET", "/healthz")
            await conn.close()
            assert st == 200 and health["status"] == "ok"
            assert health["collections"]["docs"]["circuit_breaker"][
                "open"] is False
            assert len(srv.codec_ms["parse"]) == len(srv.codec_ms["encode"]) == 1
    _run(run())


def test_websocket_stats_stream_pushes_frames():
    async def run():
        async with KnnServer(_router(), port=0, stats_interval_ms=25.0) as srv:
            conn = await _client(srv)

            async def traffic():
                for i in range(4):
                    await conn.request(
                        "POST", "/v1/collections/docs/search", _query(seed=i))
                    await asyncio.sleep(0.03)

            frames, _ = await asyncio.gather(
                stats_stream_probe(*srv.address, 0.5, interval_ms=25.0),
                traffic())
            await conn.close()
            assert len(frames) >= 3
            assert frames[-1]["schedulers"]["docs"]["served"] >= 1
            served = [f["schedulers"]["docs"]["served"] for f in frames]
            assert served == sorted(served)  # counters are monotone
    _run(run())


# -------------------------------------------------------------- mutations
def test_upsert_then_search_then_delete_over_the_wire():
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            conn = await _client(srv)
            target = np.full(16, 2.5, np.float32)
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/upsert",
                {"vectors": [target.tolist()]})
            assert st == 200 and resp["count"] == 1
            [new_id] = resp["ids"]
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/search",
                {"queries": target.tolist(), "k": 1})
            assert st == 200 and resp["indices"] == [new_id]
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/delete", {"ids": [new_id]})
            assert st == 200 and resp["deleted"] == 1
            st, resp = await conn.request(
                "POST", "/v1/collections/docs/search",
                {"queries": target.tolist(), "k": 1})
            assert st == 200 and resp["indices"] != [new_id]
            st, _ = await conn.request(
                "POST", "/v1/collections/docs/upsert", {"vectors": "zz"})
            assert st == 400
            st, _ = await conn.request(
                "POST", "/v1/collections/docs/delete", {"ids": []})
            assert st == 400
            await conn.close()
    _run(run())


# ----------------------------------------------------------- unit: admission
def test_admission_sliding_window_and_recovery():
    t = [0.0]
    adm = AdmissionController(tenant_qps=2.0, window_s=1.0, clock=lambda: t[0])
    assert adm.try_admit("a").admitted
    assert adm.try_admit("a").admitted
    v = adm.try_admit("a")
    assert not v.admitted and v.reason == "rate_limit" and v.status == 429
    assert 0 < v.retry_after_s <= 1.0
    t[0] = 1.01  # the window slid: budget restored
    assert adm.try_admit("a").admitted
    assert adm.try_admit("b").admitted  # other tenants were never charged


def test_admission_deadline_and_capacity():
    adm = AdmissionController(max_inflight=2)
    assert adm.try_admit("a", deadline_ms=100.0, predicted_wait_s=0.01).admitted
    v = adm.try_admit("a", deadline_ms=100.0, predicted_wait_s=0.5)
    assert not v.admitted and v.reason == "deadline"
    assert adm.try_admit("a").admitted  # no deadline: fills capacity
    v = adm.try_admit("b")
    assert not v.admitted and v.reason == "capacity"
    adm.release("a")
    assert adm.try_admit("b").admitted
    with pytest.raises(ValueError):
        AdmissionController(max_inflight=0)
    with pytest.raises(ValueError):
        AdmissionController(tenant_qps=-1.0)


# ------------------------------------------------------------ unit: protocol
def test_protocol_websocket_frame_roundtrip():
    async def run():
        payload = json.dumps({"x": 1}).encode()
        for mask in (False, True):
            reader = asyncio.StreamReader()
            reader.feed_data(protocol.ws_frame(payload, mask=mask))
            reader.feed_eof()
            opcode, out = await protocol.ws_read_frame(reader)
            assert opcode == protocol.OP_TEXT and out == payload
        big = b"y" * 70000  # the extended 16-bit length path
        reader = asyncio.StreamReader()
        reader.feed_data(protocol.ws_frame(big, mask=True))
        reader.feed_eof()
        _, out = await protocol.ws_read_frame(reader)
        assert out == big
    _run(run())


def test_server_rejects_bad_constructor_knobs():
    router = _router()
    with pytest.raises(ValueError):
        KnnServer(router, queue_timeout_ms=0)
    with pytest.raises(ValueError):
        KnnServer(router, max_body_bytes=0)
    with pytest.raises(ValueError):
        KnnServer(router, stats_interval_ms=1)


def test_submit_after_stop_raises_server_closed():
    async def run():
        srv = KnnServer(_router(), port=0)
        await srv.start()
        await srv.stop()
        with pytest.raises(ServerClosed):
            srv.batchers["docs"].submit(
                SearchRequest(queries=np.zeros(16, np.float32), k=1))
    _run(run())


# ----------------------------------------------------------------- chaos
@pytest.mark.chaos
def test_fault_injected_shard_degrades_over_the_wire(tmp_path):
    """One persistently failing int8 shard under a live server: 200
    answers whose ``stats.health.degraded`` names the quarantined shard,
    bit-identical to the healthy answer."""
    from repro_torch.core import ExactKNN
    from repro_torch.faults import FaultInjector, FaultPlan
    from repro_torch.store import DatasetStore

    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    store = DatasetStore.from_array(x, rows_per_shard=128, directory=str(tmp_path))
    store.ensure_tier("int8")
    eng = ExactKNN(k=5, retry_backoff_s=0.0, **PORT).fit_store(
        DatasetStore.open(str(tmp_path), verify_on_read=True), resident=False)
    eng.enable_int8()
    router = Router()
    router.attach("vault", eng)

    async def run():
        async with KnnServer(router, port=0) as srv:
            conn = await _client(srv)
            q = rng.standard_normal(16).astype(np.float32).tolist()
            body = {"queries": q, "k": 5, "tier": "int8",
                    "allow_partial": True, "max_retries": 0}
            st, healthy = await conn.request(
                "POST", "/v1/collections/vault/search", body)
            assert st == 200 and healthy["tier"] == "int8"
            assert healthy["stats"]["health"]["degraded"] == []

            eng.store.fault_injector = FaultInjector(
                FaultPlan(fail_shards=(1,), fail_tier="int8"))
            st, degraded = await conn.request(
                "POST", "/v1/collections/vault/search", body)
            assert st == 200
            assert degraded["stats"]["health"]["degraded"] == [1]
            assert degraded["indices"] == healthy["indices"]
            assert degraded["scores"] == healthy["scores"]
            st, health = await conn.request("GET", "/healthz")
            await conn.close()
            assert health["collections"]["vault"]["health"]["degraded"] == [1]
    _run(run())


def test_compact_endpoint_over_the_wire(tmp_path):
    """POST .../compact folds the collection's store into a new generation
    over the wire (wait=true: the response reflects the swap); GET reads
    live status; the collection answers identically across the swap."""
    from repro_torch.store import DatasetStore

    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    DatasetStore.from_array(x, rows_per_shard=128, directory=str(tmp_path))
    store = DatasetStore.open(str(tmp_path))
    router = _router(names=("mem",))
    router.create("docs", store=store, k=5, n_partitions=2, **PORT)

    async def run():
        async with KnnServer(router, port=0) as srv:
            conn = await _client(srv)
            q = _query(k=3)
            await conn.request(
                "POST", "/v1/collections/docs/upsert",
                {"vectors": (np.asarray(q["queries"], np.float32)
                             + 1e-4).reshape(1, -1).tolist()})
            await conn.request("POST", "/v1/collections/docs/delete", {"ids": [7]})
            st, before = await conn.request(
                "POST", "/v1/collections/docs/search", q)
            assert st == 200

            st, status = await conn.request(
                "POST", "/v1/collections/docs/compact", {"wait": True})
            assert st == 200
            assert status["generation"] == 1
            assert status["compactions"] == 1 and status["error"] is None
            assert status["pending_delta"] == 0

            st, after = await conn.request(
                "POST", "/v1/collections/docs/search", q)
            assert st == 200
            assert after["indices"] == before["indices"]
            assert after["scores"] == before["scores"]
            assert after["indices"][0] == 300  # the upserted row kept its id

            st, got = await conn.request("GET", "/v1/collections/docs/compact")
            assert st == 200 and got["generation"] == 1
            st, stats = await conn.request("GET", "/stats")
            assert st == 200
            rstats = stats["router"]["collections"]
            assert rstats["docs"]["compaction"]["generation"] == 1
            assert rstats["mem"]["compaction"]["generation"] == 0
            st, health = await conn.request("GET", "/healthz")
            assert st == 200
            assert health["collections"]["docs"]["health"]["compaction"][
                "generation"] == 1
            st, got = await conn.request(
                "POST", "/v1/collections/mem/compact", {"wait": True})
            assert st == 200 and got["compactions"] == 1
            st, _ = await conn.request(
                "POST", "/v1/collections/docs/compact", [1])
            await conn.close()
            assert st == 400  # body must be a JSON object
    _run(run())


# ========================================= parity with the reference server
def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _pow2_rows(rng, n, d):
    """Rows of ±1 with 1, 4 or 16 nonzeros: norms 1, 2 or 4, so the cos
    normalisation is exact."""
    counts = rng.choice([1, 4, 16], n)
    ranks = rng.random((n, d)).argsort(1).argsort(1)
    return ((ranks < counts[:, None]) * rng.choice([-1.0, 1.0], (n, d))).astype(np.float32)


def _unit_scale_rows(rng, n, d):
    """Integer rows in [-127, 127] with one entry at ±127: int8 scale 1."""
    x = _ints(rng, (n, d), -127, 128)
    x[np.arange(n), rng.integers(0, d, n)] = 127.0 * rng.choice([-1.0, 1.0], n)
    return x


D = 32


def _routers(collections: dict, int8=()):
    """One reference and one port Router over the same arrays: name ->
    (rows, engine options). The reference scans each collection whole
    (``n_partitions=1``): its partition merge may break a tie at the k
    boundary by position, where the port keeps the smaller index."""
    jr, tr = JRouter(), Router()
    for name, (x, kw) in collections.items():
        jr.create(name, x, n_partitions=1, **kw)
        tr.create(name, x, n_partitions=4, **kw, **PORT)
        if name in int8:
            jr.engine(name).enable_int8()
            tr.engine(name).enable_int8()
    return jr, tr


def _wire(resp: dict) -> dict:
    """A response body less its wall-clock fields."""
    out = dict(resp)
    out.pop("retry_after_ms", None)
    if isinstance(out.get("stats"), dict):
        out["stats"] = {k: v for k, v in out["stats"].items() if k != "latency_ms"}
    return out


async def _both(jr, tr, calls, prepare=None, **server_kw):
    """Run the same (method, path, body, headers) calls, one at a time,
    against a reference and a port server; returns both answer lists."""
    out = []
    for server_cls, router, conn_cls, report_cls in (
            (JKnnServer, jr, JConnection, JLoadReport),
            (KnnServer, tr, Connection, LoadReport)):
        async with server_cls(router, port=0, **server_kw) as srv:
            if prepare is not None:
                prepare(srv)
            conn = _Client(srv.address, conn_cls, report_cls)
            answers = []
            for method, path, body, headers in calls:
                answers.append(await conn.request(method, path, body, headers))
            await conn.close()
            out.append(answers)
    return out


def _search_calls(name, queries, **opts):
    return [("POST", f"/v1/collections/{name}/search",
             {"queries": q.tolist(), "rid": i, **opts}, None)
            for i, q in enumerate(queries)]


def test_parity_search_over_the_wire_l2_ip_cos_and_filter():
    rng = np.random.default_rng(11)
    x, xp = _ints(rng, (600, D)), _pow2_rows(rng, 600, D)
    x[450] = x[3]  # an exact tie, broken to the smaller index
    q, qp = _ints(rng, (4, D)), _pow2_rows(rng, 4, D)
    q[0] = x[3]
    mask = rng.random(600) < 0.5
    jr, tr = _routers({"l2": (x, dict(k=7)), "ip": (x, dict(k=7, metric="ip")),
                       "cos": (xp, dict(k=7, metric="cos"))})
    calls = (_search_calls("l2", q) + _search_calls("ip", q) + _search_calls("cos", qp)
             + _search_calls("l2", q[:2], k=3, filter_mask=mask.tolist())
             + _search_calls("ip", q[2:], k=12, deadline_ms=60_000.0))
    want, got = _run(_both(jr, tr, calls))
    for (jst, jb), (tst, tb), call in zip(want, got, calls):
        assert jst == tst == 200, (call[1], jb, tb)
        assert _wire(jb) == _wire(tb), call[1]
        assert tb["mode"] == "fdsq" and tb["tier"] == "f32" and tb["certified"] is True
    masked = [b["indices"] for _, b in got[12:14]]
    assert all(mask[i] for row in masked for i in row)


def test_parity_int8_search_and_shed_envelope():
    rng = np.random.default_rng(12)
    x = _unit_scale_rows(rng, 600, D)
    q = _ints(rng, (3, D), -40, 41)
    q[0] = x[17]
    jr, tr = _routers({"v": (x, dict(k=5))}, int8=("v",))
    calls = (_search_calls("v", q, tier="int8")
             + [("POST", "/v1/collections/v/search",
                 {"queries": q[1].tolist(), "rid": 99, "deadline_ms": 1e-3}, None)])

    def cold(srv):  # admit the expired request; the scheduler sheds it
        real = srv.batchers["v"].predicted_wait_s
        srv.batchers["v"].predicted_wait_s = lambda: 0.0 if srv.batchers[
            "v"].dispatched_batches >= 3 else real()

    want, got = _run(_both(jr, tr, calls, prepare=cold))
    for (jst, jb), (tst, tb) in zip(want, got):
        assert jst == tst == 200
        assert _wire(jb) == _wire(tb)
    assert [b["tier"] for _, b in got[:3]] == ["int8"] * 3
    assert got[3][1]["shed"] is True and got[3][1]["scores"] == []


def test_parity_malformed_requests_same_status_and_error():
    rng = np.random.default_rng(13)
    x = _ints(rng, (300, 16))
    jr, tr = _routers({"docs": (x, dict(k=5))})
    search = "/v1/collections/docs/search"
    cases = [(_post(search, b"{not json"), None),
             (_post(search, b"x" * 4096), None),
             (b"GET /v1/collections/docs/search HTTP/1.1\r\nHost: t\r\n"
              b"Content-Length: 0\r\n\r\n", None),
             (_post("/v1/nothing/here", b"{}"), None),
             (_post(search, b'[1, 2]'), None)]
    cases += [(_post(search, json.dumps(body).encode()), None)
              for body in VALIDATION_CASES + [
                  _query(k=0), _query(tier="f16"), _query(mode_hint="fast"),
                  _query(max_retries=-1), _query(rid="seven"), _query(k=2.5),
                  _query(allow_partial="yes"), _query(filter_mask=[1.5, 2.0]),
                  _query(filter_mask=[True] * 5), _query(tier="int8"),
                  {"k": 3}, _query(deadline_ms=float("inf"))]]
    cases.append((_post("/v1/collections/nope/search", json.dumps(_query()).encode()), None))
    cases.append((_post("/v1/collections/docs/upsert", b'{"vectors": "zz"}'), None))
    cases.append((_post("/v1/collections/docs/delete", b'{"ids": []}'), None))
    cases.append((_post("/v1/collections/docs/delete", b'{"idz": [1]}'), None))
    cases.append((_post("/v1/collections/docs/compact", b"[1]"), None))

    async def run():
        out = []
        for server_cls, router in ((JKnnServer, jr), (KnnServer, tr)):
            async with server_cls(router, port=0, max_body_bytes=1024) as srv:
                out.append([await _raw_roundtrip(srv, raw) for raw, _ in cases])
        return out

    want, got = _run(run())
    for (jst, jb), (tst, tb), (raw, _) in zip(want, got, cases):
        assert jst == tst and jst >= 400, raw[:60]
        assert json.loads(jb) == json.loads(tb), raw[:60]


def test_parity_admission_rejections_same_reason():
    rng = np.random.default_rng(14)
    x = _ints(rng, (300, 16))
    q = _ints(rng, (4, 16))
    jr, tr = _routers({"docs": (x, dict(k=5))})
    calls = [("POST", "/v1/collections/docs/search", {"queries": v.tolist()},
              {"X-Tenant": "hot"}) for v in q]
    def frozen(srv):  # the window never slides, however long a call takes
        srv.admission._clock = lambda: 0.0

    want, got = _run(_both(jr, tr, calls, prepare=frozen, tenant_qps=2.0))
    assert [s for s, _ in want] == [s for s, _ in got] == [200, 200, 429, 429]
    for (_, jb), (_, tb) in zip(want, got):
        assert _wire(jb) == _wire(tb)


def test_parity_mutations_and_compaction_over_the_wire(tmp_path):
    from repro.store import DatasetStore as JStore
    from repro_torch.store import DatasetStore

    rng = np.random.default_rng(15)
    x = _ints(rng, (300, D))
    extra = _ints(rng, (5, D))
    q = np.concatenate([extra[:2], _ints(rng, (2, D))])
    jr, tr = JRouter(), Router()
    for i, (router, store_cls, kw) in enumerate(((jr, JStore, {}), (tr, DatasetStore, PORT))):
        d = tmp_path / f"s{i}"
        store_cls.from_array(x, rows_per_shard=128, directory=str(d))
        router.create("docs", store=store_cls.open(str(d)), k=5, n_partitions=2, **kw)
    calls = [("POST", "/v1/collections/docs/upsert", {"vectors": extra.tolist()}, None),
             ("POST", "/v1/collections/docs/delete", {"ids": [7, 301, 12]}, None)]
    calls += _search_calls("docs", q)
    calls += [("POST", "/v1/collections/docs/compact", {"wait": True}, None),
              ("GET", "/v1/collections/docs/compact", None, None)]
    calls += _search_calls("docs", q)
    want, got = _run(_both(jr, tr, calls))
    assert [s for s, _ in want] == [s for s, _ in got] == [200] * len(calls)
    assert want[0][1] == got[0][1] == {"ids": [300, 301, 302, 303, 304], "count": 5}
    assert want[1][1] == got[1][1] == {"deleted": 3}
    for (_, jb), (_, tb) in zip(want[2:6] + want[8:], got[2:6] + got[8:]):
        assert _wire(jb) == _wire(tb)
    assert got[2][1]["indices"][0] == 300
    for (_, jb), (_, tb) in zip(want[6:8], got[6:8]):
        for key in ("generation", "compactions", "pending_delta", "error", "running"):
            assert jb[key] == tb[key], key
    assert got[6][1]["generation"] == 1


@pytest.mark.parametrize("body", [
    _query(k=3, rid=4, metric="ip", tier="f32", mode_hint="fqsd", tenant="t1",
           deadline_ms=25, allow_partial=True, max_retries=2),
    {"queries": [[1.0, 2.0, 3.0]], "filter_mask": [1, 0, 1, 1]},
    {"queries": [1, 2, 3], "filter_mask": [True, False, True]},
    {"queries": [1, 2, 3], "filter_mask": [[True]]},
    {"queries": "abc"}, {"queries": [[1, 2], [3]]}, {"queries": [[[1.0]]]},
    {"queries": [1.0], "tenant": 5}, {"queries": [1.0], "metric": "l1"},
    {"queries": [1.0], "deadline_ms": True}, {"queries": [1.0], "deadline_ms": 0},
    {"queries": [1.0], "k": True}, {"queries": [1.0], "max_retries": -3},
    {"queries": [1.0], "tier": "int8", "mode_hint": "fdsq"},
    {"queries": [1.0], "mode_hint": "ring"}, {"queries": [1.0], "extra": 1, "more": 2},
    [1.0, 2.0], "queries",
])
def test_parity_parse_search_request(body):
    """Equal request fields, or the same BadRequest message."""
    def parse(mod):
        try:
            req, tenant = mod.parse_search_request(body, arrival_s=1.5, n_ids=4)
        except mod.BadRequest as e:
            return "error", e.message
        fields = {f: getattr(req, f) for f in (
            "k", "metric", "tier", "mode_hint", "deadline_ms", "allow_partial",
            "max_retries", "rid", "arrival_s")}
        mask = None if req.filter_mask is None else np.asarray(req.filter_mask).tolist()
        return np.asarray(req.queries).tolist(), str(np.asarray(req.queries).dtype), \
            mask, fields, tenant

    assert parse(protocol) == parse(jprotocol)


def test_parity_http_response_ws_frame_and_admission(monkeypatch):
    payloads = [None, b"\x00raw", {"a": [1, 2.5, float("inf")], "b": {"c": None}},
                {"x": np.arange(3, dtype=np.int64), "y": np.float32(0.5)}]
    for status in (200, 101, 429, 503, 599):
        for p in payloads:
            for kw in ({}, {"headers": {"Retry-After": "0.250"}, "close": True}):
                assert protocol.http_response(status, p, **kw) == \
                    jprotocol.http_response(status, p, **kw)
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(1, n + 1)))
    for data in (b"", "text", b"y" * 200, b"z" * 70000):
        for op in (protocol.OP_TEXT, protocol.OP_BINARY, protocol.OP_CLOSE, protocol.OP_PING):
            for mask in (False, True):
                assert protocol.ws_frame(data, op, mask) == jprotocol.ws_frame(data, op, mask)
    assert protocol.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        jprotocol.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==")

    t = [0.0]
    adms = [cls(max_inflight=3, tenant_qps=4.0, tenant_max_inflight=2, window_s=0.5,
                clock=lambda: t[0]) for cls in (AdmissionController, JAdmission)]
    seq = [[], []]
    rng = np.random.default_rng(16)
    for _ in range(60):
        tenant = f"t{rng.integers(3)}"
        op, wait, deadline = rng.integers(3), float(rng.random()), float(rng.random() * 900)
        t[0] += float(rng.random() * 0.1)
        for adm, out in zip(adms, seq):
            if op == 0:
                adm.release(tenant)
                out.append(adm.stats())
            else:
                out.append(adm.try_admit(tenant, deadline_ms=deadline, predicted_wait_s=wait))
    assert [v if isinstance(v, dict) else tuple(vars(v).values()) for v in seq[0]] == \
        [v if isinstance(v, dict) else tuple(vars(v).values()) for v in seq[1]]


# ========================================================= jsonable on torch
def test_jsonable_takes_cpu_tensors_of_any_rank():
    a = np.array([[1.5, -np.inf], [np.nan, np.inf], [0.0, -2.25]], np.float32)
    cases = [torch.from_numpy(a), torch.tensor([True, False]), torch.tensor(3, dtype=torch.int64),
             torch.tensor(np.float32(np.inf)), torch.tensor(True),
             torch.arange(6, dtype=torch.int64).reshape(1, 2, 3)]
    want = [[[1.5, None], [None, None], [0.0, -2.25]], [True, False], 3, None, True,
            [[[0, 1, 2], [3, 4, 5]]]]
    for t, w in zip(cases, want):
        got = protocol.jsonable({"v": t, "l": [t]})
        assert got == {"v": w, "l": [w]}
        assert json.dumps(got, allow_nan=False)
        if t.ndim:  # the reference's codec gives the same for the same array
            assert jprotocol.jsonable(t.numpy()) == w
    assert type(protocol.jsonable(torch.tensor(7, dtype=torch.int64))) is int
    assert type(protocol.jsonable(torch.tensor([True]))[0]) is bool
    # an f32 value survives float64 JSON and back unchanged
    vals = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    back = np.asarray(json.loads(json.dumps(protocol.jsonable(vals))), np.float32)
    assert np.array_equal(back.view(np.uint32), vals.numpy().view(np.uint32))


def test_jsonable_raises_on_a_tensor_not_on_the_cpu():
    with pytest.raises(TypeError, match="meta"):
        protocol.jsonable(torch.empty(3, device="meta"))
    with pytest.raises(TypeError):
        protocol.jsonable({"scores": [torch.zeros((), device="meta")]})


def test_device_tensor_in_an_answer_is_a_500_not_a_host_copy():
    """A dispatch that skipped its host copy reaches the codec with a
    non-CPU tensor: the ladder answers 500 and the server keeps serving."""
    async def run():
        async with KnnServer(_router(), port=0) as srv:
            sched = srv.schedulers["docs"]
            real = sched.dispatch_batch

            def on_device(reqs, clock_s=None):
                out = real(reqs, clock_s)
                return [type(r)(topk=type(r.topk)(r.topk.scores.to("meta"), r.topk.indices),
                                plan=r.plan, tier=r.tier, certified=r.certified,
                                stats=r.stats, rid=r.rid) for r in out]

            sched.dispatch_batch = on_device
            st, _ = await _raw_roundtrip(
                srv, _post("/v1/collections/docs/search", json.dumps(_query()).encode()))
            assert st == 500
            sched.dispatch_batch = real
            conn = await _client(srv)
            st, _ = await conn.request("POST", "/v1/collections/docs/search", _query())
            await conn.close()
            assert st == 200 and srv.admission.inflight == 0
    _run(run())


# ============================================================= entry points
LISTEN = ["--mode", "knn", "--n", "2000", "--d", "16", "--k", "5",
          "--listen", "127.0.0.1:0", "--policy", "adaptive"]


def test_serve_listen_builds_one_server_that_answers_on_the_cpu():
    server, x = serve.build_server(serve.parser().parse_args(LISTEN + ["--device", "cpu"]))
    assert isinstance(server, KnnServer) and server.address == ("127.0.0.1", 0)

    async def run():
        async with server:
            assert server.port != 0
            conn = await _client(server)
            st, health = await conn.request("GET", "/healthz")
            assert st == 200 and health["collections"]["default"]["queue_depth"] == 0
            st, resp = await conn.request(
                "POST", "/v1/collections/default/search", {"queries": x[5].tolist(), "k": 3})
            await conn.close()
            assert st == 200 and resp["indices"][0] == 5

    _run(run())


def test_serve_listen_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        serve.build_server(serve.parser().parse_args(LISTEN))
    with pytest.raises(RuntimeError):
        serve.main(LISTEN)
    with pytest.raises(RuntimeError):
        loadgen.main(["--selfhost", "--n", "256", "--d", "8", "--duration", "0.5"])


def test_serve_listen_cli_serves_until_interrupted():
    """``python -m repro_torch.launch.serve --listen 127.0.0.1:0 --device
    cpu`` prints its address, answers, and stops with exit 0 on SIGINT."""
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", *LISTEN, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        async def run():
            while True:
                line = await asyncio.wait_for(
                    asyncio.to_thread(proc.stdout.readline), WAIT_S)
                assert line, "the server exited before listening"
                found = re.search(r"on http://([\d.]+):(\d+)", line)
                if found:
                    break
            host, port = found.group(1), int(found.group(2))
            conn = _Client((host, port))
            st, _ = await conn.request("GET", "/healthz")
            assert st == 200
            st, resp = await conn.request(
                "POST", "/v1/collections/default/search", {"queries": [0.0] * 16})
            await conn.close()
            assert st == 200 and len(resp["indices"]) == 5

        _run(run())
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=WAIT_S)


def test_parser_takes_the_reference_listen_flags():
    ap = serve.parser()
    args = ap.parse_args(["--listen", "[::1]:8080", "--max-inflight", "9",
                          "--tenant-qps", "2.5", "--queue-timeout-ms", "40"])
    assert (args.listen, args.max_inflight, args.tenant_qps, args.queue_timeout_ms) == \
        (("[::1]", 8080), 9, 2.5, 40.0)
    for bad in (["--listen", "8080"], ["--listen", "h:99999"], ["--listen", "h:x"],
                ["--tenant-qps", "0"], ["--queue-timeout-ms", "inf"], ["--max-inflight", "0"]):
        with pytest.raises(SystemExit):
            ap.parse_args(bad)


def test_loadgen_selfhost_soak_on_the_cpu(capsys):
    rc = loadgen.main(["--selfhost", "--device", "cpu", "--n", "1024", "--d", "16",
                       "--connections", "8", "--duration", "1.5", "--deadline-ms", "5000"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "phase1 passages" in out and "phase2 (saturated)" in out
    assert re.search(r"stats stream: (\d+) frames", out)
