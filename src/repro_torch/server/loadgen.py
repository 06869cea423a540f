"""Closed-/open-loop asyncio load generator for the HTTP front end.

Closed loop: N concurrent connections, each issuing its next request the
moment the previous answer lands — the classic saturation probe (achieved
qps = what the server actually sustains at concurrency N). Open loop:
requests fire on an arrival schedule regardless of completions — the
arrival shapes reuse :func:`repro_torch.serving.bursty_requests` (dense bursts +
sparse trickle), so the same workload the discrete-event replay exercises
drives the real socket path.

Both modes measure achieved qps, p50/p99 latency, shed/reject/error rates,
and deadline attainment; :func:`stats_stream_probe` rides a WebSocket
alongside to assert the dashboard channel stays live under load. The CLI
self-host mode boots a 2-collection router server in-process and runs the
acceptance soak (below saturation: p99 within deadline; past saturation:
graceful 429s, never a hang or crash).

    python -m repro_torch.server.loadgen --selfhost [--device cpu]
    python -m repro_torch.server.loadgen --port PORT --collection NAME

The port's copy of ``repro.server.loadgen``. The self-host server's
collections are built with ``backend="cuda"`` on the card; ``--device
cpu`` runs the kernels' plain versions instead, and without it a host with
no card raises (nothing answers from plain ops in its place). The client
side (everything but ``--selfhost``) touches no card.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
import time

import numpy as np

from repro_torch.server import protocol

__all__ = ["LoadReport", "Connection", "closed_loop", "open_loop",
           "stats_stream_probe"]


@dataclasses.dataclass
class LoadReport:
    """One load run's measurements."""

    mode: str
    duration_s: float
    sent: int = 0
    ok: int = 0
    shed: int = 0
    rejected: int = 0        # 429 (admission: rate limit / quota / deadline)
    timeouts: int = 0        # 503 queue timeouts
    errors: int = 0          # anything else non-200
    disconnects: int = 0
    partial: int = 0
    degraded: int = 0        # answers whose health.degraded was non-empty
    latencies_ms: list = dataclasses.field(default_factory=list)
    deadline_ms: float | None = None
    deadline_met: int = 0

    def observe(self, status: int, body: dict, latency_ms: float) -> None:
        self.sent += 1
        if status == 200 and not body.get("shed"):
            self.ok += 1
            self.latencies_ms.append(latency_ms)
            if body.get("partial"):
                self.partial += 1
            if body.get("stats", {}).get("health", {}).get("degraded"):
                self.degraded += 1
            if self.deadline_ms is not None and latency_ms <= self.deadline_ms:
                self.deadline_met += 1
        elif status == 200:
            self.shed += 1
        elif status == 429:
            self.rejected += 1
        elif status == 503:
            self.timeouts += 1
        else:
            self.errors += 1

    # ------------------------------------------------------------ summaries
    def percentile_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    @property
    def achieved_qps(self) -> float:
        return self.ok / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def reject_rate(self) -> float:
        return self.rejected / self.sent if self.sent else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.sent if self.sent else 0.0

    def summary(self) -> dict:
        out = {
            "mode": self.mode,
            "duration_s": round(self.duration_s, 3),
            "sent": self.sent, "ok": self.ok, "shed": self.shed,
            "rejected": self.rejected, "timeouts": self.timeouts,
            "errors": self.errors, "disconnects": self.disconnects,
            "partial": self.partial, "degraded": self.degraded,
            "achieved_qps": round(self.achieved_qps, 2),
            "p50_ms": round(self.percentile_ms(50), 3),
            "p99_ms": round(self.percentile_ms(99), 3),
            "shed_rate": round(self.shed_rate, 4),
            "reject_rate": round(self.reject_rate, 4),
        }
        if self.deadline_ms is not None:
            out["deadline_ms"] = self.deadline_ms
            out["deadline_attainment"] = round(
                self.deadline_met / self.ok, 4) if self.ok else 0.0
        return out


class Connection:
    """One persistent HTTP/1.1 client connection (reconnects on failure)."""

    def __init__(self, host: str, port: int, report: LoadReport):
        self.host, self.port = host, port
        self.report = report
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None

    async def _ensure_open(self) -> None:
        if self._writer is None or self._writer.is_closing():
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port)

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass
            self._writer = None

    async def request(self, method: str, path: str, payload=None,
                      headers: dict | None = None) -> tuple[int, dict]:
        """Issue one request; returns (status, body-dict)."""
        body = b"" if payload is None else json.dumps(payload).encode()
        head = [f"{method} {path} HTTP/1.1",
                f"Host: {self.host}:{self.port}",
                f"Content-Length: {len(body)}",
                "Content-Type: application/json"]
        for name, value in (headers or {}).items():
            head.append(f"{name}: {value}")
        raw = ("\r\n".join(head) + "\r\n\r\n").encode() + body
        try:
            await self._ensure_open()
            self._writer.write(raw)
            await self._writer.drain()
            status, resp = await _read_response(self._reader)
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            self.report.disconnects += 1
            await self.close()
            raise
        return status, resp


async def _read_response(reader: asyncio.StreamReader) -> tuple[int, dict]:
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ", 2)[1])
    n = 0
    for line in lines[1:]:
        if line.lower().startswith("content-length:"):
            n = int(line.split(":", 1)[1])
    body = await reader.readexactly(n) if n else b""
    payload = json.loads(body) if body else {}
    return status, payload


def _default_payload_fn(d: int, k: int, deadline_ms: float | None, seed=0):
    rng = np.random.default_rng(seed)

    def payload(i: int) -> dict:
        body = {"queries": rng.standard_normal(d).astype(np.float32).tolist(),
                "k": k, "rid": i}
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        return body

    return payload


# ------------------------------------------------------------- closed loop
async def closed_loop(
    host: str,
    port: int,
    collection: str,
    *,
    connections: int = 64,
    duration_s: float = 10.0,
    payload_fn=None,
    d: int = 32,
    k: int = 10,
    deadline_ms: float | None = None,
    tenant_fn=None,
    honor_retry_after: bool = True,
) -> LoadReport:
    """N workers, each one connection, each firing back-to-back requests
    for ``duration_s``. Rejected workers back off by the server's
    Retry-After (well-behaved clients) unless ``honor_retry_after=False``
    (adversarial saturation)."""
    report = LoadReport(mode="closed", duration_s=duration_s,
                        deadline_ms=deadline_ms)
    payload_fn = payload_fn or _default_payload_fn(d, k, deadline_ms)
    path = f"/v1/collections/{collection}/search"
    t_end = time.perf_counter() + duration_s

    async def worker(wid: int) -> None:
        conn = Connection(host, port, report)
        i = wid * 1_000_000
        try:
            while time.perf_counter() < t_end:
                headers = ({"X-Tenant": tenant_fn(wid)}
                           if tenant_fn is not None else None)
                t0 = time.perf_counter()
                try:
                    status, body = await conn.request(
                        "POST", path, payload_fn(i), headers=headers)
                except (ConnectionError, asyncio.IncompleteReadError,
                        OSError):
                    continue  # reconnect next iteration, already counted
                lat_ms = (time.perf_counter() - t0) * 1e3
                report.observe(status, body, lat_ms)
                i += 1
                if status == 429 and honor_retry_after:
                    retry_ms = float(body.get("retry_after_ms", 50.0))
                    await asyncio.sleep(min(retry_ms / 1e3, 1.0))
        finally:
            await conn.close()

    t0 = time.perf_counter()
    await asyncio.gather(*(worker(w) for w in range(connections)))
    report.duration_s = time.perf_counter() - t0
    return report


# --------------------------------------------------------------- open loop
async def open_loop(
    host: str,
    port: int,
    collection: str,
    *,
    n_requests: int = 512,
    burst_size: int = 64,
    trickle: int = 8,
    burst_gap_s: float = 0.25,
    trickle_gap_s: float = 0.02,
    d: int = 32,
    k: int = 10,
    deadline_ms: float | None = None,
    max_connections: int = 256,
) -> LoadReport:
    """Fire requests on the bursty arrival schedule regardless of
    completions (arrival shapes from ``serving.bursty_requests``); each
    in-flight request rides its own pooled connection."""
    from repro_torch.serving import bursty_requests

    rng = np.random.default_rng(1)
    vectors = rng.standard_normal((n_requests, d)).astype(np.float32)
    schedule = [
        (r.arrival_s, r.rid, np.asarray(r.queries))
        for r in bursty_requests(vectors, burst_size, trickle,
                                 burst_gap_s, trickle_gap_s)
    ]
    report = LoadReport(mode="open", duration_s=0.0, deadline_ms=deadline_ms)
    path = f"/v1/collections/{collection}/search"
    sem = asyncio.Semaphore(max_connections)
    t0 = time.perf_counter()

    async def fire(rid: int, vec: np.ndarray) -> None:
        async with sem:
            conn = Connection(host, port, report)
            body = {"queries": vec.tolist(), "k": k, "rid": rid}
            if deadline_ms is not None:
                body["deadline_ms"] = deadline_ms
            t_req = time.perf_counter()
            try:
                status, resp = await conn.request("POST", path, body)
            except (ConnectionError, asyncio.IncompleteReadError, OSError):
                return
            finally:
                await conn.close()
            report.observe(status, resp, (time.perf_counter() - t_req) * 1e3)

    tasks = []
    for arrival_s, rid, vec in schedule:
        delay = t0 + arrival_s - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(fire(rid, vec)))
    await asyncio.gather(*tasks)
    report.duration_s = time.perf_counter() - t0
    return report


# ---------------------------------------------------------- stats stream
async def stats_stream_probe(host: str, port: int, duration_s: float,
                             interval_ms: float = 100.0) -> list[dict]:
    """Ride the WebSocket stats stream for ``duration_s``; returns every
    received stats frame (callers assert liveness + content)."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((
        f"GET /v1/stats/stream?interval_ms={interval_ms:g} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        "Sec-WebSocket-Key: bG9hZGdlbi1wcm9iZQ==\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    ).encode())
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    if b" 101 " not in head.split(b"\r\n", 1)[0]:
        raise RuntimeError(f"WebSocket upgrade refused: {head[:80]!r}")
    frames: list[dict] = []
    t_end = time.perf_counter() + duration_s
    try:
        while time.perf_counter() < t_end:
            budget = t_end - time.perf_counter()
            try:
                opcode, payload = await asyncio.wait_for(
                    protocol.ws_read_frame(reader), timeout=max(budget, 0.01))
            except asyncio.TimeoutError:
                break
            if opcode == protocol.OP_TEXT:
                frames.append(json.loads(payload))
            elif opcode == protocol.OP_CLOSE:
                break
        writer.write(protocol.ws_frame(b"", opcode=protocol.OP_CLOSE,
                                       mask=True))
        await writer.drain()
    except (ConnectionError, protocol.ConnectionClosed):
        pass
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
    return frames


# ------------------------------------------------------------- CLI / soak
def _build_selfhost_server(args):
    """A 2-collection Router server for the self-contained soak, on the
    card's kernels (``--device cpu``: their plain versions; no card and no
    ``--device cpu`` raises)."""
    from repro_torch.api import Router
    from repro_torch.server.app import KnnServer

    rng = np.random.default_rng(0)
    router = Router()
    device = None if args.device == "cuda" else args.device
    for name in ("passages", "images"):
        x = rng.standard_normal((args.n, args.d)).astype(np.float32)
        router.create(name, x, k=args.k, n_partitions=4, backend="cuda",
                      device=device)
    return KnnServer(
        router, host=args.host, port=args.port,
        max_inflight=args.max_inflight,
        tenant_qps=args.tenant_qps,
        queue_timeout_ms=args.queue_timeout_ms,
        fqsd_min_depth=8,
    )


async def _soak(args) -> int:
    """Two-phase acceptance: (1) below saturation — measured p99 within
    the request deadline, zero non-graceful errors, stats stream live
    throughout; (2) past saturation (tight per-tenant rate limit) —
    non-zero graceful 429s, still zero errors/hangs."""
    server = _build_selfhost_server(args)
    async with server:
        host, port = server.address
        print(f"selfhost: listening on {host}:{port} "
              f"collections={list(server.router.collections())}")
        probe = asyncio.create_task(stats_stream_probe(
            host, port, args.duration + args.duration / 2 + 2.0))

        # phase 1: modest closed loop on both collections, no rate limit
        # pressure — p99 must clear the deadline
        reports = await asyncio.gather(*(
            closed_loop(host, port, name,
                        connections=args.connections // 2,
                        duration_s=args.duration, d=args.d, k=args.k,
                        deadline_ms=args.deadline_ms,
                        tenant_fn=lambda w: f"tenant-{w % 8}")
            for name in ("passages", "images")))
        ok = True
        for name, rep in zip(("passages", "images"), reports):
            s = rep.summary()
            print(f"phase1 {name}: {s}")
            if rep.errors or rep.ok == 0:
                print(f"FAIL: {name} saw {rep.errors} hard errors / "
                      f"{rep.ok} answers", file=sys.stderr)
                ok = False
            if (args.deadline_ms is not None
                    and rep.percentile_ms(99) > args.deadline_ms):
                print(f"FAIL: {name} p99 {rep.percentile_ms(99):.1f}ms "
                      f"over the {args.deadline_ms}ms deadline",
                      file=sys.stderr)
                ok = False

        # phase 2: saturate one tenant past its sliding-window budget —
        # the server must reject gracefully (429 + Retry-After), not hang
        server.admission.tenant_qps = args.saturate_tenant_qps
        rep2 = await closed_loop(
            host, port, "passages",
            connections=args.connections, duration_s=args.duration / 2,
            d=args.d, k=args.k, deadline_ms=args.deadline_ms,
            tenant_fn=lambda w: "hot-tenant",
            honor_retry_after=False)
        print(f"phase2 (saturated): {rep2.summary()}")
        if rep2.rejected == 0:
            print("FAIL: saturation phase produced zero 429s",
                  file=sys.stderr)
            ok = False
        if rep2.errors:
            print(f"FAIL: saturation phase saw {rep2.errors} hard errors",
                  file=sys.stderr)
            ok = False

        frames = await probe
        print(f"stats stream: {len(frames)} frames")
        if len(frames) < 2:
            print("FAIL: stats stream went silent during the soak",
                  file=sys.stderr)
            ok = False
        else:
            last = frames[-1]["schedulers"]["passages"]
            print(f"  last frame: served={last['served']} "
                  f"queue_depth={last['queue_depth']} "
                  f"breaker_open={last['circuit_breaker']['open']}")
    return 0 if ok else 1


async def _against(args) -> int:
    """Drive an already-running server (no asserts, just the report)."""
    rep = await closed_loop(
        args.host, args.port, args.collection,
        connections=args.connections, duration_s=args.duration,
        d=args.d, k=args.k, deadline_ms=args.deadline_ms)
    print(json.dumps(rep.summary(), indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="closed-/open-loop load generator for the kNN HTTP "
                    "front end")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--collection", default="passages")
    ap.add_argument("--connections", type=int, default=64)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--deadline-ms", type=float, default=1000.0)
    ap.add_argument("--n", type=int, default=8192,
                    help="selfhost corpus rows per collection")
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-inflight", type=int, default=1024)
    ap.add_argument("--tenant-qps", type=float, default=None)
    ap.add_argument("--queue-timeout-ms", type=float, default=None)
    ap.add_argument("--saturate-tenant-qps", type=float, default=25.0,
                    help="phase-2 per-tenant rate limit (the saturation "
                         "probe must draw 429s against it)")
    ap.add_argument("--selfhost", action="store_true",
                    help="boot a 2-collection router server in-process and "
                         "run the two-phase acceptance soak against it")
    ap.add_argument("--device", default="cuda",
                    help="--selfhost: device the collections live on: cuda "
                         "(the card's kernels; raises where there is no "
                         "card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.selfhost:
        return asyncio.run(_soak(args))
    if not args.port:
        ap.error("--port is required without --selfhost")
    return asyncio.run(_against(args))


if __name__ == "__main__":
    sys.exit(main())
