"""The asyncio network front end over :class:`repro_torch.api.Router`.

Endpoints (HTTP/1.1, persistent connections, JSON bodies):

    POST /v1/collections/<name>/search    one SearchRequest -> one result
    POST /v1/collections/<name>/upsert    {"vectors": [[...], ...]} -> ids
    POST /v1/collections/<name>/delete    {"ids": [...]} -> count
    POST /v1/collections/<name>/compact   fold delta+tombstones; {"wait": true}
    GET  /v1/collections/<name>/compact   compaction status (generation, ...)
    GET  /healthz                         liveness + per-collection health
    GET  /stats                           schedulers + admission + router
    GET  /v1/stats/stream                 WebSocket: pushed stats frames

Request lifecycle — the degradation ladder end to end:

    parse (4xx at the boundary) -> admission (per-tenant sliding-window
    rate limit / quota / server capacity / deadline feasibility -> 429 +
    Retry-After) -> bounded queue (continuous batcher; queue-timeout ->
    503) -> scheduler dispatch (expired requests shed with the documented
    shed envelope; per-collection circuit breaker degrades repeated
    storage failures) -> response.

The admission slot is acquired before enqueue and released in the handler
``finally`` — disconnects, timeouts, and engine errors can never leak it.
Engine dispatch runs on ONE shared worker thread (the compiled-executable
cache and the engines are single-threaded by design); the event loop
itself only parses, admits, and streams, so thousands of connections ride
one accelerator dispatch stream.

The port's copy of ``repro.server.app``: the same endpoints, status codes,
error texts and ladder. Differences:

- The dispatch worker binds the card the collections live on as its
  current CUDA device when it starts (the current device and stream are
  per thread in PyTorch). Its kernels launch on that thread's current
  stream, and the scheduler copies every answer to the host there, so the
  event loop only ever sees CPU tensors (``protocol.jsonable`` raises on
  any other). Mutations and ``compact {"wait": true}`` run on the same
  worker; ``compact {}`` starts the store's own compactor thread, which
  works on the card beside it.
- ``codec_ms`` keeps the host time of the last 4,096 searches' parse (body
  JSON to :class:`SearchRequest`) and encode (result to response bytes),
  in ms, for measurement; nothing on the wire changes.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.faults import FaultError
from repro_torch.serving.retrieval import AdaptiveScheduler
from repro_torch.server import protocol
from repro_torch.server.admission import AdmissionController
from repro_torch.server.batching import ContinuousBatcher, ServerClosed

__all__ = ["KnnServer"]

log = logging.getLogger("repro_torch.server")

#: searches whose parse and encode times ``KnnServer.codec_ms`` keeps
CODEC_SAMPLES = 4096


class KnnServer:
    """Serve a :class:`repro_torch.api.Router` over HTTP + WebSocket.

    Usage::

        server = KnnServer(router, host="127.0.0.1", port=8080,
                           max_inflight=512, tenant_qps=200.0)
        async with server:                 # starts listening
            await server.serve_forever()

    One :class:`AdaptiveScheduler` + :class:`ContinuousBatcher` pair per
    collection; all pairs share one admission controller and one dispatch
    worker thread. Scheduler knobs (policy, int8_min_depth, ...) apply to
    every collection's scheduler.
    """

    def __init__(
        self,
        router,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        policy: str = "adaptive",
        fdsq_max_batch: int = 4,
        fqsd_min_depth: int = 32,
        max_batch: int = 256,
        int8_min_depth: int | None = None,
        max_inflight: int | None = 512,
        tenant_qps: float | None = None,
        tenant_max_inflight: int | None = None,
        queue_timeout_ms: float | None = None,
        max_body_bytes: int = protocol.MAX_BODY_BYTES_DEFAULT,
        stats_interval_ms: float = 500.0,
    ):
        if queue_timeout_ms is not None and queue_timeout_ms <= 0:
            raise ValueError(
                f"queue_timeout_ms must be > 0, got {queue_timeout_ms}")
        if max_body_bytes < 1:
            raise ValueError(
                f"max_body_bytes must be >= 1, got {max_body_bytes}")
        if stats_interval_ms < 10:
            raise ValueError(
                f"stats_interval_ms must be >= 10, got {stats_interval_ms}")
        self.router = router
        self.host = host
        self.port = port
        self.queue_timeout_ms = queue_timeout_ms
        self.max_body_bytes = int(max_body_bytes)
        self.stats_interval_ms = float(stats_interval_ms)
        self.admission = AdmissionController(
            max_inflight=max_inflight,
            tenant_qps=tenant_qps,
            tenant_max_inflight=tenant_max_inflight,
        )
        # ONE dispatch worker: the executor layer's compiled-executable
        # cache is shared, unlocked state — all collections serialize on it.
        # It makes the collections' card its current device before its
        # first dispatch (CUDA's current device is per thread)
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="knn-dispatch",
            initializer=_bind_device, initargs=(_card_of(router),))
        self.schedulers: dict[str, AdaptiveScheduler] = {}
        self.batchers: dict[str, ContinuousBatcher] = {}
        for name in router.collections():
            self.schedulers[name] = AdaptiveScheduler(
                router=router, collection=name, policy=policy,
                fdsq_max_batch=fdsq_max_batch,
                fqsd_min_depth=fqsd_min_depth, max_batch=max_batch,
                int8_min_depth=int8_min_depth,
            )
        self._server: asyncio.base_events.Server | None = None
        self._ws_streams = 0
        self.connections = 0
        self.codec_ms = {"parse": deque(maxlen=CODEC_SAMPLES),
                         "encode": deque(maxlen=CODEC_SAMPLES)}

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        for name, sched in self.schedulers.items():
            batcher = ContinuousBatcher(sched, self._executor)
            batcher.start()
            self.batchers[name] = batcher
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> tuple[str, int]:
        return self.host, self.port

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for batcher in self.batchers.values():
            await batcher.stop()
        self._executor.shutdown(wait=True)

    async def __aenter__(self) -> "KnnServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ------------------------------------------------------------ connection
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """One connection: keep-alive request loop, typed error answers,
        never an unhandled exception out of here."""
        self.connections += 1
        try:
            while True:
                try:
                    req = await protocol.read_http_request(
                        reader, max_body_bytes=self.max_body_bytes)
                except protocol.ConnectionClosed:
                    return
                except protocol.ProtocolError as e:
                    writer.write(protocol.http_response(
                        e.status, {"error": e.message}, close=e.close))
                    await writer.drain()
                    if e.close:
                        return
                    continue
                try:
                    done = await self._route(req, reader, writer)
                except (ConnectionResetError, BrokenPipeError):
                    return  # peer vanished mid-response
                except protocol.ProtocolError as e:
                    writer.write(protocol.http_response(
                        e.status, {"error": e.message}, close=e.close))
                    await writer.drain()
                    done = e.close
                except Exception:
                    # last line of defense: answer 500, keep serving others
                    log.exception("unhandled error serving %s %s",
                                  req.method, req.path)
                    writer.write(protocol.http_response(
                        500, {"error": "internal server error"}, close=True))
                    await writer.drain()
                    done = True
                if done or not req.keep_alive:
                    return
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            self.connections -= 1
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _route(self, req: protocol.HttpRequest,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> bool:
        """Dispatch one request; returns True when the connection is done
        (WebSocket sessions own the connection until close)."""
        path = req.path
        if path == "/healthz":
            await self._respond(writer, 200, self._healthz())
            return False
        if path == "/stats":
            await self._respond(writer, 200, self._stats())
            return False
        if path == "/v1/stats/stream":
            await self._stats_stream(req, reader, writer)
            return True
        if path.startswith("/v1/collections/"):
            rest = path[len("/v1/collections/"):]
            name, _, action = rest.partition("/")
            if not name or not action:
                raise _not_found(path)
            if name not in self.router:
                writer.write(protocol.http_response(404, {
                    "error": f"unknown collection {name!r}",
                    "collections": list(self.router.collections()),
                }))
                await writer.drain()
                return False
            if action == "search":
                _require_post(req)
                await self._search(name, req, writer)
                return False
            if action == "upsert":
                _require_post(req)
                await self._upsert(name, req, writer)
                return False
            if action == "delete":
                _require_post(req)
                await self._delete(name, req, writer)
                return False
            if action == "compact":
                await self._compact(name, req, writer)
                return False
        raise _not_found(path)

    async def _respond(self, writer, status, payload, headers=None) -> None:
        writer.write(protocol.http_response(status, payload, headers=headers))
        await writer.drain()

    # ----------------------------------------------------------------- search
    async def _search(self, name: str, req: protocol.HttpRequest,
                      writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        engine = self.router.engine(name)
        t0 = time.perf_counter()
        request, tenant = protocol.parse_search_request(
            req.json(), arrival_s=loop.time(), n_ids=engine.n_ids)
        self.codec_ms["parse"].append((time.perf_counter() - t0) * 1e3)
        if request.n_queries() > 1:
            # the continuous batcher IS the batching layer (same contract
            # as AdaptiveScheduler): one query per request, the server
            # amortizes the scan across tenants
            raise protocol.BadRequest(
                "send one query per request (the server batches for you); "
                f"got {request.n_queries()} rows"
            )
        tenant = req.headers.get("x-tenant", tenant)
        batcher = self.batchers[name]
        verdict = self.admission.try_admit(
            tenant, deadline_ms=request.deadline_ms,
            predicted_wait_s=batcher.predicted_wait_s())
        if not verdict.admitted:
            retry_after = max(verdict.retry_after_s, 1e-3)
            await self._respond(
                writer, verdict.status,
                {"error": f"admission rejected: {verdict.reason}",
                 "reason": verdict.reason,
                 "retry_after_ms": retry_after * 1e3},
                headers={"Retry-After": f"{retry_after:.3f}"})
            return
        try:
            fut = batcher.submit(request)
            timeout = (None if self.queue_timeout_ms is None
                       else self.queue_timeout_ms / 1e3)
            try:
                result = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                # wait_for cancelled the future: the batcher drops it at
                # batch-formation time, so the dispatch slot is never spent
                await self._respond(
                    writer, 503,
                    {"error": "request timed out in the serving queue",
                     "reason": "queue_timeout",
                     "retry_after_ms": self.queue_timeout_ms},
                    headers={"Retry-After":
                             f"{self.queue_timeout_ms / 1e3:.3f}"})
                return
            except ServerClosed as e:
                await self._respond(writer, 503, {"error": str(e)})
                return
            except FaultError as e:
                # unrecoverable storage fault under strict semantics (the
                # breaker below threshold stays loud by contract)
                await self._respond(writer, 503, {
                    "error": str(e), "reason": "storage_fault",
                    "shard": getattr(e, "shard_id", -1)})
                return
            except (ValueError, TypeError) as e:
                # engine-level validation the boundary could not see
                # (e.g. int8 tier never enabled on this collection)
                await self._respond(writer, 400, {"error": str(e)})
                return
            t0 = time.perf_counter()
            response = protocol.http_response(
                200, protocol.encode_result(result))
            self.codec_ms["encode"].append((time.perf_counter() - t0) * 1e3)
            writer.write(response)
            await writer.drain()
        finally:
            self.admission.release(tenant)

    # ------------------------------------------------------------- mutations
    async def _upsert(self, name: str, req: protocol.HttpRequest,
                      writer: asyncio.StreamWriter) -> None:
        payload = req.json()
        if not isinstance(payload, dict) or "vectors" not in payload:
            raise protocol.BadRequest("upsert body must be "
                                      '{"vectors": [[...], ...]}')
        try:
            vec = np.asarray(payload["vectors"], dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise protocol.BadRequest(
                f"'vectors' is not a numeric array: {e}") from None
        if vec.ndim == 1:
            vec = vec[None, :]
        if vec.ndim != 2 or vec.size == 0 or not np.all(np.isfinite(vec)):
            raise protocol.BadRequest(
                f"'vectors' must be a non-empty finite (n, d) matrix, got "
                f"shape {vec.shape}")
        loop = asyncio.get_running_loop()
        try:
            # mutations share the dispatch worker: they serialize with
            # searches, so a search never observes a half-applied upsert
            ids = await loop.run_in_executor(
                self._executor, self.router.upsert, name, vec)
        except (ValueError, TypeError) as e:
            raise protocol.BadRequest(str(e)) from None
        await self._respond(writer, 200,
                            {"ids": np.asarray(ids), "count": len(ids)})

    async def _delete(self, name: str, req: protocol.HttpRequest,
                      writer: asyncio.StreamWriter) -> None:
        payload = req.json()
        if not isinstance(payload, dict) or "ids" not in payload:
            raise protocol.BadRequest('delete body must be {"ids": [...]}')
        try:
            ids = np.asarray(payload["ids"], dtype=np.int64)
        except (TypeError, ValueError) as e:
            raise protocol.BadRequest(
                f"'ids' is not an integer array: {e}") from None
        if ids.ndim != 1 or ids.size == 0:
            raise protocol.BadRequest(
                f"'ids' must be a non-empty flat list, got shape {ids.shape}")
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(
                self._executor, self.router.delete, name, ids)
        except (ValueError, TypeError, KeyError, IndexError) as e:
            raise protocol.BadRequest(str(e)) from None
        await self._respond(writer, 200, {"deleted": int(ids.size)})

    # ------------------------------------------------------------- compaction
    async def _compact(self, name: str, req: protocol.HttpRequest,
                       writer: asyncio.StreamWriter) -> None:
        """POST triggers compaction of the collection's store; GET reads its
        status. The default trigger is asynchronous (the store's own
        background compactor thread — searches keep streaming their pinned
        generation, so the endpoint returns immediately with the live
        status); ``{"wait": true}`` runs it to completion on the dispatch
        worker (admin tooling, tests) so the response reflects the swap."""
        if req.method == "GET":
            await self._respond(writer, 200,
                                self.router.compaction_status(name))
            return
        _require_post(req)
        payload = req.json() if req.body else {}
        if not isinstance(payload, dict):
            raise protocol.BadRequest(
                'compact body must be a JSON object, e.g. {} or '
                '{"wait": true}')
        wait = bool(payload.get("wait", False))
        loop = asyncio.get_running_loop()
        try:
            if wait:
                # share the dispatch worker: the drain-and-swap then
                # serializes with mutations exactly like upsert/delete
                status = await loop.run_in_executor(
                    self._executor, self.router.compact, name, True)
            else:
                status = self.router.compact(name, False)
        except (ValueError, RuntimeError) as e:
            raise protocol.BadRequest(str(e)) from None
        await self._respond(writer, 200, status)

    # ----------------------------------------------------------------- stats
    def _healthz(self) -> dict:
        out = {"status": "ok", "collections": {}}
        for name, sched in self.schedulers.items():
            st = sched.stats()
            out["collections"][name] = {
                "queue_depth": st["queue_depth"],
                "shed": st["shed"],
                "health": st["health"],
                "circuit_breaker": st["circuit_breaker"],
            }
        return out

    def _stats(self) -> dict:
        return {
            "server": {
                "connections": self.connections,
                "ws_streams": self._ws_streams,
                "queue_timeout_ms": self.queue_timeout_ms,
            },
            "admission": self.admission.stats(),
            "schedulers": {name: sched.stats()
                           for name, sched in self.schedulers.items()},
            "batchers": {name: b.stats()
                         for name, b in self.batchers.items()},
            "router": self.router.stats(),
        }

    async def _stats_stream(self, req: protocol.HttpRequest,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        """WebSocket: push scheduler health / phase / breaker stats until
        the client closes. ``?interval_ms=`` overrides the push period."""
        if req.headers.get("upgrade", "").lower() != "websocket":
            raise protocol.BadRequest(
                "/v1/stats/stream requires a WebSocket upgrade")
        key = req.headers.get("sec-websocket-key")
        if not key:
            raise protocol.BadRequest("missing Sec-WebSocket-Key")
        interval_s = self.stats_interval_ms / 1e3
        if "interval_ms" in req.query:
            try:
                interval_ms = float(req.query["interval_ms"])
            except ValueError:
                raise protocol.BadRequest(
                    f"malformed interval_ms={req.query['interval_ms']!r}"
                ) from None
            if interval_ms < 10:
                raise protocol.BadRequest(
                    f"interval_ms must be >= 10, got {interval_ms}")
            interval_s = interval_ms / 1e3
        writer.write(protocol.http_response(
            101, None,
            headers={"Upgrade": "websocket", "Connection": "Upgrade",
                     "Sec-WebSocket-Accept": protocol.ws_accept_key(key)}))
        await writer.drain()
        self._ws_streams += 1
        closer = asyncio.create_task(self._ws_reader(reader, writer))
        try:
            while not closer.done():
                frame = json.dumps(
                    protocol.jsonable(self._stats()), allow_nan=False)
                writer.write(protocol.ws_frame(frame))
                await writer.drain()
                await asyncio.wait([closer], timeout=interval_s)
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._ws_streams -= 1
            closer.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await closer

    @staticmethod
    async def _ws_reader(reader, writer) -> None:
        """Consume client frames: answer pings, finish on close/EOF."""
        with contextlib.suppress(protocol.ConnectionClosed,
                                 ConnectionResetError, BrokenPipeError):
            while True:
                opcode, payload = await protocol.ws_read_frame(reader)
                if opcode == protocol.OP_CLOSE:
                    writer.write(protocol.ws_frame(
                        payload, opcode=protocol.OP_CLOSE))
                    await writer.drain()
                    return
                if opcode == protocol.OP_PING:
                    writer.write(protocol.ws_frame(
                        payload, opcode=protocol.OP_PONG))
                    await writer.drain()


def _card_of(router) -> int | None:
    """Index of the CUDA device the router's first collection on a card
    lives on (None when every collection is on the CPU)."""
    for name in router.collections():
        device = getattr(router.engine(name), "device", None)
        if device is not None and device.type == "cuda":
            return (device.index if device.index is not None
                    else torch.cuda.current_device())
    return None


def _bind_device(index: int | None) -> None:
    """Dispatch-worker initializer: make the collections' card the thread's
    current CUDA device."""
    if index is not None:
        torch.cuda.set_device(index)


def _require_post(req: protocol.HttpRequest) -> None:
    if req.method != "POST":
        err = protocol.ProtocolError(f"{req.path} requires POST")
        err.status = 405
        raise err


def _not_found(path: str) -> protocol.ProtocolError:
    err = protocol.ProtocolError(f"no route for {path!r}")
    err.status = 404
    return err
