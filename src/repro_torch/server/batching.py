"""Continuous batching: drain the live queue into option-compatible
batches and feed :class:`AdaptiveScheduler` without blocking the event
loop.

One :class:`ContinuousBatcher` fronts one collection's scheduler. The loop
is iteration-level batching, the same discipline LLM serving engines use:
while a dispatch runs on the worker executor, new arrivals keep landing in
the queue; the moment the dispatch returns, the next batch is formed from
*everything* compatible that accumulated — so batch size adapts to load
with no batching-window timer to tune, latency stays one-dispatch-bounded
under light load, and throughput approaches the scheduler's ``max_batch``
under heavy load.

Batches group by :meth:`AdaptiveScheduler.batch_signature` — the same
option-compatibility rule the dispatch path enforces (k/metric/tier/mode
pins/filter mask/resilience knobs), so a mixed-tenant queue never forces a
plan-incompatible dispatch. Scheduler dispatch runs in a **worker thread
executor** (`loop.run_in_executor`): the compiled-executable cache and the
engines are single-threaded by design, so the server shares ONE worker
thread across all collections — the event loop stays free to admit,
reject, and stream stats while the accelerator crunches.

Results resolve per-request futures as their dispatch completes; a future
whose waiter vanished (client disconnect, queue timeout) is skipped at
batch-formation time, so dead requests never occupy dispatch slots.

The port's copy of ``repro.server.batching``, unchanged but for the
imports. On the card the worker thread is where kernels launch (on that
thread's current stream) and where the scheduler copies each answer to the
host, so a resolved future holds CPU tensors and the event loop never
waits on the card.
"""
from __future__ import annotations

import asyncio
import functools
from collections import deque

from repro_torch.api.types import SearchRequest

__all__ = ["ContinuousBatcher", "ServerClosed"]


class ServerClosed(RuntimeError):
    """The batcher is draining/stopped; no further requests are accepted."""


class ContinuousBatcher:
    """The live queue + dispatch loop for one collection.

    scheduler   the collection's AdaptiveScheduler (dispatch_batch entry).
    executor    shared worker ThreadPoolExecutor (single worker: engine
                dispatch is deliberately serialized across collections).
    """

    def __init__(self, scheduler, executor):
        self.scheduler = scheduler
        self._executor = executor
        self._queue: deque[tuple[SearchRequest, asyncio.Future]] = deque()
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        #: EWMA of one dispatch's wall time — the backlog-to-wait estimate
        #: admission control reads (seeded pessimistically low so the first
        #: dispatches are never rejected on a cold estimate)
        self._ewma_dispatch_s: float | None = None
        self.dispatched_batches = 0

    # ---------------------------------------------------------------- intake
    def submit(self, request: SearchRequest) -> asyncio.Future:
        """Enqueue one admitted request; resolves to its SearchResult."""
        if self._closed:
            raise ServerClosed("server is shutting down")
        fut = asyncio.get_running_loop().create_future()
        self._queue.append((request, fut))
        self.scheduler.note_queue_depth(len(self._queue))
        self._wakeup.set()
        return fut

    def depth(self) -> int:
        return len(self._queue)

    def predicted_wait_s(self) -> float:
        """Admission's feasibility estimate: dispatches-ahead x EWMA
        dispatch time. With an empty queue one dispatch (the request's own)
        is still ahead of the answer."""
        est = self._ewma_dispatch_s
        if est is None:
            return 0.0  # cold start: admit — the EWMA warms on dispatch 1
        take = max(1, self.scheduler.max_batch)
        batches_ahead = 1 + len(self._queue) // take
        return batches_ahead * est

    # -------------------------------------------------------------- dispatch
    def _take_batch(self) -> list[tuple[SearchRequest, asyncio.Future]]:
        """Pop the next option-compatible batch; drop abandoned entries."""
        sig = None
        batch: list[tuple[SearchRequest, asyncio.Future]] = []
        take = max(1, self.scheduler.max_batch)
        while self._queue and len(batch) < take:
            req, fut = self._queue[0]
            if fut.done():  # cancelled by timeout/disconnect: skip it
                self._queue.popleft()
                continue
            key = self.scheduler.batch_signature(req)
            if sig is None:
                sig = key
            elif key != sig:
                break  # next compatibility group waits for its own dispatch
            batch.append((req, fut))
            self._queue.popleft()
        self.scheduler.note_queue_depth(len(self._queue))
        return batch

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._wakeup.wait()
            self._wakeup.clear()
            if self._closed:
                break
            while self._queue:
                batch = self._take_batch()
                if not batch:
                    continue
                reqs = [r for r, _ in batch]
                clock = loop.time()
                t0 = clock
                try:
                    results = await loop.run_in_executor(
                        self._executor,
                        functools.partial(
                            self.scheduler.dispatch_batch, reqs, clock),
                    )
                except Exception as e:  # engine/storage error: per-request
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                else:
                    dt = loop.time() - t0
                    ema = self._ewma_dispatch_s
                    self._ewma_dispatch_s = (
                        dt if ema is None else 0.7 * ema + 0.3 * dt)
                    self.dispatched_batches += 1
                    for (_, fut), res in zip(batch, results):
                        if not fut.done():
                            fut.set_result(res)
        # drain: everything still queued is answered with ServerClosed
        while self._queue:
            _, fut = self._queue.popleft()
            if not fut.done():
                fut.set_exception(ServerClosed("server is shutting down"))
        self.scheduler.note_queue_depth(0)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._closed = True
        self._wakeup.set()
        if self._task is not None:
            await self._task
            self._task = None

    def stats(self) -> dict:
        return {
            "queue_depth": len(self._queue),
            "dispatched_batches": self.dispatched_batches,
            "ewma_dispatch_ms": (None if self._ewma_dispatch_s is None
                                 else self._ewma_dispatch_s * 1e3),
        }
