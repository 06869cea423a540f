"""``ContinuousBatcher.submit`` over an ``AdaptiveScheduler`` and a router,
with one dispatch worker thread that has the card as its current device:
the serving path of ``KnnServer`` without its HTTP codec. The mix's
``scheduler`` arguments (its ``policy``) go to the scheduler."""
from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from knnbench import harness


class _Dispatches:
    """Stands in front of the scheduler for the batcher: a span around each
    call into the scheduler's dispatch, the query rows of each dispatch and
    the kernel's skip rate."""

    def __init__(self, cell, sched, skip_rates: list):
        self._cell = cell
        self._sched = sched
        self._spans = cell.spans
        self._skip_rates = skip_rates
        self.rows: list[int] = []
        self.times: list[tuple[float, float]] = []

    def __getattr__(self, name):
        return getattr(self._sched, name)

    def dispatch_batch(self, reqs, clock_s=None):
        t0 = time.perf_counter()
        with self._spans("knnbench.dispatch"):
            out = self._sched.dispatch_batch(reqs, clock_s)
        self.times.append((t0, time.perf_counter()))
        self.rows.append(sum(1 if r.queries.ndim == 1 else r.queries.shape[0] for r in reqs))
        if out:
            harness.note_skip_rate(self._cell, self._skip_rates, out[0].kernel_stats)
        return out


class Entry:
    def __init__(self, cell):
        from repro_torch.api.router import Router
        from repro_torch.serving.retrieval import AdaptiveScheduler

        self.cell = cell
        router = Router()
        router.attach(cell.work["config"], cell.engine)
        self.sched = AdaptiveScheduler(router=router, collection=cell.work["config"],
                                       **cell.mix.get("scheduler", {}))
        self.skip_rates: list = []
        self.dispatches = _Dispatches(cell, self.sched, self.skip_rates)
        init = (torch.cuda.set_device, (cell.dev,)) if cell.dev.type == "cuda" else (None, ())
        self.executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="knn-dispatch",
                                           initializer=init[0], initargs=init[1])
        self.batcher = None
        self._before = 0

    @property
    def rows(self) -> list[int]:
        return self.dispatches.rows

    async def start(self) -> None:
        from repro_torch.server.batching import ContinuousBatcher

        self.batcher = ContinuousBatcher(self.dispatches, self.executor)
        self.batcher.start()

    async def stop(self) -> None:
        if self.batcher is not None:
            await self.batcher.stop()

    def close(self) -> None:
        self.executor.shutdown(wait=True)
        self.cell = self.sched = self.dispatches = self.batcher = None

    def reset(self) -> None:
        self.dispatches.rows.clear()
        self.dispatches.times.clear()
        self.skip_rates.clear()
        self._before = self.batcher.dispatched_batches

    def counters(self) -> dict:
        return {"dispatches": self.batcher.dispatched_batches - self._before,
                "dispatch_times": list(self.dispatches.times)}

    def submit(self, i: int) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        with self.cell.spans("knnbench.submit"):
            return self.batcher.submit(self.cell.request(i, arrival_s=loop.time()))

    def answer(self, res):
        """A result's (scores, ids), or None where it was shed or refused."""
        if res.plan is None or res.stats.get("shed"):
            return None
        return res.topk.scores[None], res.topk.indices[None]

    async def warm(self) -> None:
        """Every batch size a dispatch can have, twice: the scheduler pads a
        dispatch to a power of two, up to its ``max_batch`` or to the rows
        the loop can have pending, whichever is fewer."""
        top = self.sched.max_batch
        if self.cell.pending is not None:
            top = min(top, self.cell.pending * self.cell.mix["queries_per_request"])
        sizes, s = [], 1
        while s < top:
            sizes.append(s)
            s *= 2
        sizes.append(top)
        i = 0
        for size in sorted(set(sizes)) * 2:
            futs = [self.submit(i + j) for j in range(size)]
            i += size
            await asyncio.gather(*futs)
        harness.sync(self.cell.dev)


def make(cell) -> Entry:
    return Entry(cell)
