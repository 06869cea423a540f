"""``ExactKNN.search`` called from the caller's own thread, as a batch job
calls it: each request is searched when it is sent, and its answers are
copied to the host before the call returns."""
from __future__ import annotations

import asyncio

from knnbench import harness


class Entry:
    def __init__(self, cell):
        self.cell = cell
        self.rows: list[int] = []
        self.skip_rates: list = []

    async def start(self) -> None:
        pass

    async def stop(self) -> None:
        pass

    def close(self) -> None:
        self.cell = None

    def reset(self) -> None:
        """Forget what the warm-up counted."""
        self.rows.clear()
        self.skip_rates.clear()

    def counters(self) -> dict:
        return {}

    def submit(self, i: int) -> asyncio.Future:
        """Search request number ``i`` now; a future that is already done."""
        cell = self.cell
        fut = asyncio.get_running_loop().create_future()
        req = cell.request(i)
        with cell.spans("knnbench.search"):
            res = cell.engine.search(req)
        with cell.spans("knnbench.answer_to_host"):
            ans = res.topk.scores.cpu(), res.topk.indices.cpu()
        rows = 1 if req.queries.ndim == 1 else req.queries.shape[0]
        self.rows.append(rows)
        harness.note_skip_rate(cell, self.skip_rates, res.kernel_stats)
        fut.set_result(ans)
        return fut

    def answer(self, result):
        return result

    async def warm(self) -> None:
        """The one shape the mix's requests have, twice."""
        for i in range(2):
            await self.submit(i)
        harness.sync(self.cell.dev)


def make(cell) -> Entry:
    return Entry(cell)
