"""A closed loop: the mix's ``callers`` callers (default 1), each sending
its next request when its last one is answered, until the window's time is
up. A request's latency runs from when it was sent until its answer is on
the host; the window closes with the last answer."""
from __future__ import annotations

import asyncio
import itertools
import time

from knnbench import harness


def pending(mix: dict) -> int:
    """The most requests that can be waiting at once."""
    return int(mix.get("callers", 1))


async def drive(cell, entry, seconds: float) -> harness.Window:
    w = cell.window()
    numbers = itertools.count()
    w.t_open = time.perf_counter()
    end = w.t_open + seconds

    async def caller() -> float:
        while True:
            i = next(numbers)
            t0 = time.perf_counter()
            try:
                ans = entry.answer(await entry.submit(i))
            except Exception as e:  # a failed request counts as failed, not as wrong
                ans = None
                harness.log(f"request {i} failed: {e!r}")
            t1 = time.perf_counter()
            w.note(i, ans, (t1 - t0) * 1e3)
            if t1 >= end:
                return t1

    closes = await asyncio.gather(*(caller() for _ in range(pending(cell.mix))))
    w.requests, w.t_close = len(w.latencies_ms), max(closes)
    return w
