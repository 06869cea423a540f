"""An open loop: each request is sent when it is due (the mix's arrival
laws, traffic.arrivals), whatever is pending. Its latency runs from when
it was due until its answer is on the host, so a generator that runs late
adds its lateness; how late it ran is logged. A request is noted as its
answer comes, and only the pending ones are held. Answers are waited for
until ``harness.ANSWER_WAIT_S`` past the window; one that never comes
counts as failed, with the time until the wait ended."""
from __future__ import annotations

import asyncio
import time

from knnbench import harness, traffic


def pending(mix: dict) -> None:
    """No bound on the requests waiting at once."""
    return None


async def drive(cell, entry, seconds: float) -> harness.Window:
    due = traffic.arrivals(cell.mix, seconds, cell.seed)
    w = cell.window()
    waiting: dict[int, asyncio.Future] = {}
    last = [0.0]

    def finished(j: int, fut: asyncio.Future) -> None:
        t = time.perf_counter()
        if waiting.pop(j, None) is None:  # given up on already
            return
        ans = None
        if not fut.cancelled() and fut.exception() is None:
            ans = entry.answer(fut.result())
        elif not fut.cancelled():
            harness.log(f"request {j} failed: {fut.exception()!r}")
        w.note(j, ans, (t - w.t_open - due[j]) * 1e3)
        if ans is not None:
            w.done_s.append(t - w.t_open)
            last[0] = t

    w.t_open = time.perf_counter()
    for j, t in enumerate(due):
        wait = w.t_open + t - time.perf_counter()
        if wait > 0:
            await asyncio.sleep(wait)
        w.late_ms.append((time.perf_counter() - w.t_open - t) * 1e3)
        try:
            fut = entry.submit(j)
        except Exception as e:
            fut = asyncio.get_running_loop().create_future()
            fut.set_exception(e)
        waiting[j] = fut
        fut.add_done_callback(lambda f, j=j: finished(j, f))
    give_up = w.t_open + seconds + harness.ANSWER_WAIT_S
    if waiting:
        await asyncio.wait(list(waiting.values()),
                           timeout=max(0.0, give_up - time.perf_counter()))
    await asyncio.sleep(0)  # let the last done callbacks run
    for j, fut in list(waiting.items()):  # never answered
        waiting.pop(j)
        fut.cancel()
        w.note(j, None, (give_up - w.t_open - due[j]) * 1e3)
    w.requests = len(due)
    w.t_close = last[0] if last[0] else time.perf_counter()
    return w
