"""The traced window: torch.profiler over the window, read back from its
Chrome trace.

Device work is every event of the categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``, whatever its name. What the host was doing comes from the
benchmark's own spans (:class:`Spans`, named ``knnbench.*``) around its
calls into each layer: each is a ``torch.profiler.record_function`` and is
also kept on the host clock, since the profiler does not see every thread
(the batcher's dispatch worker); the window's span ties the two clocks.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

WINDOW_SPAN = "knnbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside the benchmark's spans"
TOP = 10


class _Span:
    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        import torch

        self.t0 = time.perf_counter()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.spans.done.append((self.name, self.t0, time.perf_counter()))
        return False


class Spans:
    """The benchmark's host spans; nothing is recorded while ``on`` is false."""

    def __init__(self, on: bool):
        self.on = on
        self.done: list[tuple[str, float, float]] = []

    def __call__(self, name: str):
        return _Span(self, name) if self.on else contextlib.nullcontext()


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def events(prof) -> list[dict]:
    """The complete ("X") events of a finished profiler."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    return [e for e in doc["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(a, b, lo, hi):
    return max(a, lo), min(b, hi)


def summarize(evs: list[dict], spans: list | None = None,
              window_start: float | None = None) -> dict | None:
    """What the metric readers take from a trace, in seconds and bytes,
    inside the window span; None when the trace has no window span.
    ``spans`` are host spans (name, start, end) on the host clock, whose
    ``window_start`` is where the window span begins."""
    win = [e for e in evs if e["name"] == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not win:
        return None
    lo, hi = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    dev, kernel_us, h2d_bytes = [], 0.0, 0
    by_name = defaultdict(float)
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), lo, hi)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] += b - a
        if e["cat"] == "kernel":
            kernel_us += b - a
        elif e["name"].startswith("Memcpy HtoD"):
            h2d_bytes += int(e.get("args", {}).get("bytes", 0)) * (b - a) / float(e["dur"])
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps = [(a, b) for (_, a), (b, _) in zip([(lo, lo)] + busy, busy + [(hi, hi)]) if b > a]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernel_s": kernel_us * 1e-6,
        "h2d_bytes": h2d_bytes,
        "device_ops": [[n, s * 1e-6] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": _idle_by_host(evs, gaps, _to_trace(spans or [], window_start, lo)),
    }


def _to_trace(spans, window_start, window_ts) -> list:
    """Host spans on the trace's clock (microseconds), aligned at the
    window's start."""
    if window_start is None:
        return []
    off = window_ts - window_start * 1e6
    return sorted((a * 1e6 + off, b * 1e6 + off, n) for n, a, b in spans if n != WINDOW_SPAN)


def _idle_by_host(evs, gaps, host_spans) -> list:
    """Idle device time grouped by the innermost host span at each gap's
    middle: a benchmark span, else a PyTorch operator the profiler saw,
    else none."""
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in evs if e.get("cat") == "cpu_op")
    kinds = [([s[0] for s in k], k) for k in (host_spans, ops)]
    total = defaultdict(float)
    for a, b in gaps:
        total[_innermost(kinds, 0.5 * (a + b))] += (b - a) * 1e-6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def _innermost(kinds, t: float) -> str:
    for starts, spans in kinds:
        i = bisect.bisect_right(starts, t)
        inside = [s for s in spans[max(0, i - 64): i] if s[1] >= t]
        if inside:
            return min(inside, key=lambda s: s[1] - s[0])[2]
    return OUTSIDE
