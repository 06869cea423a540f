"""The reading of a trace: busy time, kernel time, copied bytes and idle
gaps inside the window, on a made-up Chrome trace."""
from __future__ import annotations

import pytest

from knnbench import trace as tr


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    ev("user_annotation", tr.WINDOW_SPAN, 1000.0, 1000.0),
    ev("kernel", "knn_scan_kernel", 900.0, 300.0),          # half inside the window
    ev("kernel", "knn_merge_kernel", 1250.0, 50.0),
    ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1280.0, 120.0, bytes=1200),
    ev("gpu_memset", "Memset (Device)", 1600.0, 100.0),
    ev("kernel", "knn_scan_kernel", 1900.0, 400.0),         # ends after the window
    ev("cpu_op", "aten::copy_", 1450.0, 100.0),
]


def test_summary_inside_the_window():
    # host spans on their own clock: the window opened at 50.0 s
    spans = [("knnbench.dispatch", 50.0006, 50.00085)]
    s = tr.summarize(EVENTS, spans, 50.0)
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: [1000, 1200] + [1250, 1400] + [1600, 1700] + [1900, 2000]
    assert s["busy_s"] == pytest.approx(550e-6)
    assert s["kernel_s"] == pytest.approx((200 + 50 + 100) * 1e-6)
    assert s["h2d_bytes"] == pytest.approx(1200)
    assert s["device_ops"][0] == ["knn_scan_kernel", pytest.approx(300e-6)]
    gaps = dict(s["idle_gaps"])
    # idle [1400, 1600] middle 1500: the cpu op; [1700, 1900] middle 1800:
    # inside the dispatch span (1600-1850 on the trace's clock)
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps["knnbench.dispatch"] == pytest.approx(200e-6)
    assert gaps[tr.OUTSIDE] == pytest.approx(50e-6)  # [1200, 1250]


def test_no_window_span_reads_nothing():
    assert tr.summarize(EVENTS[1:]) is None


def test_spans_record_only_when_on():
    off, on = tr.Spans(False), tr.Spans(True)
    with off("knnbench.search"):
        pass
    with on("knnbench.search"):
        pass
    assert off.done == [] and [n for n, _, _ in on.done] == ["knnbench.search"]
