"""The readers of the program's own spans and counters
(``knnbench/program_spans.py`` over ``repro_torch.runtime.tracing``): their
arithmetic on a hand-built record, the cells that report them, and a whole
traced run on the CPU whose padding counter agrees with the benchmark's own
count of rows a dispatch."""
from __future__ import annotations

import json
import time
from collections import namedtuple

import pytest
import torch

from knnbench import harness, program_spans, spec

BENCH = spec.load_benchmark()
S = namedtuple("S", "name start end id parent")

#: the per-layer metrics this reader family adds, and the one cell each reads
NEW = {
    "queue_wait_p95_ms.open": "msmarco-fdsq-open",
    "queue_wait_p95_ms.single": "msmarco-fdsq-single",
    "scheduler_host_ms.open": "msmarco-fdsq-open",
    "scheduler_host_ms.single": "msmarco-fdsq-single",
    "engine_host_ms.batch": "gist1m-fqsd-b16",
    "engine_host_ms.single": "msmarco-fdsq-single",
    "launch_host_ms.batch": "gist1m-fqsd-b16",
    "launch_host_ms.single": "msmarco-fdsq-single",
    "padded_rows_pct.open": "msmarco-fdsq-open",
}


def _hand_built():
    """Two dispatches on the worker (10 ms and 6 ms), each holding a search
    and a wait for the card; a root search with two launches; 20 waits."""
    spans = [S("batcher.wait", 0.0, i * 1e-3, 100 + i, 1) for i in range(1, 21)]
    spans += [
        S("scheduler.dispatch", 1.000, 1.010, 1, None),
        S("engine.search", 1.001, 1.005, 2, 1),
        S("executor.launch", 1.002, 1.003, 3, 2),
        S("scheduler.device_wait", 1.005, 1.008, 4, 1),
        S("scheduler.dispatch", 2.000, 2.006, 5, None),
        S("engine.search", 2.001, 2.003, 6, 5),
        S("executor.launch", 2.0015, 2.0025, 7, 6),
        # no device wait in this one; an unrelated root search
        S("engine.search", 3.000, 3.010, 8, None),
        S("executor.launch", 3.001, 3.002, 9, 8),
        S("executor.launch", 3.004, 3.006, 10, 8),
    ]
    return spans, {"scheduler.rows": 45, "scheduler.padded_rows": 19}


def _read(name):
    return spec.reader(name)(None)


def test_readers_on_a_hand_built_record(monkeypatch):
    monkeypatch.setattr(program_spans, "record", _hand_built)
    # nearest rank: the 19th of 20 waits, 19 ms
    assert _read("queue_wait_p95_ms.open") == pytest.approx(19.0)
    # dispatch self time: 10 - 4 - 3 = 3 ms and 6 - 2 = 4 ms
    assert _read("scheduler_host_ms.single") == pytest.approx(3.5)
    # search self time: 4 - 1, 2 - 1, 10 - 1 - 2 ms over three searches
    assert _read("engine_host_ms.batch") == pytest.approx((3 + 1 + 7) / 3)
    # launch host time: 1 + 1 + 1 + 2 ms over three searches
    assert _read("launch_host_ms.single") == pytest.approx(5 / 3)
    assert _read("padded_rows_pct.open") == pytest.approx(100 * 19 / 64)


def test_self_time_counts_overlapping_children_once(monkeypatch):
    spans = [S("engine.search", 0.0, 0.010, 1, None),
             S("executor.launch", 0.001, 0.005, 2, 1),
             S("executor.launch", 0.003, 0.006, 3, 1),
             S("executor.launch", 0.009, 0.020, 4, 1)]  # runs past its parent
    monkeypatch.setattr(program_spans, "record", lambda: (spans, {}))
    assert program_spans.self_ms("engine.search", ("executor.launch",)) == [
        pytest.approx(10 - 5 - 1)]


@pytest.mark.parametrize("record", [lambda: None, lambda: ([], {})],
                         ids=["no recorder in the program", "nothing recorded"])
def test_readers_find_nothing_and_read_none(monkeypatch, record):
    monkeypatch.setattr(program_spans, "record", record)
    for name in NEW:
        assert _read(name) is None, name
    monkeypatch.setattr(program_spans, "record",
                        lambda: ([], {"scheduler.rows": 0, "scheduler.padded_rows": 0}))
    assert _read("padded_rows_pct.open") is None


@pytest.mark.parametrize("name,cell", sorted(NEW.items()))
def test_each_entry_is_reported_by_its_cell_alone(name, cell):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [cell]
    assert entry["source"] == ("program_counter" if name.startswith("padded") else "program_span")
    for w in BENCH["workloads"]:
        found = name in {m["name"] for m in spec.metrics_for(BENCH, w["name"], True)}
        assert found == (w["name"] == cell)
    assert name not in {m["name"] for m in spec.metrics_for(BENCH, cell, False)}
    assert callable(spec.reader(name))


def test_the_streamed_cell_reports_what_it_did():
    assert [m["name"] for m in spec.metrics_for(BENCH, "gist1m-fqsd-streamed-b16", True)] == [
        "device_idle_pct.streamed", "kernel_roofline_pct.streamed", "h2d_gbps",
        "joules_per_query.streamed"]


def _open_run(traced: bool, dump=None) -> dict:
    return harness.measure("msmarco-fdsq-open", 2 ** 31 + 4099, 0.6, traced, time.perf_counter(),
                           device=torch.device("cpu"), cfg_override={"n": 6000},
                           mix_override={"query_pool": 256,
                                         "arrivals": [{"law": "poisson", "rate_per_s": 200}]},
                           dump=dump)


def test_a_traced_run_reads_the_programs_padding_as_the_benchmark_counts_it(tmp_path):
    from repro_torch.core.partition import next_pow2
    from repro_torch.runtime import tracing

    tracing.clear()
    untraced = _open_run(False)
    assert untraced["correct"] and tracing.spans() == [] and tracing.counters() == {}
    dump = tmp_path / "run.json"
    out = _open_run(True, str(dump))
    tracing.clear()
    assert out["correct"]
    got = out["metrics"]
    assert {"queue_wait_p95_ms.open", "scheduler_host_ms.open", "padded_rows_pct.open"} <= set(got)
    rows = [r for _, _, r in json.loads(dump.read_text())["dispatches"]]
    assert rows and sum(rows) == out["attempted"]
    want = 100 * sum(next_pow2(r) - r for r in rows) / sum(next_pow2(r) for r in rows)
    assert got["padded_rows_pct.open"]["value"] == pytest.approx(want)
    assert got["queue_wait_p95_ms.open"]["value"] >= 0
    assert got["scheduler_host_ms.open"]["value"] > 0
