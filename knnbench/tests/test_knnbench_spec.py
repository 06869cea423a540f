"""BENCHMARK.json keeps to the benchmark's contract, and every piece it
names is found by name."""
from __future__ import annotations

import json
import re

import pytest

from knnbench import roofline, spec
from knnbench.harness import Record
from knnbench.stats import percentile

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_and_sizes():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    script = [w for w in BENCH["command"] if w.endswith(".py")]
    assert script and all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in script)


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(r) for r in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(("cell", w["name"]))
    for group, extra in (("end_to_end", {"bound"}), ("per_layer", {"layer", "moves"})):
        for m in BENCH[group]:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(("metric", m["name"]))
    assert len(names) == len(set(names))


def test_bounds_sources_and_cells_report_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        for c in m.get("workloads", cells):
            assert c in cells and c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        assert "setup_s" in {m["name"] for m in spec.metrics_for(BENCH, c, False)}
        assert len(spec.metrics_for(BENCH, c, False)) >= 2
        assert spec.metrics_for(BENCH, c, True)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_piece_of_a_cell_is_found_by_name(w):
    cfg = spec.config(BENCH, w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == []
    mix = spec.traffic(w["traffic"])
    assert isinstance(mix["request"]["k"], int)
    assert callable(spec.module("stores", mix["dataset"]).fit)
    assert callable(spec.module("entries", mix["entry"]).make)
    loop = spec.module("loops", mix["loop"])
    assert callable(loop.drive) and callable(loop.pending)
    if mix["loop"] == "open":
        assert mix["arrivals"]
    with pytest.raises(KeyError):
        spec.module("entries", "no_such_entry")
    cell = spec.cell(w["name"])
    assert set(cell["limits"]) == {"unanswered", "malformed", "score_err", "rank_err"}
    assert cell["limits"]["unanswered"] == cell["limits"]["malformed"] == 0
    for trace in (False, True):
        for m in spec.metrics_for(BENCH, w["name"], trace):
            assert callable(spec.reader(m["name"]))


def test_config_files_lie_under_the_paths_and_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith(tuple(p + "/" for p in BENCH["paths"])) for f in files)
    assert spec.reader_path("device_idle_pct.open").name == "device_idle_pct.py"


def test_bound_arithmetic():
    # GIST FQ-SD: bytes bound (3.84 GB of rows) over the f32 operations
    b = roofline.search_bytes(1_000_000, 960, 16, 1024)
    assert b == 4 * 960_000_000 + 4 * 16 * 960 + 8 * 16 * 1024
    assert roofline.search_flops(1_000_000, 960, 16) == 30_720_000_000
    assert roofline.search_bound_s(1_000_000, 960, 16, 1024) == pytest.approx(b / 3.35e12)
    # MS-MARCO at 64 queries: the operations bound
    f = roofline.search_flops(8_841_823, 769, 64)
    assert roofline.search_bound_s(8_841_823, 769, 64, 72) == pytest.approx(f / 67e12)
    assert roofline.search_bound_s(8_841_823, 769, 1, 72) == pytest.approx(
        roofline.search_bytes(8_841_823, 769, 1, 72) / 3.35e12)


def test_readers_on_a_record():
    cfg = {"n": 1_000_000, "d": 960}
    trace = {"window_s": 2.0, "busy_s": 1.5, "kernel_s": 1.2, "h2d_bytes": 9e10,
             "device_ops": [], "idle_gaps": []}
    rec = Record(cfg=cfg, k=1024, setup_s=9.5, window_s=2.0, requests=300, queries=4800,
                 latencies_ms=[float(i) for i in range(1, 101)], searches=[16] * 300,
                 dispatches=60, skip_rates=[0.25, 0.75], energy_j=480.0, trace=trace)
    read = lambda name: spec.reader(name)(rec)  # noqa: E731
    assert read("queries_per_s") == 2400
    assert read("latency_p50_ms") == 50 and read("latency_p95_ms") == 95
    assert read("setup_s") == 9.5
    assert read("device_idle_pct.batch") == pytest.approx(25.0)
    assert read("kernel_roofline_pct.batch") == pytest.approx(
        100 * 300 * roofline.search_bound_s(1_000_000, 960, 16, 1024) / 1.2)
    assert read("dispatch_rows_mean") == 80
    assert read("dispatch_rows_p95") == 16
    assert read("latency_p95_ms.open_traced") == 95
    assert read("h2d_gbps") == pytest.approx(45.0)
    assert read("joules_per_query") == pytest.approx(0.1)
    assert read("prune_skip_pct.batch") == pytest.approx(50.0)
    rec.trace, rec.energy_j, rec.dispatches, rec.skip_rates = None, None, None, []
    for name in ("device_idle_pct.open", "kernel_roofline_pct.open", "h2d_gbps",
                 "joules_per_query", "dispatch_rows_mean", "dispatch_rows_p95",
                 "prune_skip_pct.single"):
        assert read(name) is None  # nothing to read: the metric is left out
    assert percentile([], 50) is None and percentile([3.0], 95) == 3.0
