"""Find a cell's pieces by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells, their
configurations and traffic mixes, and the metrics. Every piece is a file of
its own that is found here by its name, so a later change adds a cell, a
configuration, a mix or a metric by adding files:

    configs/<config>.json   the configuration's file (``configs[].file``)
    cells/<cell>.json       the cell's correctness sample and limits
    traffic/<mix>.json      the mix's parameters, read by traffic.py
    metrics/<metric>.py     the metric's reader, ``read(record)``; a name
                            with a dot falls back to the reader of its stem
                            (``device_idle_pct.batch`` -> device_idle_pct.py)

and the code a mix names by its keys, each a module of its own:

    stores/<dataset>.py     ``fit(cell, rows, engine_kw)``: how the program
                            holds the rows (resident, pinned host, ...)
    entries/<entry>.py      ``make(cell)``: the program's entry the requests
                            go through (``submit``, ``answer``, ``warm``)
    loops/<loop>.py         ``drive(cell, entry, seconds)`` and
                            ``pending(mix)``: how requests are sent
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell(name: str) -> dict:
    return json.loads((HERE / "cells" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def reader_path(metric: str) -> Path:
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return path


def _load(path: Path, kind: str):
    if not path.exists():
        raise KeyError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"knnbench.{kind}.{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The metric's ``read(record) -> float | None``."""
    return _load(reader_path(metric), "metrics").read


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (kind: stores, entries, loops)."""
    return _load(HERE / kind / f"{name}.py", kind)


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones without
    tracing, the per-layer ones with it; each where its ``workloads`` list
    names the cell, or everywhere when it has none."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", (cell_name,))]
