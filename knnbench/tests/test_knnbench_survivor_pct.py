"""``survivor_pct.batch``: the share of the f32 scan's lanes its survivor
filter admitted, from the program's counters ``scan.survivors`` and
``scan.lanes``; nothing where the program has no such counters."""
from __future__ import annotations

import pytest

from knnbench import program_spans, spec

BENCH = spec.load_benchmark()


def _read():
    return spec.reader("survivor_pct.batch")(None)


def test_the_share_of_lanes_admitted(monkeypatch):
    monkeypatch.setattr(program_spans, "record",
                        lambda: ([], {"scan.survivors": 1_024_000, "scan.lanes": 16_007_168}))
    assert _read() == pytest.approx(100 * 1_024_000 / 16_007_168)


@pytest.mark.parametrize("record", [lambda: None, lambda: ([], {}),
                                    lambda: ([], {"scan.survivors": 0, "scan.lanes": 0})],
                         ids=["no recorder in the program", "no scan counted",
                              "no lanes"])
def test_nothing_to_read_reads_none(monkeypatch, record):
    monkeypatch.setattr(program_spans, "record", record)
    assert _read() is None


def test_the_batch_cell_alone_reports_it_traced():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == "survivor_pct.batch")
    assert (entry["source"], entry["layer"], entry["moves"]) == (
        "program_counter", "kernels", "queries_per_s")
    for w in BENCH["workloads"]:
        for traced in (False, True):
            names = {m["name"] for m in spec.metrics_for(BENCH, w["name"], traced)}
            assert ("survivor_pct.batch" in names) == (traced and w["name"] == "gist1m-fqsd-b16")
