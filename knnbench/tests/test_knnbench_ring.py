"""The ring cell, ``yfcc100m-fqsd-ring-b256``: a fault the ring alone can
have comes out not correct, and the readers of its mesh layer
(``ring_step_host_ms``, ``peer_gbps``) read the program's spans and
counters and the trace's peer copies, or nothing.

The runs are whole runs of the cell on the CPU at a small size, through
the mesh store's four logical positions and the kernels' plain versions.
"""
from __future__ import annotations

import time
from collections import namedtuple

import pytest
import torch

from knnbench import harness, program_spans, spec

BENCH = spec.load_benchmark()
CELL = "yfcc100m-fqsd-ring-b256"
S = namedtuple("S", "name start end id parent")


def run(traced: bool = False) -> dict:
    return harness.measure(CELL, 2 ** 31 + 211, 0.4, traced, time.perf_counter(),
                           device=torch.device("cpu"), cfg_override={"n": 6000},
                           mix_override={"query_pool": 256})


def test_a_block_left_unscanned_in_one_ring_step_is_not_correct(monkeypatch):
    """At every search, position 2 skips its scan of the block it holds at
    step 1 (the ring's sixth of 4 x 4 position-steps): that block's rows
    never reach those queries' queues."""
    from repro_torch.core import sharded

    scan, calls = sharded._local_scan, []

    def skipping(step, state, *args):
        calls.append(None)
        return state if len(calls) % 16 == 7 else scan(step, state, *args)

    monkeypatch.setattr(sharded, "_local_scan", skipping)
    out = run()
    assert len(calls) >= 16 and len(calls) % 16 == 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["rank_err"]["value"] > out["checks"]["rank_err"]["limit"]


def test_a_traced_run_reads_the_ring_step_and_leaves_out_the_card_metrics():
    from repro_torch.runtime import tracing

    tracing.clear()
    out = run(traced=True)
    tracing.clear()
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["ring_step_host_ms.ring"]["value"] > 0
    # no kernel and no peer copy on the CPU: nothing to read
    assert "kernel_roofline_pct.ring" not in got and "peer_gbps.ring" not in got


def _record(spans, counters):
    return lambda: (spans, counters)


def _trace(ops):
    return {"window_s": 1.0, "busy_s": 1.0, "kernel_s": 0.5, "h2d_bytes": 0,
            "device_ops": ops, "idle_gaps": []}


def test_the_readers_on_a_hand_built_record(monkeypatch):
    spans = [S("ring.step", 1.0, 1.002, 1, None), S("ring.ship", 1.0, 1.001, 2, 1),
             S("ring.step", 1.1, 1.104, 3, None), S("mesh.gather", 1.2, 1.3, 4, None)]
    monkeypatch.setattr(program_spans, "record",
                        _record(spans, {"ring.bytes_shipped": 12 * 10 ** 9,
                                        "ring.blocks_shipped": 12}))
    rec = harness.Record(cfg={}, k=1024, setup_s=1.0, window_s=1.0, trace=_trace(
        [["knn_scan_kernel<float,16>", 0.5], ["Memcpy PtoP (Device -> Device)", 0.03],
         ["Memcpy DtoD (Device -> Device)", 0.9]]))
    assert spec.reader("ring_step_host_ms.ring")(rec) == pytest.approx(3.0)
    # 12 GB over the peer copies' 0.03 s; the copy within one card is not one
    assert spec.reader("peer_gbps.ring")(rec) == pytest.approx(400.0)


@pytest.mark.parametrize("record,ops", [
    (lambda: None, [["Memcpy PtoP (Device -> Device)", 0.03]]),
    (_record([], {}), [["Memcpy PtoP (Device -> Device)", 0.03]]),
    (_record([], {"ring.bytes_shipped": 10 ** 9}), [["Memcpy DtoD (Device -> Device)", 0.03]]),
], ids=["no recorder in the program", "nothing recorded", "no copy between cards"])
def test_nothing_to_read_reads_none(monkeypatch, record, ops):
    monkeypatch.setattr(program_spans, "record", record)
    rec = harness.Record(cfg={}, k=1024, setup_s=1.0, window_s=1.0, trace=_trace(ops))
    assert spec.reader("ring_step_host_ms.ring")(rec) is None
    assert spec.reader("peer_gbps.ring")(rec) is None


def test_the_ring_cell_alone_reports_the_mesh_layer_traced():
    for name, source, layer in (("kernel_roofline_pct.ring", "device_trace", "kernels"),
                                ("ring_step_host_ms.ring", "program_span", "mesh"),
                                ("peer_gbps.ring", "program_counter", "mesh")):
        entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert (entry["source"], entry["layer"], entry["moves"], entry["workloads"]) == (
            source, layer, "queries_per_s", [CELL])
    assert [m["name"] for m in spec.metrics_for(BENCH, CELL, False)] == ["queries_per_s",
                                                                         "setup_s"]
    assert [m["name"] for m in spec.metrics_for(BENCH, CELL, True)] == [
        "kernel_roofline_pct.ring", "ring_step_host_ms.ring", "peer_gbps.ring"]
    assert spec.workload(BENCH, CELL)["chips"] == 4
