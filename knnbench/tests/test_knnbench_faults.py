"""A run with the timed path broken underneath comes out not correct.

The whole run (set-up, window, metrics, check) runs on the CPU at a small
size, with the port's plain kernels; only the look for a card is skipped.
Each fault is planted in ``ExactKNN.search``, under both entries (the
search entry and the batcher's dispatches), where the answer is produced.
The faults a one-card kNN cell can have: an answer altered, half of the
batch left out, a search that returns its last answer unchanged. (No cell
exchanges anything between cards.)
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

import pytest
import torch

from knnbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SMALL = {"n": 6000}


def run(cell: str) -> dict:
    return harness.measure(cell, 2 ** 31 + 99, 0.4, False, time.perf_counter(),
                           device=torch.device("cpu"), cfg_override=SMALL,
                           mix_override={"query_pool": 256,
                                         "arrivals": [{"law": "poisson", "rate_per_s": 60}],
                                         "store": {"rows_per_shard": 2048}})


def plant(monkeypatch, fault: str) -> None:
    from repro_torch.core.engine import ExactKNN
    from repro_torch.core.topk import TopK

    search = ExactKNN.search
    last = {}

    def broken(self, request):
        if fault == "half_batch_left_out" and np.asarray(request.queries).ndim == 2 \
                and np.asarray(request.queries).shape[0] == 1:
            # one query: the half of the batch left out is half of the rows
            keep = torch.zeros(self.n_ids, dtype=torch.bool)
            keep[: self.n_ids // 2] = True
            return search(self, dataclasses.replace(request, filter_mask=keep))
        res = search(self, request)
        s, i = res.topk.scores.clone(), res.topk.indices.clone()
        if fault == "answer_altered":
            i[0, 0] = (i[0, 0] + self.n_ids // 2) % self.n_ids
        elif fault == "half_batch_left_out":  # its rows answered by the others'
            h = (i.shape[0] + 1) // 2
            s[h:], i[h:] = s[: i.shape[0] - h], i[: i.shape[0] - h]
        elif fault == "state_unchanged":
            prev = last.get(tuple(i.shape))
            last[tuple(i.shape)] = (s, i)
            if prev is not None:
                s, i = prev
        return dataclasses.replace(res, topk=TopK(s, i))

    monkeypatch.setattr(ExactKNN, "search", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_an_unbroken_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out", "state_unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    plant(monkeypatch, fault)
    out = run(cell)
    assert not out["correct"], out["checks"]
