"""One run of a cell: set-up, the measured window, the metrics, and the
check of the answers against the reference.

The program under test is ``repro_torch``: the benchmark hands it rows and
queries made from the seed and calls it through the entry the traffic mix
names. Everything else here (traffic, reference, comparison, peaks, trace
reading) belongs to the benchmark.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from knnbench import compare, data, reference, spec, traffic
from knnbench import trace as tr
from knnbench.energy import EnergyMeter

#: how long past the window's close a request's answer is waited for
ANSWER_WAIT_S = 60.0
#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The machine has no card, or fewer than the cell asks for."""


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers (metrics/*.py) read it."""
    cfg: dict
    k: int
    setup_s: float
    window_s: float
    requests: int = 0
    failed: int = 0
    queries: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    searches: list = dataclasses.field(default_factory=list)
    dispatches: int | None = None
    skip_rates: list = dataclasses.field(default_factory=list)
    energy_j: float | None = None
    trace: dict | None = None


@dataclasses.dataclass
class Window:
    """What the window's requests came to, for the record and the check.

    Of the answered requests it keeps a sample of at most ``keep``, drawn
    from the seed as the answers come (reservoir sampling), for the check:
    the window holds no more answers, futures or results than that, so the
    benchmark's own bookkeeping does not grow the heap the program's
    garbage collections walk."""
    #: query rows of each request
    m: int = 1
    keep: int = 0
    seed: int = 0
    t_open: float = 0.0
    t_close: float = 0.0
    answers: dict = dataclasses.field(default_factory=dict)
    latencies_ms: list = dataclasses.field(default_factory=list)
    requests: int = 0
    failed: int = 0
    queries: int = 0
    late_ms: list = dataclasses.field(default_factory=list)
    #: seconds from the window's opening to each answer (open loop)
    done_s: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(int(self.seed))
        self._answered = 0
        self._slots: list[int] = []

    def note(self, i: int, answer, latency_ms: float) -> None:
        """Request ``i`` ended with ``answer`` (None: failed, shed or never
        answered) after ``latency_ms``."""
        self.latencies_ms.append(latency_ms)
        if answer is None:
            self.failed += 1
            return
        self.queries += self.m
        self._answered += 1
        if len(self._slots) < self.keep:
            self._slots.append(i)
            self.answers[i] = answer
            return
        j = int(self._rng.integers(self._answered))
        if j < self.keep:
            del self.answers[self._slots[j]]
            self._slots[j] = i
            self.answers[i] = answer


def log(msg: str) -> None:
    print(f"[knnbench] {msg}", file=sys.stderr, flush=True)


def pick_device(chips: int):
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no card to measure")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} card(s), {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def note_skip_rate(cell, rates: list, kernel_stats) -> None:
    """Keep the fused kernel's pruning skip rate of one search in a traced
    run (a 0-d tensor on the card, read once the window has closed); an
    untraced run keeps nothing."""
    if cell.traced and kernel_stats is not None and "prune_skip_rate" in kernel_stats:
        rates.append(kernel_stats["prune_skip_rate"])


class Cell:
    """A cell's program, data and entry, set up; every piece found by the
    name ``BENCHMARK.json`` and the traffic mix give it (spec.py)."""

    def __init__(self, name: str, seed: int, *, bench: dict | None = None,
                 device=None, cfg_override: dict | None = None,
                 mix_override: dict | None = None, traced: bool = False):
        self.phases = [("torch and harness imported", time.perf_counter())]
        from repro_torch.tuning import AutotuneCache, set_default_cache

        self.phases.append(("program imported", time.perf_counter()))
        self.bench = bench if bench is not None else spec.load_benchmark()
        self.work = spec.workload(self.bench, name)
        self.dev = device if device is not None else pick_device(self.work["chips"])
        self.name, self.seed, self.traced = name, int(seed), traced
        self.spans = tr.Spans(traced)
        self.cfg = dict(spec.config(self.bench, self.work["config"]), **(cfg_override or {}))
        self.mix = dict(spec.traffic(self.work["traffic"]), **(mix_override or {}))
        self.cell = spec.cell(name)
        self.k = traffic.k(self.mix)
        self.loop = spec.module("loops", self.mix["loop"])
        #: the most requests the loop can have waiting (None: no bound)
        self.pending = self.loop.pending(self.mix)
        # the planner's defaults: no tuned blocks are read or written
        set_default_cache(AutotuneCache(path=None))
        x = data.dataset(self.cfg, self.seed, self.dev)
        sync(self.dev)
        self.phases.append(("rows made", time.perf_counter()))
        engine_kw = dict(k=self.k, metric=self.cfg["metric"], backend=self.cfg["backend"],
                         device=self.dev, **self.mix.get("engine", {}))
        self.engine = spec.module("stores", self.mix["dataset"]).fit(self, x, engine_kw)
        del x
        sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        self.phases.append(("fitted", time.perf_counter()))
        self.pool = data.queries(self.cfg, self.seed, self.mix["query_pool"],
                                 self.dev).cpu().numpy()
        self.entry = spec.module("entries", self.mix["entry"]).make(self)
        self.phases.append(("entry set up", time.perf_counter()))

    def close(self) -> None:
        self.entry.close()
        self.engine = self.entry = None

    def window(self) -> Window:
        """An empty window that keeps the cell's sample of answers."""
        return Window(m=self.mix["queries_per_request"], keep=self.cell["answer_sample"],
                      seed=self.seed)

    def request(self, i: int, **kw):
        """Request number ``i``: its queries from the pool, the mix's
        request fields, and ``kw`` (the entry's own, such as arrival_s)."""
        from repro_torch import SearchRequest

        return SearchRequest(queries=traffic.queries_of(self.mix, self.pool, i),
                             **self.mix["request"], **kw)


class _Measure:
    """Energy meter and profiler around the window, when traced."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.meter = EnergyMeter(cell.dev.index or 0) if cell.traced else None
        self.prof = tr.profiler() if cell.traced else None
        self.summary = None
        self._span = None

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
            self.meter.start()
            self._start = time.perf_counter()
            self._span = torch.profiler.record_function(tr.WINDOW_SPAN)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            sync(self.cell.dev)
            self._span.__exit__(*exc)
            self.meter.stop()
            self.prof.__exit__(*exc)
        return False

    def read_trace(self) -> None:
        if self.prof is not None:
            self.summary = tr.summarize(tr.events(self.prof), self.cell.spans.done,
                                        self._start)
            self.prof = None


async def _set_up_and_drive(cell: Cell, seconds: float, t_start: float):
    """Warm the entry, open the window, drive the loop; (setup_s, window,
    measure, counters)."""
    entry = cell.entry
    await entry.start()
    try:
        await entry.warm()
        # the set-up's garbage is the benchmark's: the window starts without it
        gc.collect()
        setup_s = time.perf_counter() - t_start
        entry.reset()
        with _Measure(cell) as meas:
            w = await cell.loop.drive(cell, entry, seconds)
        return setup_s, w, meas, entry.counters()
    finally:
        await entry.stop()


def measure(name: str, seed: int, seconds: float, traced: bool, t_start: float, *,
            bench: dict | None = None, device=None, cfg_override: dict | None = None,
            mix_override: dict | None = None, dump: str | None = None) -> dict:
    """Set up the cell, run its window, read its metrics, check its answers;
    returns the result line's object."""
    cell = Cell(name, seed, bench=bench, device=device, cfg_override=cfg_override,
                mix_override=mix_override, traced=traced)
    setup_s, w, meas, counters = asyncio.run(_set_up_and_drive(cell, seconds, t_start))
    log("set-up phases (s from process start): " + ", ".join(
        f"{n} {t - t_start:.3f}" for n, t in cell.phases) + f", warmed {setup_s:.3f}")
    log(f"setup_s={setup_s:.4f} window_s={w.t_close - w.t_open:.4f} requests={w.requests} "
        f"failed={w.failed} queries={w.queries}")
    if w.late_ms:
        late = np.asarray(w.late_ms)
        log(f"generator late: median {np.median(late):.4f} ms, p95 "
            f"{np.percentile(late, 95):.4f} ms, max {late.max():.4f} ms")
    skips = [float(r) for r in cell.entry.skip_rates] if traced else []
    if skips:
        log(f"kernel pruning skip rate over {len(skips)} searches: mean {np.mean(skips):.6f}, "
            f"min {min(skips):.6f}, max {max(skips):.6f}")
    if dump:
        times = counters.get("dispatch_times")
        with open(dump, "w") as f:
            json.dump({"latencies_ms": w.latencies_ms, "late_ms": w.late_ms,
                       "dispatches": None if times is None else
                       [(a - w.t_open, b - w.t_open, r)
                        for (a, b), r in zip(times, cell.entry.rows)],
                       "setup_s": setup_s}, f)
    meas.read_trace()
    peak = torch.cuda.max_memory_allocated(cell.dev) if cell.dev.type == "cuda" else 0
    rec = Record(cfg=cell.cfg, k=cell.k, setup_s=setup_s, window_s=w.t_close - w.t_open,
                 requests=w.requests, failed=w.failed, queries=w.queries,
                 latencies_ms=w.latencies_ms, searches=list(cell.entry.rows),
                 dispatches=counters.get("dispatches"), skip_rates=skips,
                 trace=meas.summary, energy_j=meas.meter.joules if meas.meter else None)
    if meas.meter is not None:
        log(f"card power limit {meas.meter.power_limit_w} W; energy read by {meas.meter.how}")
    metrics = {}
    for m in spec.metrics_for(cell.bench, name, traced):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cell.dev.type == "cuda" else cell.dev.type,
              "kind": torch.cuda.get_device_name(cell.dev) if cell.dev.type == "cuda" else "cpu",
              "count": cell.work["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced and rec.trace is not None:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        breakdown = {"device_ops": rec.trace["device_ops"], "idle_gaps": rec.trace["idle_gaps"]}
    cfg, cellf, mix, k, dev = cell.cfg, cell.cell, cell.mix, cell.k, cell.dev
    cell.close()
    del cell
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    correct, checks = check(cfg, cellf, mix, seed, k, dev, w)
    log(f"check of the answers took {time.perf_counter() - t0:.2f} s")
    out = {"correct": correct, "attempted": w.requests, "failed": w.failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def check(cfg: dict, cellf: dict, mix: dict, seed: int, k: int, dev, w: Window) -> tuple:
    """Compare the window's sample of answers with the reference, which is
    given the same queries the program was given."""
    chosen = sorted(w.answers)
    if chosen:
        scores = torch.cat([w.answers[i][0].reshape(-1, k) for i in chosen]).numpy()
        ids = torch.cat([w.answers[i][1].reshape(-1, k) for i in chosen]).numpy()
        rows = torch.as_tensor(traffic.pool_index(mix, chosen).reshape(-1), device=dev)
        queries = data.queries(cfg, seed, mix["query_pool"], dev)[rows]
        ref = reference.exact(cfg, seed, queries, k, torch.as_tensor(ids, device=dev))
        ref = {key: v.cpu().numpy() for key, v in ref.items() if key != "ids"}
        nums = compare.numbers(scores, ids, cfg["n"], ref, w.failed)
    else:
        nums = {"unanswered": w.failed, "malformed": 0, "score_err": float("nan"),
                "rank_err": float("nan")}
    return compare.judge(nums, cellf["limits"])


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
