"""Run cells several times, one process a run, and summarise the spread.

    python3 knnbench/series.py --cells <cell>[,<cell>...] --seeds <a>,<b>,...
        [--seconds S] [--trace 0|1] [--sets 1] [--out DIR]

Each run is ``knnbench/run.py`` as the benchmark's command runs it. Every
run's result line and the end of its standard error go to
``DIR/<cell>.<set>.<seed>.<trace>.{json,err}``. The summary gives each
metric's values, median and spread (the distance between the first and
third quartiles from ``statistics.quantiles(values, n=4)``, over the
median), setup_s's first run apart, and each compared number's largest
reading.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def run_one(cell: str, seed: int, seconds: float, trace: int, out: Path, tag: str,
            dump: bool = False) -> dict | None:
    cmd = [sys.executable, str(ROOT / "knnbench" / "run.py"), "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    if dump:
        cmd += ["--dump", str(out / f"{tag}.dump.json")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1200)
    wall = time.perf_counter() - t0
    (out / f"{tag}.err").write_text(p.stderr[-20000:])
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    (out / f"{tag}.json").write_text(line + "\n")
    try:
        res = json.loads(line)
    except json.JSONDecodeError:
        print(f"{tag}: exit {p.returncode}, no result; stderr ends:\n{p.stderr[-3000:]}", flush=True)
        return None
    res["wall_s"] = wall
    print(f"{tag}: exit {p.returncode} wall {wall:.1f}s correct={res['correct']} "
          f"attempted={res['attempted']} failed={res['failed']} "
          + " ".join(f"{k}={v['value']!r}" for k, v in res["metrics"].items())
          + " | " + " ".join(f"{k}={v['value']!r}" for k, v in res["checks"].items())
          + f" | peak={res['device']['memory_peak_bytes']}"
          + (f" busy={res['device'].get('busy_s')} window={res['device'].get('window_s')}"
             if "busy_s" in res["device"] else ""), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "knnbench"))
    ap.add_argument("--dump", type=int, default=0,
                    help="1: also keep each run's request latencies and dispatches")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for cell in args.cells.split(","):
        results = []
        for s in range(args.sets):
            for seed in seeds:
                res = run_one(cell, seed, args.seconds, args.trace, out,
                              f"{cell}.{s}.{seed}.{args.trace}", bool(args.dump))
                if res is not None:
                    results.append((s, res))
        print(f"== {cell}: {len(results)} runs", flush=True)
        names = sorted({k for _, r in results for k in r["metrics"]})
        for name in names:
            for s in range(args.sets):
                vals = [r["metrics"][name]["value"] for si, r in results
                        if si == s and name in r["metrics"]]
                if name == "setup_s" and s == 0 and vals:
                    print(f"   {name} set {s} first run {vals[0]!r} (apart)")
                    vals = vals[1:]
                if vals:
                    sp = spread(vals)
                    print(f"   {name} set {s}: median {statistics.median(vals)!r} spread "
                          f"{sp!r} values {vals}")
        for name in sorted({k for _, r in results for k in r["checks"]}):
            vals = [r["checks"][name]["value"] for _, r in results]
            vals = [v for v in vals if v is not None]
            print(f"   check {name}: max {max(vals) if vals else None!r} values {vals}")
        print(f"   correct: {sum(r['correct'] for _, r in results)}/{len(results)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
