"""Find the knee of an open-loop cell: the highest offered rate that the
port keeps up with (answers at the offered rate, no backlog growing over
the window) with a 95th-percentile latency under a limit.

    python3 knnbench/sweep.py --workload <cell> --seed <n> --rates 200,400,...
        [--seconds 8] [--p95-limit-ms 100]

One process sets the cell up once and offers each rate in turn (Poisson
arrivals) for ``--seconds`` through the cell's own entry and loop. A rate keeps up when the
answers that came within the ``--seconds`` come at 99 % of the offered rate
or more, and the median latency of the last quarter of its requests is
within 1.5 times that of the first quarter. Run it once, on the card; the cell's mix file then fixes its rate
at 4/5 of the knee.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402

from knnbench import harness  # noqa: E402
from knnbench.stats import percentile  # noqa: E402


def keeps_up(w, rate: float, seconds: float) -> dict:
    lat = np.asarray(w.latencies_ms)
    q = max(1, len(lat) // 4)
    achieved = float(sum(t <= seconds for t in w.done_s)) / seconds
    growth = float(np.median(lat[-q:]) / np.median(lat[:q]))
    return {"offered": rate, "achieved": achieved, "failed": w.failed,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "late_p95_ms": percentile(w.late_ms, 95), "growth": growth,
            "keeps_up": bool(achieved >= 0.99 * rate and growth <= 1.5 and not w.failed)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--p95-limit-ms", type=float, default=100.0)
    args = ap.parse_args()
    cell = harness.Cell(args.workload, args.seed, device=harness.pick_device(1))
    if cell.mix["loop"] != "open":
        raise SystemExit("the sweep is for open-loop cells")
    entry = cell.entry

    async def sweep():
        rows = []
        await entry.start()
        try:
            await entry.warm()
            for rate in (float(r) for r in args.rates.split(",")):
                cell.mix["arrivals"] = [{"law": "poisson", "rate_per_s": rate}]
                entry.reset()
                w = await cell.loop.drive(cell, entry, args.seconds)
                row = keeps_up(w, rate, args.seconds)
                row["dispatch_rows_mean"] = float(np.mean(entry.rows))
                row["ok"] = bool(row["keeps_up"] and row["p95_ms"] < args.p95_limit_ms)
                rows.append(row)
                print(json.dumps(row), flush=True)
                await asyncio.sleep(1.0)
        finally:
            await entry.stop()
        return rows

    t0 = time.perf_counter()
    rows = asyncio.run(sweep())
    cell.close()
    good = [r["offered"] for r in rows if r["ok"]]
    knee = max(good) if good else None
    print(json.dumps({"knee_per_s": knee, "four_fifths": None if knee is None else 0.8 * knee,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
