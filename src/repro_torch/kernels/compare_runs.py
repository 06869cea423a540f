"""Run ``chip_smoke.py`` of two checkouts in alternation on one card and
summarise the kernels' times.

    python -m repro_torch.kernels.compare_runs OTHER_ROOT [--pairs 5]
        [--phases int8,kernels,gist,msmarco] [--one-script] [--out DIR]
    python -m repro_torch.kernels.compare_runs --summarise-only --out DIR

Each of ``--pairs`` rounds runs the other checkout, this one, this one and
the other again (other, this, this, other), each as its own
``python3 chip_smoke.py --phases ...`` process, and keeps every run's log
under ``--out``. Each checkout runs its own chip_smoke.py, or, with
``--one-script``, this checkout's drives both packages (``--package``), so
that shapes only this script times are timed on the other's kernels too.
Then it prints, per kernel and shape and per side, the median and
[min-max] of the runs' CUDA-event times (``ms``, with the plain version's
``plain_ms`` and the library call's ``library_ms`` beside), and the same
for the per-shape extras chip_smoke.py logs (the keys of ``MARKERS``), and
writes them to ``summary.json`` there. A run that fails stops the comparison;
``--summarise-only`` summarises the logs a comparison left. Running needs
the card, as chip_smoke.py does.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


MARKERS = {"search_ms": "search ms median=", "f32_scan_ms": "f32 knn_scan at this shape ",
           "topk_with_merges_ms": "topk scan + merges ms=",
           "cdist_direct_ms": "cdist direct form ms=", "stream_ms": "stream_ms=",
           "tiled_ms": "tiled_ms="}


def run(root: Path, phases: str, log: Path, one_script: bool = False) -> None:
    """One chip_smoke.py run in `root` (this checkout's script driving
    root's package when `one_script`), its output kept in `log`."""
    cmd = ([str(ROOT / "chip_smoke.py"), "--package", str(root)] if one_script
           else ["chip_smoke.py"])
    res = subprocess.run([sys.executable, *cmd, "--phases", phases], cwd=root,
                         capture_output=True, text=True)
    log.write_text(res.stdout + res.stderr)
    if res.returncode:
        raise RuntimeError(f"chip_smoke.py in {root} exited {res.returncode}; see {log}")


def records(log: Path) -> list[dict]:
    """The per-shape times of one run's log: each kernel's ms from the
    {"kernels": ...} line, and the extras from the shape's log lines."""
    text = log.read_text().splitlines()
    shapes: dict[str, dict] = {}
    line = next(ln for ln in text if ln.startswith('{"kernels"'))
    for k in json.loads(line)["kernels"]:
        for per in k["shapes"]:
            rec = shapes.setdefault(per["shape"], {})
            rec[k["name"]] = per["ms"]
            rec[k["name"] + ":plain_ms"] = per["plain_ms"]
            rec[k["name"] + ":library_ms"] = per["library_ms"]
    for ln in text:
        for key, marker in MARKERS.items():
            if marker in ln:
                label = ln.split(":", 1)[0]
                value = ln.split(marker)[1].split()[0].rstrip(";")
                shapes.setdefault(label, {})[key] = float(value)
    return [{"shape": s, **v} for s, v in shapes.items()]


def summary(values: list[float]) -> str:
    return f"{statistics.median(values):.4f} [{min(values):.4f}-{max(values):.4f}]"


def summarise(out: Path) -> list[dict]:
    """Median and [min-max] per shape, quantity and side over the logs
    pair<p>_<n>_<side>.log in `out`."""
    times: dict[tuple[str, str, str], list[float]] = defaultdict(list)
    for log in sorted(out.glob("pair*_*_*.log")):
        side = log.stem.rsplit("_", 1)[1]
        for rec in records(log):
            for key, value in rec.items():
                if key != "shape" and value is not None:
                    times[(rec["shape"], key, side)].append(value)
    rows = []
    for shape, key in sorted({(s, k) for s, k, _ in times}):
        this, other = times.get((shape, key, "this"), []), times.get((shape, key, "other"), [])
        row = {"shape": shape, "what": key, "runs": [len(this), len(other)],
               "this": summary(this) if this else None, "other": summary(other) if other else None}
        if this and other:
            row["this/other"] = round(statistics.median(this) / statistics.median(other), 4)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?", help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--phases", default="int8,kernels,gist,msmarco")
    ap.add_argument("--one-script", action="store_true",
                    help="run this checkout's chip_smoke.py on both packages")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "compare_runs")
    ap.add_argument("--summarise-only", action="store_true",
                    help="summarise the logs already in --out")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    if not args.summarise_only:
        if args.other is None:
            ap.error("the other checkout's root is needed to run")
        order = [("other", args.other.resolve()), ("this", ROOT), ("this", ROOT),
                 ("other", args.other.resolve())]
        for p in range(args.pairs):
            for n, (side, root) in enumerate(order):
                run(root, args.phases, args.out / f"pair{p}_{n}_{side}.log", args.one_script)
                print(f"pair {p} run {n} ({side}) done", flush=True)
    rows = summarise(args.out)
    for row in rows:
        print(json.dumps(row), flush=True)
    (args.out / "summary.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
