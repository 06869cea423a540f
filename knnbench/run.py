"""Run one cell of the benchmark and print its result line.

    python3 knnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device[, breakdown], checks);
the last lines of standard error give each compared number beside its
limit. Exits 2 without a result where there is no card, or fewer than the
cell asks for; 3 where jax or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed place inside the checkout
BUILD = ROOT / "build"
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def _finite(obj):
    """NaN and infinity have no JSON spelling: they print as null."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None,
                    help="also write the window's request latencies and dispatches to this file")
    args = ap.parse_args(argv)

    from knnbench import harness

    try:
        out = harness.measure(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                              dump=args.dump)
    except harness.NoDevice as e:
        harness.log(f"no result: {e}")
        return 2
    found = harness.forbidden_modules()
    if found:
        harness.log(f"no result: modules loaded that the port must not load: {found}")
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(out), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
