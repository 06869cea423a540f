"""The control of a cell's comparison: the reference computed in the
precision below the configuration's (TF32 for f32), put in the program's
place, judged by the same comparison. It has to come out not correct.

    python3 knnbench/control.py --workload <cell> --seeds <a>,<b>,<c>

It answers the first ``answer_sample`` requests of the cell's mix (as many
as a run compares) at the cell's own size, and prints each compared number
beside the cell's limit. The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from knnbench import compare, data, reference, spec, traffic  # noqa: E402


def control(name: str, seed: int, device, cfg_override: dict | None = None,
            mix_override: dict | None = None, requests: int | None = None) -> tuple[bool, dict]:
    """(correct, checks) of the control of cell ``name`` on ``seed``, over
    ``requests`` requests (the cell's ``answer_sample`` by default)."""
    bench = spec.load_benchmark()
    work = spec.workload(bench, name)
    cfg = dict(spec.config(bench, work["config"]), **(cfg_override or {}))
    mix = dict(spec.traffic(work["traffic"]), **(mix_override or {}))
    cellf = spec.cell(name)
    k = traffic.k(mix)
    rows = traffic.pool_index(mix, range(requests or cellf["answer_sample"])).reshape(-1)
    queries = data.queries(cfg, seed, mix["query_pool"], device)[
        torch.as_tensor(rows, device=device)]
    scores, ids = reference.lower_precision(cfg, seed, queries, k)
    ref = reference.exact(cfg, seed, queries, k, ids)
    ref = {key: v.cpu().numpy() for key, v in ref.items() if key != "ids"}
    nums = compare.numbers(scores.cpu().numpy(), ids.cpu().numpy(), cfg["n"], ref, 0)
    return compare.judge(nums, cellf["limits"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ok, checks = control(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": ok,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
