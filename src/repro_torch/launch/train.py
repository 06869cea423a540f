"""Training driver: --arch <id> end-to-end with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --smoke \\
        --steps 50 --ckpt-dir build/train_ckpt [--inject-failure 20] [--device cpu]

Composes: configs registry -> launch.steps cell -> launch.demo's seeded
params and per-step batches (the reference's draws) -> optim (AdamW with
the arch's moment precision, updated in place) -> checkpoint manager ->
runtime.fault supervisor (straggler detection + restart). Runs on the CUDA
device, and raises where there is none; ``--device cpu`` runs on the CPU.
The checkpoints go to ``--ckpt-dir``, by default ``build/train_ckpt`` under
the checkout.
"""
from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

DEFAULT_CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def build_batches(arch, cell, smoke: bool, device):
    """Step -> the batch the reference's ``materialize(seed=step)`` draws,
    drawn alone (no model is initialised for it), for a train cell of any
    family."""
    from repro_torch.launch.demo import gnn_batch, lm_batch, recsys_batch

    cfg = arch.smoke_model if smoke else arch.model
    draw = {"lm": lambda rng: lm_batch(rng, cfg.vocab, cell.inputs[2], device),
            "gnn": lambda rng: gnn_batch(rng, cell.inputs[2], device),
            "recsys": lambda rng: recsys_batch(rng, cfg, cell.inputs[2], device)}[arch.family]

    def batches(step: int):
        return draw(np.random.default_rng(step))

    return batches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.launch.demo import materialize
    from repro_torch.runtime.fault import FailureInjector, StragglerDetector, supervised_train

    device = resolve_device(None if args.device == "cuda" else args.device)
    arch = get_config(args.arch)
    shape = next(s for s in arch.shapes if s.kind.startswith("train"))
    cell, cargs = materialize(arch, shape, smoke=args.smoke, seed=0, device=device)
    params, opt_state = cargs[0], cargs[1]

    def step_fn(state, batch):
        p, o = state
        p, o, metrics = cell.fn(p, o, batch)
        return (p, o), metrics

    batches = build_batches(arch, cell, args.smoke, device)
    mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval, keep=2)
    injector = FailureInjector((args.inject_failure,)) if args.inject_failure else None
    det = StragglerDetector()

    t0 = time.time()

    def on_straggler(info):
        print(f"[straggler] step {info['step']}: {info['seconds']:.2f}s "
              f"vs mean {info['mean']:.2f}s", flush=True)

    state, report = supervised_train(
        step_fn, (params, opt_state), batches, args.steps, mgr,
        injector=injector, detector=det, on_straggler=on_straggler,
    )
    dt = time.time() - t0
    print(f"arch={args.arch} steps={report.steps_done} restarts={report.restarts} "
          f"stragglers={len(report.stragglers)} wall={dt:.1f}s")
    if report.losses:
        k = max(1, len(report.losses) // 5)
        print("loss trajectory:",
              [round(float(np.mean(report.losses[i:i+k])), 4)
               for i in range(0, len(report.losses), k)])
    return report


if __name__ == "__main__":
    main()
