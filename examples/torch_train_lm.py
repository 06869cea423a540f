"""End-to-end training driver on the port: a ~100M-param LM for a few
hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--params 100] [--device cpu]

Exercises the port's training substrate: config -> init -> WSD schedule ->
AdamW -> double-buffered data pipeline -> checkpointing -> fault supervisor
(with one injected failure to demonstrate restart). Runs on the CUDA device
unless ``--device cpu`` is given. The counterpart of
``examples/train_lm.py``, with its output lines.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import resolve_device
from repro_torch.data import DataPipeline, token_stream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, apply_updates, wsd_schedule
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault import FailureInjector, supervised_train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--params", type=int, default=100, choices=(10, 100),
                    help="target size, millions")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    if args.params == 100:  # ~100M: 12L x 512d, 32k vocab
        cfg = T.LMConfig(name="lm100m", n_layers=12, d_model=512, n_heads=8,
                         n_kv_heads=4, d_head=64, d_ff=1536, vocab=32768,
                         dtype=torch.float32, remat=False, flash_threshold=10**9)
    else:  # ~10M for quick runs
        cfg = T.LMConfig(name="lm10m", n_layers=6, d_model=256, n_heads=8,
                         n_kv_heads=4, d_head=32, d_ff=768, vocab=8192,
                         dtype=torch.float32, remat=False, flash_threshold=10**9)
    n_params = cfg.params_count()
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params), "
          f"batch={args.batch} seq={args.seq}, steps={args.steps}")

    params = T.init(torch.Generator(device).manual_seed(0), cfg, device).requires_grad_(True)
    opt_cfg = AdamWConfig(
        lr=wsd_schedule(3e-4, warmup=20, stable=args.steps // 2,
                        decay=args.steps // 3),
        moment_dtype="f32",
    )
    opt = adamw_init(params, opt_cfg)

    def train_step(state, batch):
        p, o = state
        (loss, metrics), grads = T.value_and_grad(p, cfg, batch)
        updates, o = adamw_update(grads, o, p, opt_cfg)
        p = apply_updates(p, updates)
        return (p, o), {"loss": loss, **metrics}

    stream = DataPipeline(
        token_stream(cfg.vocab, args.batch, args.seq, seed=0), depth=2, device=device)
    batch_cache = []
    it = iter(stream)

    def batches(step: int):
        while len(batch_cache) <= step:
            batch_cache.append(next(it))
        return batch_cache[step]

    with tempfile.TemporaryDirectory() as ckdir:
        mgr = CheckpointManager(ckdir, interval=50, keep=2)
        t0 = time.time()
        state, report = supervised_train(
            train_step, (params, opt), batches, args.steps, mgr,
            injector=FailureInjector(fail_at=(args.steps // 2,)),
        )
        dt = time.time() - t0

    tokens = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps / {tokens:,} tokens in {dt:.1f}s "
          f"({tokens/dt:,.0f} tok/s), restarts={report.restarts}")
    k = max(1, len(report.losses) // 6)
    traj = [round(float(np.mean(report.losses[i:i + k])), 3)
            for i in range(0, len(report.losses), k)]
    print(f"loss trajectory: {traj}")
    assert traj[-1] < traj[0], "loss must decrease"
    print("loss decreased; injected failure recovered via checkpoint restart")


if __name__ == "__main__":
    main()
