"""Multi-pod dry run: build every (architecture x shape) cell on the
production meshes and record, per device, the bytes its sanitized specs
place there.

The reference lowers and compiles each cell with XLA and records XLA's
memory and cost analyses. An eager PyTorch program has no compile, so the
port builds each cell under a production mesh of ``"meta"`` positions
(``launch/mesh.py``): the parameters, optimizer state, caches and batches
are meta tensors and the mesh places nothing, so the dry run allocates
nothing and needs no card. From the cell's inputs, its outputs' shapes and
its specs (each sanitized against its leaf's shape) it records:

* per-device argument and output bytes; donated inputs (a train step's
  parameters and optimizer state, a decode step's cache) are counted once,
  as the reference's ``alias`` bytes take them out;
* whether they fit one H100's HBM (``roofline/hw.py::H100_SXM``);
* roofline terms from ``cell.meta["model_flops"]`` (compute) and the bytes
  above read or written once (memory).

XLA's temporaries (``memory_analysis().temp_size_in_bytes``), its
``cost_analysis`` and the collectives it reads off the HLO have no
counterpart here: those fields are written as ``null`` with a note saying
why. No field stands for an XLA number.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs N] [--force]

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: what the port cannot measure without XLA, written beside the nulls
NO_XLA = ("an eager PyTorch program has no XLA compile: no buffer assignment "
          "(temporaries), no cost_analysis and no HLO collectives to read")
#: the donated positional arguments of each kind (the reference's donate_argnums)
DONATE = {"train": (0, 1), "train_sampled": (0, 1), "train_batched": (0, 1), "decode": (1,)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def output_shapes(cell):
    """The step's outputs as meta tensors, in ``cell.out_specs``' layout."""
    from repro_torch.core.topk import TopK

    f32, i32 = torch.float32, torch.int32
    kind = cell.kind
    if kind in DONATE and kind != "decode":  # train: (params, opt, metrics)
        metrics = {name: _meta((), f32) for name in cell.out_specs[2]}
        return (cell.inputs[0], cell.inputs[1], metrics)
    if cell.meta["family"] == "lm":
        cfg = cell.inputs[0].cfg
        b = cell.inputs[1].shape[0] if kind == "prefill" else cell.inputs[2].shape[0]
        logits = _meta((b, cfg.vocab_padded), f32)
        if kind == "decode":
            return (logits, cell.inputs[1])
        kv = _meta((cfg.n_layers, b, cell.meta["seq"], cfg.n_kv_heads, cfg.d_head), cfg.dtype)
        return (logits, {"k": kv, "v": kv, "len": 0})
    if kind == "serve":
        return _meta((cell.meta["batch"],), f32)
    m = cell.inputs[1].shape[0] if kind == "retrieval" else cell.inputs[0].shape[0]
    k = cell.meta["k"] if kind != "retrieval" else 100  # a full-size retrieval cell's k
    return TopK(_meta((m, k), f32), _meta((m, k), i32))


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes of ``tree``'s tensors on one device of ``mesh`` under ``specs``
    (each sanitized against its leaf; None or P() replicates)."""
    from repro_torch.runtime.sharding import P, sanitize_spec
    from repro_torch.tree import reference_layout, tree_map

    sizes = dict(mesh.shape)
    total = 0

    def one(x, sp):
        nonlocal total
        if not (isinstance(x, torch.Tensor) or hasattr(x, "parts")):
            return  # a host int (the cache's length) holds no device memory
        sp = sanitize_spec(tuple(x.shape), P() if sp is None else sp, sizes)
        split = math.prod(math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else e))
                          for e in sp if e is not None)
        total += math.prod(x.shape) * x.dtype.itemsize // split

    if specs is None:
        tree_map(lambda x: one(x, None), reference_layout(tree))
    else:
        tree_map(one, reference_layout(tree), specs)
    return total


def run_cell(arch_id: str, shape_name: str, mesh_kind: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import use_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.analysis import roofline_terms
    from repro_torch.roofline.hw import H100_SXM

    arch = get_config(arch_id)
    shape = arch.shape(shape_name)
    n = 512 if mesh_kind == "multi" else 256
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), devices=["meta"] * n)
    chips = mesh.size

    t0 = time.time()
    with use_mesh(mesh):
        cell = build_cell(arch, shape, smoke=False)
    t_build = time.time() - t0

    donate = DONATE.get(shape.kind, ())
    args = sum(per_device_bytes(x, sp, mesh) for x, sp in zip(cell.inputs, cell.in_specs))
    outs = per_device_bytes(output_shapes(cell), cell.out_specs, mesh)
    alias = sum(per_device_bytes(cell.inputs[i], cell.in_specs[i], mesh) for i in donate)
    per_device = args + outs - alias
    flops = float(cell.meta.get("model_flops", 0))
    roof = roofline_terms(flops, float(per_device) * chips, 0.0, chips, model_flops=flops,
                          hw=H100_SXM, peak="bf16" if arch.family == "lm" else "f32")
    roof = roof.to_dict()
    roof.update(collective_s=None, wire_bytes_per_device=None, collective_ops=None,
                note="compute: meta['model_flops'] over the peak (bf16 for the LMs, f32 "
                     "elsewhere); memory: per_device_bytes read or written once over the "
                     "HBM rate; no collective term: " + NO_XLA)
    return {
        "arch": arch_id, "shape": shape_name, "kind": shape.kind,
        "mesh": mesh_kind, "chips": chips, "ok": True,
        "build_s": round(t_build, 2),
        "memory_analysis": {
            "argument_bytes": args,
            "output_bytes": outs,
            "alias_bytes": alias,
            "temp_bytes": None,
            "per_device_bytes": per_device,
            "fits_h100_hbm": bool(per_device <= H100_SXM.hbm_bytes),
            "hbm_utilization": per_device / H100_SXM.hbm_bytes,
            "note": "argument, output and alias bytes from the sanitized specs; "
                    "temp_bytes null: " + NO_XLA,
        },
        "cost_analysis": None,
        "cost_analysis_note": NO_XLA,
        "probes": None,
        "roofline": roof,
        "meta": {k: (v if isinstance(v, str) else int(v)) for k, v in cell.meta.items()},
    }


def save(record: dict) -> pathlib.Path:
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    path = ARTIFACTS / name.replace("/", "_")
    path.write_text(json.dumps(record, indent=2, default=str))
    return path


def orchestrate(mesh_kinds, jobs: int, archs=None, force=False) -> int:
    """Run every cell in its own subprocess (crash isolation)."""
    from repro_torch.configs import ALL_ARCHS, get_config

    work = []
    for arch_id in archs or ALL_ARCHS:
        cfg = get_config(arch_id)
        for shape in cfg.shapes:
            for mk in mesh_kinds:
                out = ARTIFACTS / f"{arch_id}__{shape.name}__{mk}.json"
                if force or not out.exists() or not json.loads(out.read_text()).get("ok"):
                    work.append((arch_id, shape.name, mk))
    print(f"dry-run: {len(work)} cells to build", flush=True)
    procs = []
    failed = []

    def drain(limit: int):
        while True:
            for w, p in list(procs):
                if p.poll() is not None:
                    procs.remove((w, p))
                    if p.returncode != 0:
                        failed.append(w)
                    print(f"{'ok  ' if p.returncode == 0 else 'FAIL'} {w[0]}/{w[1]}/{w[2]}",
                          flush=True)
            if len(procs) < limit:
                return
            time.sleep(0.5)

    for w in work:
        drain(jobs)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", w[0], "--shape", w[1], "--mesh", w[2]]
        procs.append((w, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                          stderr=subprocess.DEVNULL)))
    drain(1)
    if failed:
        print(f"{len(failed)} FAILED: {failed}", flush=True)
        return 1
    print("all cells built", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        return orchestrate(mesh_kinds, args.jobs, force=args.force)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    try:
        rec = run_cell(args.arch, args.shape, mesh_kinds[0])
        print(json.dumps(rec["memory_analysis"]))
        print(f"wrote {save(rec)}")
        return 0
    except Exception:
        save({"arch": args.arch, "shape": args.shape, "mesh": mesh_kinds[0],
              "ok": False, "error": traceback.format_exc()})
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
