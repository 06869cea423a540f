#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                  # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --phases exact   # build + the named phases only
    python3 chip_smoke.py --package OTHER  # drive another checkout's package

Phases, in order (any failure makes the run exit non-zero):

1. build   — nvcc builds the kernel library from src/repro_torch/kernels/csrc
             into build/repro_torch/, one process per source (seconds printed).
2. exact   — every kernel against its plain version on integer-valued data,
             bit for bit: knn_scan, knn_merge and knn_fused (values in [-8, 8]
             with planted duplicate rows, +inf-norm rows and a ragged N, for
             l2/ip/cos, f32 and bf16, k in {1, 7, 72, 1024}, m in {1, 16}, and
             in two adversarial row orders for l2/ip, f32 and bf16, k in
             {1, 72, 1024}, m in {1, 16}: farthest from query 0 first, so the
             survivor buffer overflows, and all rows equal, so only index
             ties decide); knn_merge alone on queues built to stress its
             threshold (every answer pair in one queue, most queues empty,
             all values equal, integer ties with -0.0/+0.0) at (m, S, k) up
             to (16, 123, 8192), one launch per call; knn_int8_scan (rows
             in [-127, 127] whose int8 scale is 1, so only sqrt and the
             square round, k in {1, 7, 72, 1024}: q_len 8 to
             8192, m in {1, 16}, codes never padded to the n-block; rows in
             random order, farthest from query 0 first so that every lane
             survives the filter and its buffer overflows, and all equal so
             that only index ties decide; at the card's S and at S = 1);
             l2dist (f32 and bf16, m in {1, 16, 37, 300}: both sides of
             the stream/tiled crossover, ragged against the 128-row tiles,
             ragged N; through the entry point and each of its two kernels,
             one launch each); topk (k in
             {1, 72, 1024}, ragged M and N: integer scores with ties and
             -0.0/+0.0, scores descending along N, all equal, +inf lanes).
             Values, indices and skip counts must be bit-identical (d = 960:
             every sum is below 2^24).
3. gist    — GIST shape, FQ-SD: N = 1,000,000, d = 960, m = 16, k = 1024
             through ExactKNN(backend="cuda").fit(x).search(...).
4. msmarco — MS-MARCO shape, FD-SQ: N = 8,841,823, d = 769, m = 1, k = 72
             and k = 1024, the dataset generated and padded on the card.
5. int8    — the certified int8 tier, FQ-SD, m = 16, through
             ExactKNN(...).enable_int8().search(SearchRequest(tier="int8")):
             MS-MARCO at k = 72 (q_len 1024) on phase 4's resident dataset,
             then GIST at k = 1024 (q_len 8192). Every returned row must be
             bit-identical to the port's knn_exact_direct (certified rows come
             from the rescore, the others from the fallback); the certified
             share, the scan, merge, rescore and fallback times are printed.
6. streamed — out-of-core FQ-SD at the GIST shape (phase 3's data, seed 3):
             the rows made on the card, then kept in a pinned host store of
             16 shards of 65,536 rows (1,048,576 padded, 4.29 GB of f32 a
             search ships) with its int8 tier quantised shard by shard on
             the card (1.07 GB of codes + 12.6 MB of channels), searched
             through ExactKNN(backend="cuda").fit_store(store,
             resident=False): fqsd-mmap-streamed (f32) and
             fqsd-int8-streamed, at prefetch_depth 1 and 2. Prints the host
             RAM, the pinned copy rate of one shard (CUDA events, median of
             10; the phase's bound is bytes shipped over it), and per search
             the host-clock median of 10 (each ending in a synchronise),
             transfers, bytes, GB/s and share of the copy rate, the
             copy-only time of the same shards, the compute-only time of
             the per-shard steps on device-resident copies, and the
             launches per search; int8 at the default spec_trigger (0.5)
             and, at depth 2, at 1.0 (no speculation), with the
             scan/gather/rescore split, the speculation counters at 0.0,
             0.5 and 1.0 and the certified share. Checks: (a) the f32 result is
             bit-identical to a resident fdsq-cuda search over the same
             store; (b) the int8 result is bit-identical to
             streamed_direct_scan over the store and to the resident
             fqsd-int8-cuda result wherever both are certified; (c) each
             per-shard kernel step equals its plain step (knn_scan_plain /
             knn_int8_scan_plain + knn_merge_plain) on one shard; (d) the
             results at spec_trigger 0.0, 0.5 and 1.0 are bit-identical;
             (e) the card is the H100 the bounds are stated for.
7. mmap    — phase 6's data written as a store in files under build/
             (DatasetStore.from_array(x, rows_per_shard=65,536,
             directory=...) + its int8 tier quantised on the card, about
             5.4 GB), reopened with DatasetStore.open(verify=True) and
             searched through fit_store(store, resident=False):
             fqsd-mmap-streamed and fqsd-int8-mmap-streamed at
             prefetch_depth 1 and 2, each result (values, indices,
             certificates, transfers, bytes_scanned) bit-identical to the
             same rows in a pinned host-RAM store, then one f32 search with
             verify_on_read. Prints, as measurements: the filesystem, the
             read rate of one shard file after a page-cache drop
             (posix_fadvise) and warm, the mapping -> page-locked staging
             rate (the double buffer's own copy, at 1 thread and at its
             default), the page-locked -> card rate, and per search the
             cold time (after a cache drop) and the warm median beside the
             staging-only bound (bytes shipped over the staging rate); then
             check (c) of phase 6 on two shards read from the mapping. The
             directory is deleted at the end, whatever the outcome.
8. kernels — the standalone entry points: l2dist at (16, 1,000,000, 960),
             then topk over that (16, 1,000,000) matrix at k = 1024; then
             l2dist alone at (M, 1,000,000, 960) for M = 1, 16 (f32), 16
             (bf16) and 256 (f32), each one launch with the counters at 0,
             beside torch.cdist's matrix-product form; and both l2dist
             kernels at M = 16 to 128 (the crossover, printed only).

Phases 3-8 are the main path. The launch counters are set to 0 just before
each search (phase 8: before l2dist + topk, and before each l2dist shape)
and read just after; every
kernel of the path must have launched, knn_merge exactly once (phases 6
and 7: once a shard, beside knn_scan or knn_int8_scan once a shard). Each result
is held against the plain version on the same padded operands within
TOL_REL·(qn + max xn) per score (f32 sums over d terms taken in another
order), with indices equal wherever the plain scores around them are more
than twice that apart; topk
and the merges move values without arithmetic and must be bit-identical.
Each kernel is timed with CUDA events (median of REPEATS after a warm-up;
l2dist's shapes over runs of 5 calls back to back, per call) beside its
plain version, one PyTorch call computing the same function (a
yardstick the port never calls; none exists for the int8 scan, whose
yardstick is the f32 knn_scan at the same shape, printed as f32_scan_ms),
and its bound on this card. bound_ms is the function's own work: its
unpadded inputs read once, its result written once, and its arithmetic
(2·d + the epilogue per pair for the scans, 2·d per pair for l2dist, one
comparison per element for the selections), whichever takes longer; bytes
count each operand at its element size. knn_merge's inputs are sorted, so
its function reads only the queued pairs below the answer's last one and
one pair past them in each queue (at most S + k a row, of S·k), one
comparison each, and writes the answer. The scans and topk also print
design_bound_ms, the same over the work each design does: the padded
operands (rows once per m-tile), the per-block queues, and the survivor
filter's sorts, rank searches and merges as the kernel counts them
(select.cuh's counters, with the survivors and the share of lanes that
survived printed beside). topk
is also timed with its merges (topk_with_merges_ms) beside torch.topk. The
bounds are stated for the H100 SXM (CARD); on any other card the run stops
before it measures.

Output: progress lines, the card's name and power limit as nvidia-smi gives
them, one {"kernels": [...]} line (per kernel: launches, ms, plain_ms,
library_ms and bound_ms summed over the main path's runs, one of each shape,
with the per-shape numbers under "shapes"; phase 6's and 7's shapes give
one shard's launch), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPEATS = 5
#: Score tolerance, relative to qn + max xn: the rounding of a length-d f32
#: dot product summed in two different orders is about sqrt(d)·2^-24 of
#: |q||x| <= (qn + xn) / 2; at d = 960 that is ~1e-6, so 1e-5 leaves a
#: margin of ten.
TOL_REL = 1e-5
#: The card the bounds are stated for, with its memory rate (bytes/s) and
#: f32 non-tensor peak (FLOP/s): NVIDIA's data sheet for the H100 SXM, dense
#: rates at the full 700 W. Any other card stops the run before it measures.
CARD, PEAK_BW, PEAK_F32 = "NVIDIA H100 80GB HBM3", 3.35e12, 67e12
_CSRC = "src/repro_torch/kernels/csrc/"
#: kernel -> (its CUDA source, the TPU kernel it replaces), in line order
KERNELS = {
    "knn_scan": (_CSRC + "knn.cu", "src/repro/kernels/knn/kernel.py:121"),
    "knn_merge": (_CSRC + "knn.cu", "src/repro/kernels/knn/kernel.py:121"),
    "knn_int8_scan": (_CSRC + "knn_int8.cu", "src/repro/kernels/knn/kernel_int8.py:116"),
    "l2dist": (_CSRC + "l2dist.cu", "src/repro/kernels/l2dist/kernel.py:58"),
    "topk": (_CSRC + "topk.cu", "src/repro/kernels/topk/kernel.py:57"),
}
#: Shapes of the phases (paper Table 2 via src/repro/configs/knn_paper.py).
EXACT = dict(n=12_345, d=960, ks=(1, 7, 72, 1024), ms=(1, 16), topk_ks=(1, 72, 1024),
             l2dist_ms=(1, 16, 37, 300))
GIST = dict(n=1_000_000, d=960, m=16, k=1024)
MSMARCO = dict(n=8_841_823, d=769, m=1, ks=(72, 1024))
INT8 = dict(m=16, msmarco_k=72, gist_k=1024)
#: phase 7: the main path at (m, n, d), then l2dist alone at each (M, dtype)
#: of "l2dist" and both of its kernels at the batches of "crossover_ms",
#: each timed (beside its plain version and library call) over runs of
#: "calls" calls back to back
STANDALONE = dict(n=1_000_000, d=960, m=16, k=1024,
                  l2dist=((1, "float32"), (16, "float32"), (16, "bfloat16"), (256, "float32")),
                  crossover_ms=(16, 32, 48, 64, 80, 96, 112, 128), calls=5)
#: phase 6: phase 3's GIST data in pinned host shards, streamed
STREAMED = dict(n=1_000_000, d=960, m=16, k=1024, rows_per_shard=65_536, seed=3,
                depths=(1, 2), triggers=(0.0, 0.5, 1.0), repeats=10)
#: phase 7: phase 6's data as a store in files under build/, streamed from
#: its mappings
MMAP = dict(n=1_000_000, d=960, m=16, k=1024, rows_per_shard=65_536, seed=3,
            depths=(1, 2), repeats=5)
#: f32 operations per (query, row) pair in the l2 epilogue: double, subtract,
#: add, clamp; in the int8 epilogue: scale, double, subtract, add, clamp,
#: sqrt, subtract, clamp, square
L2_EPILOGUE_OPS, INT8_EPILOGUE_OPS = 4, 9


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch, dev, card: str = ""):
        from repro_torch.kernels.knn import kernel as K, ops

        self.torch, self.K, self.ops, self.dev = torch, K, ops, dev
        self.card = card  # nvidia-smi's name and power limit, beside every time
        self.bw, self.flops = PEAK_BW, PEAK_F32
        self.shapes: list[dict] = []  # one per main-path search
        self.msmarco_eng = None  # phase 4's engine, quantised by phase 5

    # ------------------------------------------------------------ helpers
    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def ms(self, fn, repeats: int = REPEATS, calls: int = 1) -> float:
        """Median CUDA-event time of fn over `repeats` runs after a warm-up;
        with `calls` > 1 each run is that many calls back to back, timed
        together and divided by `calls`, so the host's time to launch a
        call hides behind the previous one."""
        torch = self.torch
        fn()
        self.sync()
        times = []
        for _ in range(repeats):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    def bound(self, nbytes: float, ops: float) -> tuple[float, str]:
        t_b, t_o = nbytes / self.bw * 1e3, ops / self.flops * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    @staticmethod
    def merge_work(sv, si, av, ai) -> tuple[int, int]:
        """The bytes and comparisons that merging the sorted (m, S, k)
        queues (sv, si) into their answer (av, ai) needs on this data: per
        row, every pair of each queue strictly below the answer's last pair
        (all of them reach the answer) and one more pair of each queue not
        read to its end (to see it stop), read once, and the (m, k) answer
        written once; one comparison per pair read. At most (S + k) pairs a
        row are read, of the S·k queued."""
        from repro_torch.core.topk import pair_keys

        last = pair_keys(av[:, -1:], ai[:, -1:])[:, :, None]
        below = (pair_keys(sv, si) < last).sum(-1)
        read = int((below + 1).clamp(max=sv.shape[-1]).sum())
        return read * 8 + av.numel() * 8, read

    @staticmethod
    def select_work(stats, k: int, lanes: int) -> dict:
        """The survivor filter's work from a kernel's counters (select.cuh):
        survivors, passes, comparisons of the survivor sorts and queue pairs
        moved by the merges, summed over the blocks; its operations add a
        log2(k)-probe rank search per survivor. `lanes` is the number
        of (query, row) lanes the filter saw."""
        survivors, passes, comps, moved = (int(v) for v in stats.sum(dim=(0, 1)).tolist())
        return {"survivors": survivors, "survivor_fraction": survivors / lanes,
                "passes": passes, "sort_comparisons": comps, "pairs_moved": moved,
                "ops": comps + moved + survivors * max(1, int(math.log2(k)))}

    # ------------------------------------------------------ phase 2: exact
    def _pow2_rows(self, n, d, g):
        """Integer rows in [-8, 8] whose norms are powers of two, so their
        L2-normalised form (cos) is exact in f32 and bf16."""
        torch = self.torch
        counts = torch.tensor([1, 4, 16, 64], device=self.dev)[
            torch.randint(0, 4, (n,), generator=g, device=self.dev)]
        ranks = torch.rand(n, d, generator=g, device=self.dev).argsort(1).argsort(1)
        signs = torch.randint(0, 2, (n, d), generator=g, device=self.dev) * 2 - 1
        x = ((ranks < counts[:, None]) * signs).to(torch.float32)
        eight = torch.rand(n, generator=g, device=self.dev) < 0.1  # a single ±8
        x[eight] = ((ranks[eight] == 0) * signs[eight] * 8).to(torch.float32)
        return x

    def phase_exact(self) -> bool:
        torch, ops = self.torch, self.ops
        g = torch.Generator(device=self.dev).manual_seed(2)
        n, d = EXACT["n"], EXACT["d"]
        ints = torch.randint(-8, 9, (n, d), generator=g, device=self.dev).to(torch.float32)
        cos_rows = self._pow2_rows(n, d, g)
        for x in (ints, cos_rows):  # planted duplicates: exact ties
            x[n // 2] = x[17]
            x[n - 3] = x[17]
            x[n - 1] = x[3]
        inf_rows = torch.tensor([100, n // 4, n - 2], device=self.dev)
        q_int = torch.randint(-8, 9, (max(EXACT["ms"]), d), generator=g,
                              device=self.dev).to(torch.float32)
        q_int[0] = ints[17]
        q_cos = self._pow2_rows(max(EXACT["ms"]), d, g)
        q_cos[0] = cos_rows[17]
        cases = fails = 0
        for metric in ("l2", "ip", "cos"):
            base, qb = (cos_rows, q_cos) if metric == "cos" else (ints, q_int)
            xn = torch.sum(base * base, dim=-1)
            xn[inf_rows] = torch.inf
            if metric == "cos":  # exact: every norm is a power of two
                base = base / torch.sqrt(torch.sum(base * base, dim=-1, keepdim=True))
            for dtype in (torch.float32, torch.bfloat16):
                for k in EXACT["ks"]:
                    for m in EXACT["ms"]:
                        call = ops.prepare(qb[:m].to(dtype), base.to(dtype), k, metric, xn,
                                           x_prenormalized=metric == "cos")
                        bad = self._exact_case(call)
                        cases += 1
                        if bad:
                            fails += 1
                            log(f"  exact FAIL {metric} {dtype} k={k} m={m}: {bad}")
        log(f"phase exact: knn_scan {cases - fails}/{cases} cases bit-identical "
            f"(values, indices, skip counts)")
        ok = fails == 0
        for name, check in (("knn_scan adversarial", self._exact_scan_orders),
                            ("knn_merge", self._exact_merge),
                            ("knn_int8_scan", self._exact_int8), ("l2dist", self._exact_l2dist),
                            ("topk", self._exact_topk)):
            cases, bad = check(g)
            for b in bad:
                log(f"  exact FAIL {name} {b}")
            log(f"phase exact: {name} {cases - len(bad)}/{cases} cases bit-identical")
            ok &= not bad
        return ok

    def _exact_scan_orders(self, g):
        """The f32/bf16 scan on integer rows in [-8, 8] in two adversarial
        orders: farthest from query 0 first (by its metric), so every lane
        of every tile beats query 0's queue and the survivor buffer
        overflows (the multi-pass path), and every row equal, so only the
        index ties decide; l2 and ip, k in {1, 72, 1024}, m in {1, 16}."""
        torch, ops = self.torch, self.ops
        n, d = EXACT["n"], EXACT["d"]
        x = torch.randint(-8, 9, (n, d), generator=g, device=self.dev).to(torch.float32)
        q = torch.randint(-8, 9, (max(EXACT["ms"]), d), generator=g,
                          device=self.dev).to(torch.float32)
        q[0] = x[17]
        inf_rows = torch.tensor([100, n // 4, n - 2], device=self.dev)
        cases, bad = 0, []
        for metric in ("l2", "ip"):
            key = torch.sum((x - q[0]) ** 2, -1) if metric == "l2" else -(x @ q[0])
            orders = {"farthest_first": x[torch.argsort(key, descending=True, stable=True)],
                      "equal": x[17].expand(n, d).contiguous()}
            for order, rows in orders.items():
                xn = torch.sum(rows * rows, dim=-1)
                xn[inf_rows] = torch.inf
                for dtype in (torch.float32, torch.bfloat16):
                    for k in (1, 72, 1024):
                        for m in EXACT["ms"]:
                            cases += 1
                            call = ops.prepare(q[:m].to(dtype), rows.to(dtype), k, metric, xn)
                            problems = self._exact_case(call)
                            if problems:
                                bad.append(f"{order} {metric} {dtype} k={k} m={m}: {problems}")
        return cases, bad

    def _exact_merge(self, _g):
        """The one-launch merge on queues built to stress its threshold
        (``repro_torch.data.merge_cases``, seeded per case), at the main
        path's widths, one launch per call."""
        torch, K = self.torch, self.K
        from repro_torch.data.merge_cases import KINDS, merge_queues

        cases, bad = 0, []
        for kind in KINDS:
            for m, s, k in ((3, 7, 1), (1, 264, 128), (16, 245, 1024), (16, 123, 8192)):
                cases += 1
                v, i = merge_queues(kind, m, s, k, seed=cases, device=self.dev)
                K.reset_launch_counts()
                mv, mi = K.knn_merge(v, i)
                self.sync()
                pv, pi = K.knn_merge_plain(v, i)
                launches = K.LAUNCHES["knn_merge"]
                if not (torch.equal(mv, pv) and torch.equal(mi, pi)) or launches != 1:
                    bad.append(f"{kind} (m, S, k)=({m}, {s}, {k}) launches={launches}")
        return cases, bad

    def _exact_int8(self, g):
        """The int8 scan on rows whose scale is exactly 1 (integers in
        [-127, 127] with one entry at 127) and integer queries in [-8, 8],
        in three row orders: random; farthest from query 0 first, so every
        lane of every tile beats query 0's queue and the survivor buffer
        overflows (the multi-pass path); and every row equal, so only the
        index ties decide. q_len runs from 8 to 8192 (k = 1024: the
        widest queue)."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch.core.quantized import quantize_dataset

        n, d = EXACT["n"], EXACT["d"]
        x = torch.randint(-127, 128, (n, d), generator=g, device=self.dev).to(torch.float32)
        x[torch.arange(n, device=self.dev),
          torch.randint(0, d, (n,), generator=g, device=self.dev)] = 127.0
        x[n // 2] = x[17]
        x[n - 3] = x[17]
        q = torch.randint(-8, 9, (max(EXACT["ms"]), d), generator=g,
                          device=self.dev).to(torch.float32)
        q[0] = x[17]
        far = torch.argsort(torch.sum((x - q[0]) ** 2, dim=-1), descending=True, stable=True)
        orders = {"random": x, "farthest_first": x[far], "equal": x[17].expand(n, d)}
        cases, bad = 0, []
        for order, rows in orders.items():
            ds = quantize_dataset(rows.contiguous())
            ds.norms_sq[torch.tensor([100, n // 4, n - 2], device=self.dev)] = torch.inf
            for k in EXACT["ks"]:
                for m in EXACT["ms"]:
                    cases += 1
                    call = ops.prepare_int8(q[:m], ds, k)
                    bm, bn, _ = call.blocks
                    args = (call.q, call.x8, call.qn, call.scales, call.err, call.hn,
                            call.q_len, bm, bn)
                    m_tiles, n_tiles = call.q.shape[0] // bm, call.hn.shape[0] // bn
                    problems = []
                    card_s = K.int8_scan_config(m_tiles, n_tiles, bm, self.dev)[0]
                    for splits in (card_s, 1):
                        for prune in (True, False):
                            got = K.knn_int8_scan(*args, prune, splits)
                            want = K.knn_int8_scan_plain(*args, prune, splits)
                            for what, a, b in zip(("bounds", "indices", "skips"), got, want):
                                if not torch.equal(a, b):
                                    problems.append(f"scan S={splits} prune={prune} {what}")
                        mv, mi = K.knn_merge(got[0], got[1])
                        pv, pi = K.knn_merge_plain(got[0], got[1])
                        if not (torch.equal(mv, pv) and torch.equal(mi, pi)):
                            problems.append(f"merge S={splits}")
                    v, i, _ = K.knn_int8_fused(*args)
                    pv, pi, _ = K.knn_int8_scan_plain(*args, True, 1)
                    if not (torch.equal(v, pv[:, 0]) and torch.equal(i, pi[:, 0])):
                        problems.append("fused")
                    self.sync()
                    if problems:
                        bad.append(f"{order} k={k} m={m} q_len={call.q_len}: "
                                   f"{', '.join(problems)}")
        return cases, bad

    def _exact_l2dist(self, g):
        """l2dist through its entry point and through each of its two
        kernels, at batches on both sides of the crossover and ragged
        against the tiles (N too), f32 and bf16."""
        torch = self.torch
        from repro_torch.kernels.l2dist import kernel as L

        n, d = EXACT["n"], EXACT["d"]
        ms = EXACT["l2dist_ms"]
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        x = torch.randint(-8, 9, (n, d), generator=g, device=self.dev).to(torch.float32)
        q = torch.randint(-8, 9, (max(ms), d), generator=g, device=self.dev).to(torch.float32)
        q[0] = x[17]
        cases, bad, paths = 0, [], set()
        for dtype in (torch.float32, torch.bfloat16):
            for m in ms:
                qd, xd = q[:m].to(dtype), x.to(dtype)
                qn, xn = torch.sum(q[:m] ** 2, -1), torch.sum(x * x, -1)
                want = L.l2dist_plain(qd, xd, qn, xn)
                picked = L.l2dist_config(m, n, d, dtype, sms).path
                paths.add(picked)
                for path in (None, "stream", "tiled"):
                    cases += 1
                    self.K.reset_launch_counts()
                    got = (L.l2dist_tiles(qd, xd, qn, xn) if path is None else
                           L.l2dist_launch(qd, xd, qn, xn,
                                           L.l2dist_config(m, n, d, dtype, sms, path)))
                    self.sync()
                    if not torch.equal(got, want) or self.K.LAUNCHES["l2dist"] != 1:
                        bad.append(f"{dtype} m={m} path={path or picked}")
        if paths != {"stream", "tiled"}:
            bad.append(f"the entry point took only {paths} at m in {ms}")
        return cases, bad

    def _exact_topk(self, g):
        """topk on a ragged (M, N): integer scores with ties and a mix of
        -0.0 and +0.0; scores descending along N (every lane of every batch
        beats the queue, so the survivor buffer overflows); all scores
        equal (only the index ties decide); and +inf lanes."""
        torch = self.torch
        from repro_torch.kernels.topk import kernel as T
        from repro_torch.kernels.topk import ops as TO
        from repro_torch.kernels.topk.ref import topk_ref

        n, rows = EXACT["n"], max(EXACT["ms"])
        ints = torch.randint(-300, 301, (rows, n), generator=g,
                             device=self.dev).to(torch.float32)
        zero = ints == 0
        ints[zero] = torch.where(torch.rand(int(zero.sum()), generator=g, device=self.dev)
                                 < 0.5, -0.0, 0.0)
        infs = ints.clone()
        infs[torch.rand(rows, n, generator=g, device=self.dev) < 0.3] = torch.inf
        data = {
            "ints": ints,
            "descending": torch.arange(n, 0, -1, device=self.dev, dtype=torch.float32)
            .expand(rows, n).contiguous(),
            "equal": torch.full((rows, n), 3.0, device=self.dev),
            "inf_lanes": infs,
        }
        cases, bad = 0, []
        for name, s in data.items():
            for k in EXACT["topk_ks"]:
                for m in (5, 16):
                    cases += 1
                    sm = s[:m].contiguous()
                    k_eff = 1 << max(0, (k - 1).bit_length())
                    bn = max(1024, k_eff)
                    problems = []
                    for splits in (None, 1):
                        sv, si = T.topk_scan(sm, k_eff, bn, splits)
                        pv, pi = T.topk_scan_plain(sm, k_eff, bn, sv.shape[1])
                        if not (torch.equal(sv, pv) and torch.equal(si, pi)):
                            problems.append(f"scan S={sv.shape[1]}")
                    v, i = TO.topk(sm, k)
                    rv, ri = topk_ref(sm, k)
                    if not (torch.equal(v, rv) and torch.equal(i, ri)):
                        problems.append("topk vs the full sort")
                    self.sync()
                    if problems:
                        bad.append(f"{name} k={k} m={m}: {', '.join(problems)}")
        return cases, bad

    def _exact_case(self, call) -> str:
        torch, K = self.torch, self.K
        bm, bn, bd = call.blocks
        q, x, xn = call.q, call.x, call.xn
        qn = torch.sum(q.to(torch.float32) ** 2, dim=-1)
        m_tiles, n_tiles = q.shape[0] // bm, x.shape[0] // bn
        problems = []
        for splits in (K.scan_config(m_tiles, n_tiles, bm, self.dev)[0], 1):
            for prune in (True, False):
                got = K.knn_scan(q, x, qn, xn, call.k_eff, call.metric, bm, bn, prune, splits)
                want = K.knn_scan_plain(q, x, qn, xn, call.k_eff, call.metric, bm, bn,
                                        prune, splits)
                for name, a, b in zip(("values", "indices", "skips"), got, want):
                    if not torch.equal(a, b):
                        problems.append(f"scan S={splits} prune={prune} {name}")
            mv, mi = K.knn_merge(got[0], got[1])
            pv, pi = K.knn_merge_plain(got[0], got[1])
            if not (torch.equal(mv, pv) and torch.equal(mi, pi)):
                problems.append(f"merge S={splits}")
        v, i, _ = K.knn_fused(q, x, xn, call.k_eff, call.metric, bm, bn, bd)
        pv, pi, _ = K.knn_fused_plain(q, x, xn, call.k_eff, call.metric, bm, bn, bd)
        if not (torch.equal(v, pv) and torch.equal(i, pi)):
            problems.append("fused")
        self.sync()
        return ", ".join(problems)

    # --------------------------------------------------- phases 3 and 4
    def main_path(self, label: str, eng, q, k: int, mode: str) -> bool:
        """One main-path search, held against the plain version, timed."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import SearchRequest

        req = SearchRequest(queries=q, k=k, mode_hint=mode)
        self.sync()
        K.reset_launch_counts()
        res = eng.search(req)
        self.sync()
        launches = dict(K.LAUNCHES)
        ok = (res.plan.executor == "fdsq-cuda" and launches["knn_scan"] >= 1
              and launches["knn_merge"] == 1)
        log(f"{label}: executor={res.plan.executor} mode={res.plan.mode} "
            f"launches={launches} skip_rate={float(res.kernel_stats['prune_skip_rate']):.6f} "
            f"blocks={res.kernel_stats['blocks']}")
        v, i = res.topk.scores, res.topk.indices
        m = q.shape[0]
        ok &= tuple(v.shape) == (m, k) and bool(torch.isfinite(v).all())
        ok &= bool(((i >= 0) & (i < eng.n)).all())

        e2e = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            eng.search(req)
            self.sync()
            e2e.append((time.perf_counter() - t0) * 1e3)

        # the kernels' operands, exactly as the executor prepares them
        ds = eng._ds
        call = ops.prepare(eng._pad_queries(q), ds.vectors, k, "l2", ds.norms)
        bm, bn, _ = call.blocks
        cq, cx, cxn = call.q, call.x, call.xn
        qn = torch.sum(cq.to(torch.float32) ** 2, dim=-1)
        m_tiles, n_tiles = cq.shape[0] // bm, cx.shape[0] // bn
        splits = K.scan_config(m_tiles, n_tiles, bm, self.dev)[0]
        sv, si, sk, st = K.knn_scan(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, True, splits,
                                    return_stats=True)
        pv, pi, psk = K.knn_scan_plain(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, True, splits)
        mv, mi = K.knn_merge(sv, si)
        mpv, mpi = K.knn_merge_plain(sv, si)
        ref = ops.finish(call, *K.knn_merge_plain(pv, pi))
        self.sync()

        xmax = float(cxn[torch.isfinite(cxn)].max())
        tol = TOL_REL * (qn[:m, None] + xmax)
        ok_end, err_end, checked = self._close(v, i, ref.scores, ref.indices, tol)
        ok_scan, err_scan, _ = self._close(sv, si, pv, pi,
                                           TOL_REL * (qn[:, None, None] + xmax))
        merge_exact = torch.equal(mv, mpv) and torch.equal(mi, mpi)
        ok &= ok_end and ok_scan and merge_exact
        log(f"{label}: search vs plain max|d|={err_end:.3e} (tol {float(tol.max()):.3e}), "
            f"indices checked {checked}/{v.numel()}; scan max|d|={err_scan:.3e}; "
            f"merge bit-identical={merge_exact}; skips kernel={int(sk.sum())} "
            f"plain={int(psk.sum())} of {m_tiles * n_tiles}; ok={ok}")

        scan_ms = self.ms(lambda: K.knn_scan(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn,
                                             True, splits))
        merge_ms = self.ms(lambda: K.knn_merge(sv, si))
        plain_scan_ms = self.ms(lambda: K.knn_scan_plain(cq, cx, qn, cxn, call.k_eff, "l2",
                                                         bm, bn, True, splits))
        plain_merge_ms = self.ms(lambda: K.knn_merge_plain(sv, si))
        lib_scan_ms, lib_form = self._library_scan_ms(label, cq[:m], cx[: ds.n_valid], k)
        flat = sv.reshape(sv.shape[0], -1)
        lib_merge_ms = self.ms(lambda: torch.topk(flat, call.k_eff, largest=False))

        # the bound of the function: its data read once (no padding), the
        # (m, k) result written once, 2·d + the epilogue's operations per pair
        n_valid, d = ds.n_valid, q.shape[1]
        scan_bytes = ((n_valid + m) * d * cx.element_size() + (n_valid + m) * 4
                      + m * k * 8)
        scan_ops = m * n_valid * (2 * d + L2_EPILOGUE_OPS)
        # the design's own work: the padded rows and their norms once per
        # m-tile, the padded queries, the S per-block queues and skip counts,
        # the padded rows' FMAs and epilogues, and the survivor filter's
        # sorts, rank searches and merges as the kernel counts them, whose
        # queues live in device memory (each moved pair read and written)
        sel = self.select_work(st, call.k_eff, cq.shape[0] * cx.shape[0])
        design_bytes = (m_tiles * (cx.numel() * cx.element_size() + cxn.numel() * 4)
                        + cq.numel() * cq.element_size() + qn.numel() * 4 + sv.numel() * 8
                        + sk.numel() * 4 + sel["pairs_moved"] * 16 + sel["survivors"] * 8)
        design_ops = (cq.shape[0] * cx.shape[0] * (2 * cx.shape[1] + L2_EPILOGUE_OPS)
                      + sel["ops"])
        merge_bytes, merge_ops = self.merge_work(sv, si, mv, mi)
        shape = {"shape": label, "splits": splits, "blocks": [bm, bn, call.blocks[2]],
                 "search_ms": statistics.median(e2e), "select": sel, "kernels": {}}
        library = {"knn_scan": f"torch.topk(torch.cdist(q, x, compute_mode={lib_form!r})**2)",
                   "knn_merge": "torch.topk(queues.reshape(m, -1))"}
        for name, t, tp, tl, (bb, by), err in (
                ("knn_scan", scan_ms, plain_scan_ms, lib_scan_ms,
                 self.bound(scan_bytes, scan_ops), err_scan),
                ("knn_merge", merge_ms, plain_merge_ms, lib_merge_ms,
                 self.bound(merge_bytes, merge_ops), 0.0 if merge_exact else math.inf)):
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": library[name]}
            log(f"{label}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} "
                f"bound_ms={bb:.4f} ({by}) launches={launches[name]}")
        design_ms, _ = self.bound(design_bytes, design_ops)
        shape["kernels"]["knn_scan"]["design_bound_ms"] = design_ms
        log(f"{label}: knn_scan survivor filter {sel}")
        log(f"{label}: knn_scan bound over the padded operands, queues and survivor work "
            f"design_bound_ms={design_ms:.4f}")
        log(f"{label}: search ms median={statistics.median(e2e):.3f} "
            f"all={[round(t, 3) for t in e2e]} splits={splits} blocks={call.blocks}")
        self.shapes.append(shape)
        return ok

    def _library_scan_ms(self, label, q, x, k):
        """torch.topk over torch.cdist(q, x)²: the same kNN from one library
        call each (a yardstick only; the port never calls them). cdist's
        default matrix-product form squares and copies x, three times its
        size, which a 31.7 GB dataset cannot afford; there the direct form
        (one pass over x) is timed instead. Returns (ms, form)."""
        torch = self.torch
        for mode in ("use_mm_for_euclid_dist_if_necessary", "donot_use_mm_for_euclid_dist"):
            try:
                t = self.ms(lambda: torch.topk(torch.cdist(q, x, compute_mode=mode) ** 2,
                                               k, largest=False))
                return t, mode
            except torch.cuda.OutOfMemoryError:
                log(f"{label}: torch.cdist ({mode}) ran out of device memory")
            finally:
                torch.cuda.empty_cache()
        return None, None

    def _close(self, v, i, pv, pi, tol):
        """Scores within tol; indices equal where the plain neighbours' gaps
        exceed 2·tol. Returns (ok, max |d| over finite scores, indices checked)."""
        torch = self.torch
        fin = torch.isfinite(pv)
        if not torch.equal(torch.isfinite(v), fin):
            return False, math.inf, 0
        diff = (v - pv).abs()
        err = float(diff[fin].max()) if bool(fin.any()) else 0.0
        tol = tol.expand_as(pv)
        ok = bool((diff[fin] <= tol[fin]).all())
        gaps = pv.diff(dim=-1)
        sep = fin.clone()
        sep[..., 1:] &= gaps > 2 * tol[..., 1:]
        sep[..., :-1] &= gaps > 2 * tol[..., :-1]
        sep[..., -1] = False  # the next score is unknown
        ok &= bool((i[sep] == pi[sep]).all())
        return ok, err, int(sep.sum())

    def _dataset(self, n, d, m, seed):
        """Gaussian rows made on the device from a seed, and m queries near
        random rows of them."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn(n, d, generator=g, device=self.dev)
        pick = torch.randint(0, n, (m,), generator=g, device=self.dev)
        q = x[pick] + 0.3 * torch.randn(m, d, generator=g, device=self.dev)
        return x, q

    def _fit(self, label, x, k):
        from repro_torch import ExactKNN

        t0 = time.perf_counter()
        eng = ExactKNN(k=k, backend="cuda", device=self.dev).fit(x)
        self.sync()
        log(f"{label}: fit {tuple(x.shape)} -> {tuple(eng._ds.vectors.shape)} in "
            f"{time.perf_counter() - t0:.2f} s")
        return eng

    def phase_gist(self) -> bool:
        x, q = self._dataset(GIST["n"], GIST["d"], GIST["m"], seed=3)
        eng = self._fit("gist", x, GIST["k"])
        del x  # the engine holds the padded copy only
        ok = self.main_path(f"gist_fqsd_m{GIST['m']}_k{GIST['k']}", eng, q, GIST["k"], "fqsd")
        del eng
        self.torch.cuda.empty_cache()
        return ok

    def phase_msmarco(self) -> bool:
        torch = self.torch
        x, q = self._dataset(MSMARCO["n"], MSMARCO["d"], MSMARCO["m"], seed=4)
        eng = self._fit("msmarco", x, MSMARCO["ks"][0])
        del x  # the unpadded source goes before the searches
        torch.cuda.empty_cache()
        ok = True
        for k in MSMARCO["ks"]:
            ok &= self.main_path(f"msmarco_fdsq_m{MSMARCO['m']}_k{k}", eng, q, k, "fdsq")
        log(f"msmarco: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        self.msmarco_eng = eng  # the int8 phase quantises this resident dataset
        return ok

    # ------------------------------------------------------ phase 5: int8
    def phase_int8(self) -> bool:
        torch = self.torch
        ok = True
        eng = self.msmarco_eng
        if eng is None:  # phase 4 did not run: make the same dataset
            x, _ = self._dataset(MSMARCO["n"], MSMARCO["d"], 1, seed=4)
            eng = self._fit("msmarco", x, INT8["msmarco_k"])
            del x
        self.msmarco_eng = None
        g = torch.Generator(device=self.dev).manual_seed(6)
        pick = torch.randint(0, eng.n, (INT8["m"],), generator=g, device=self.dev)
        q = (eng._ds.vectors[pick, : MSMARCO["d"]]
             + 0.3 * torch.randn(INT8["m"], MSMARCO["d"], generator=g, device=self.dev))
        ok &= self.main_path_int8(f"msmarco_fqsd_int8_m{INT8['m']}_k{INT8['msmarco_k']}",
                                  eng, q, INT8["msmarco_k"])
        del eng
        torch.cuda.empty_cache()
        x, q = self._dataset(GIST["n"], GIST["d"], INT8["m"], seed=3)  # phase 3's data
        eng = self._fit("gist", x, INT8["gist_k"])
        del x
        ok &= self.main_path_int8(f"gist_fqsd_int8_m{INT8['m']}_k{INT8['gist_k']}",
                                  eng, q, INT8["gist_k"])
        del eng
        torch.cuda.empty_cache()
        return ok

    def main_path_int8(self, label: str, eng, q, k: int) -> bool:
        """One int8-tier search on the main path, held against the port's
        direct-form oracle and the scan's plain version, timed by phase."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import SearchRequest

        t0 = time.perf_counter()
        eng.enable_int8()
        self.sync()
        quantize_s = time.perf_counter() - t0
        req = SearchRequest(queries=q, k=k, tier="int8")
        self.sync()
        K.reset_launch_counts()
        res = eng.search(req)
        self.sync()
        launches = dict(K.LAUNCHES)
        cert = res.certified
        m = q.shape[0]
        v, i = res.topk.scores, res.topk.indices
        ok = (res.plan.executor == "fqsd-int8-cuda" and launches["knn_int8_scan"] >= 1
              and launches["knn_merge"] == 1)
        ok &= tuple(v.shape) == (m, k) and bool(torch.isfinite(v).all())
        ok &= bool(((i >= 0) & (i < eng.n)).all())
        share = float(cert.to(torch.float32).mean())
        log(f"{label}: quantised in {quantize_s:.2f} s; executor={res.plan.executor} "
            f"launches={launches} skip_rate={float(res.kernel_stats['prune_skip_rate']):.6f} "
            f"blocks={res.kernel_stats['blocks']} certified {int(cert.sum())}/{m} "
            f"(share {share:.4f})")

        e2e = []
        for _ in range(REPEATS):
            t1 = time.perf_counter()
            eng.search(req)
            self.sync()
            e2e.append((time.perf_counter() - t1) * 1e3)

        # every row against the port's own oracle: certified rows come from
        # the rescore, the others from the fallback, both in the direct form
        ds, qv, chunk = eng._ds, eng._pad_queries(q), res.plan.chunk_rows
        t1 = time.perf_counter()
        oracle = ops.knn_exact_direct(qv, ds.vectors, ds.norms, k, chunk)
        self.sync()
        oracle_s = time.perf_counter() - t1
        cert_exact = (torch.equal(v[cert], oracle.scores[cert])
                      and torch.equal(i[cert], oracle.indices[cert]))
        all_exact = torch.equal(v, oracle.scores) and torch.equal(i, oracle.indices)
        ok &= cert_exact and all_exact

        # the kernels' operands, exactly as the executor prepares them
        call = ops.prepare_int8(qv, eng._int8, k, res.plan.rescore_factor)
        bm, bn, _ = call.blocks
        args = (call.q, call.x8, call.qn, call.scales, call.err, call.hn, call.q_len, bm, bn)
        m_tiles, n_tiles = call.q.shape[0] // bm, call.hn.shape[0] // bn
        splits = K.int8_scan_config(m_tiles, n_tiles, bm, self.dev)[0]
        sv, si, sk, st = K.knn_int8_scan(*args, True, splits, return_stats=True)
        pv, pi, psk = K.knn_int8_scan_plain(*args, True, splits)
        lb, li = K.knn_merge(sv, si)
        mpv, mpi = K.knn_merge_plain(sv, si)
        out, cert2 = ops.rescore_certify(qv, lb[:m], li[:m], ds.vectors, k, call.r)
        self.sync()
        hmax = float(call.hn[torch.isfinite(call.hn)].max())
        ok_scan, err_scan, _ = self._close(sv, si, pv, pi,
                                           TOL_REL * (call.qn[:, None, None] + hmax))
        merge_exact = torch.equal(lb, mpv) and torch.equal(li, mpi)
        rescore_same = torch.equal(cert2, cert) and torch.equal(out.scores[cert], v[cert])
        ok &= ok_scan and merge_exact and rescore_same
        log(f"{label}: all rows bit-identical to knn_exact_direct={all_exact} (certified "
            f"rows {cert_exact}); oracle {oracle_s:.2f} s; scan vs plain max|d|={err_scan:.3e}; "
            f"merge bit-identical={merge_exact}; rescore repeats the search={rescore_same}; "
            f"skips kernel={int(sk.sum())} plain={int(psk.sum())} of {m_tiles * n_tiles}; "
            f"ok={ok}")

        scan_ms = self.ms(lambda: K.knn_int8_scan(*args, True, splits))
        merge_ms = self.ms(lambda: K.knn_merge(sv, si))
        rescore_ms = self.ms(lambda: ops.rescore_certify(qv, lb[:m], li[:m], ds.vectors, k,
                                                         call.r))
        bad = ~cert
        fallback_ms = (self.ms(lambda: ops.knn_exact_direct(qv[bad], ds.vectors, ds.norms, k,
                                                            chunk), repeats=1)
                       if bool(bad.any()) else 0.0)
        plain_scan_ms = self.ms(lambda: K.knn_int8_scan_plain(*args, True, splits))
        plain_merge_ms = self.ms(lambda: K.knn_merge_plain(sv, si))
        flat = sv.reshape(sv.shape[0], -1)
        lib_merge_ms = self.ms(lambda: torch.topk(flat, call.q_len, largest=False))
        # the yardstick of the whole int8 search: the f32 scan at the same shape
        fcall = ops.prepare(qv, ds.vectors, k, "l2", ds.norms)
        fbm, fbn, _ = fcall.blocks
        fqn = torch.sum(fcall.q * fcall.q, dim=-1)
        f32_scan_ms = self.ms(lambda: K.knn_scan(fcall.q, fcall.x, fqn, fcall.xn, fcall.k_eff,
                                                 "l2", fbm, fbn, True))

        # the bound of the function: codes (1 B), scales, err and hn of the
        # valid rows, the unpadded queries, the (m, q_len) queue written once
        n_valid, d = eng.n, q.shape[1]
        scan_bytes = n_valid * d + 3 * n_valid * 4 + m * (d + 1) * 4 + m * call.q_len * 8
        scan_ops = m * n_valid * (2 * d + INT8_EPILOGUE_OPS)
        # the design's own work: the codes and channels once per m-tile, the
        # padded rows' FMAs and epilogues, the S queues written, and the
        # survivor filter's sorts, rank searches and merges, whose queues
        # live in device memory (each moved pair read and written)
        mp, dp = call.q.shape[0], call.x8.shape[1]
        rows = n_tiles * bn
        sel = self.select_work(st, call.q_len, mp * rows)
        design_bytes = (m_tiles * (call.x8.numel() + 3 * rows * 4) + call.q.numel() * 4
                        + call.qn.numel() * 4 + sv.numel() * 8 + sk.numel() * 4
                        + sel["pairs_moved"] * 16 + sel["survivors"] * 8)
        design_ops = mp * rows * (2 * dp + INT8_EPILOGUE_OPS) + sel["ops"]
        merge_bytes, merge_ops = self.merge_work(sv, si, lb, li)
        shape = {"shape": label, "splits": splits, "blocks": [bm, bn, call.blocks[2]],
                 "q_len": call.q_len, "search_ms": statistics.median(e2e),
                 "certified_share": share, "rescore_ms": rescore_ms,
                 "fallback_ms": fallback_ms, "f32_scan_ms": f32_scan_ms,
                 "quantize_s": quantize_s, "select": sel, "kernels": {}}
        for name, t, tp, tl, lib, (bb, by), err in (
                ("knn_int8_scan", scan_ms, plain_scan_ms, None, None,
                 self.bound(scan_bytes, scan_ops), err_scan),
                ("knn_merge", merge_ms, plain_merge_ms, lib_merge_ms,
                 "torch.topk(queues.reshape(m, -1))", self.bound(merge_bytes, merge_ops),
                 0.0 if merge_exact else math.inf)):
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
            log(f"{label}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} "
                f"bound_ms={bb:.4f} ({by}) launches={launches[name]}")
        bb_bytes, _ = self.bound(scan_bytes, 0)
        bb_ops, _ = self.bound(0, scan_ops)
        design_ms, _ = self.bound(design_bytes, design_ops)
        shape["kernels"]["knn_int8_scan"]["design_bound_ms"] = design_ms
        log(f"{label}: knn_int8_scan survivor filter {sel}")
        log(f"{label}: knn_int8_scan bound by bytes {bb_bytes:.4f} ms, by operations "
            f"{bb_ops:.4f} ms (padded operands, queues and survivor work: {design_ms:.4f} ms); "
            f"f32 knn_scan at this shape {f32_scan_ms:.4f} ms; rescore "
            f"{rescore_ms:.4f} ms; fallback {fallback_ms:.4f} ms ({int(bad.sum())} rows)")
        log(f"{label}: search ms median={statistics.median(e2e):.3f} "
            f"all={[round(t, 3) for t in e2e]} splits={splits} blocks={call.blocks}")
        self.shapes.append(shape)
        return ok

    # -------------------------------------------------- phase 6: streamed
    def host_clock_ms(self, fn, repeats: int) -> tuple[float, list[float]]:
        """Median host-clock time of fn (each run ending in a synchronise)
        over `repeats` runs after a warm-up, and every run's time."""
        fn()
        self.sync()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), times

    @staticmethod
    def host_ram() -> str:
        fields = {}
        for line in Path("/proc/meminfo").read_text().splitlines():
            key, _, rest = line.partition(":")
            fields[key] = rest.strip()
        return f"MemTotal {fields.get('MemTotal')} MemAvailable {fields.get('MemAvailable')}"

    def copy_rate(self, shard) -> tuple[float, float]:
        """Pinned host -> device copy of one f32 shard (vectors + norms):
        (median ms of 10 by CUDA events, bytes/s)."""
        torch = self.torch
        dst = [torch.empty_like(t, device=self.dev) for t in (shard.vectors, shard.norms)]
        nbytes = sum(t.numel() * t.element_size() for t in dst)

        def copy():
            for d_, s_ in zip(dst, (shard.vectors, shard.norms)):
                d_.copy_(s_, non_blocking=True)

        t = self.ms(copy, repeats=STREAMED["repeats"])
        return t, nbytes / (t * 1e-3)

    def phase_streamed(self) -> bool:
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core.fqsd import make_partition_step, streamed_direct_scan
        from repro_torch.core.quantized import make_int8_bound_step
        from repro_torch.core.streaming import DoubleBufferedStream, device_put_partition
        from repro_torch.store import DatasetStore

        cfg = STREAMED
        n, d, m, k = cfg["n"], cfg["d"], cfg["m"], cfg["k"]
        log(f"streamed: host RAM {self.host_ram()}")
        x, q = self._dataset(n, d, m, seed=cfg["seed"])
        t0 = time.perf_counter()
        store = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"], pin_memory=True)
        del x
        self.sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.ensure_tier("int8", device=self.dev)
        self.sync()
        quant_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        shard_rows, dp, n_shards = store.rows_per_shard, store.padded_dim, store.n_shards
        f32_bytes = n_shards * shard_rows * (dp + 1) * 4  # vectors + norms a shard
        int8_bytes = sum(store.read_shard(i, "int8").scan_bytes() for i in range(n_shards))
        log(f"streamed: pinned store of {n_shards} shards x {shard_rows} rows x {dp} "
            f"({store.n_main} valid, {f32_bytes} B f32 + norms shipped a search) built in "
            f"{build_s:.2f} s; int8 tier ({int8_bytes} B a search) quantised on the card in "
            f"{quant_s:.2f} s; pinned={store.is_pinned}")
        copy_ms, rate = self.copy_rate(store.read_shard(0))
        log(f"streamed: pinned copy of one shard {copy_ms:.4f} ms -> {rate / 1e9:.3f} GB/s "
            f"(median of {cfg['repeats']}, CUDA events) [{self.card}]")

        eng = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(store, resident=False)
        eng.enable_int8()
        qv = eng._pad_queries(q)
        ok = True
        results = {}
        # ---- the main path: one search of each tier, counters read around it
        for tier, kernels in (("f32", ("knn_scan", "knn_merge")),
                              ("int8", ("knn_int8_scan", "knn_merge"))):
            req = SearchRequest(queries=q, k=k, tier=tier, prefetch_depth=2)
            self.sync()
            K.reset_launch_counts()
            res = eng.search(req)
            self.sync()
            launches = dict(K.LAUNCHES)
            want_exec = "fqsd-mmap-streamed" if tier == "f32" else "fqsd-int8-streamed"
            good = (res.plan.executor == want_exec and res.stats["transfers"] == n_shards
                    and all(launches[name] == n_shards for name in kernels)
                    and sum(launches.values()) == 2 * n_shards)
            v, i = res.topk.scores, res.topk.indices
            good &= tuple(v.shape) == (m, k) and bool(torch.isfinite(v).all())
            good &= bool(((i >= 0) & (i < store.n_main)).all())
            log(f"streamed {tier}: executor={res.plan.executor} transfers="
                f"{res.stats['transfers']} bytes_scanned={res.stats['bytes_scanned']} "
                f"launches={launches} health={res.stats['health']} ok={good}")
            ok &= good
            results[tier] = (res, launches)

        # ---- (a) f32: bit-identical to a resident fdsq-cuda search of the store
        resident = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(store, resident=True)
        want = resident.search(SearchRequest(queries=q, k=k, mode_hint="fqsd"))
        got = results["f32"][0]
        check_a = (want.plan.executor == "fdsq-cuda"
                   and torch.equal(got.topk.scores, want.topk.scores)
                   and torch.equal(got.topk.indices, want.topk.indices))
        log(f"streamed check (a): f32 streamed bit-identical to resident fdsq-cuda={check_a}")

        # ---- (b) int8: = streamed_direct_scan, = resident int8 where both certified
        got8 = results["int8"][0]
        oracle = streamed_direct_scan(qv, store.shard_source("f32"), k)
        resident.enable_int8()
        res8 = resident.search(SearchRequest(queries=q, k=k, tier="int8"))
        both = got8.certified & res8.certified
        check_b = (torch.equal(got8.topk.scores, oracle.scores)
                   and torch.equal(got8.topk.indices, oracle.indices)
                   and res8.plan.executor == "fqsd-int8-cuda"
                   and torch.equal(got8.topk.scores[both], res8.topk.scores[both])
                   and torch.equal(got8.topk.indices[both], res8.topk.indices[both]))
        share = float(got8.certified.to(torch.float32).mean())
        log(f"streamed check (b): int8 streamed bit-identical to streamed_direct_scan and to "
            f"resident fqsd-int8-cuda on {int(both.sum())}/{m} rows certified by both={check_b}; "
            f"certified share {share:.4f} (resident {float(res8.certified.float().mean()):.4f})")
        del resident, res8, oracle
        torch.cuda.empty_cache()

        # ---- (d) speculation triggers reschedule reads, never results
        spec = {}
        check_d = True
        for trigger in cfg["triggers"]:
            r = eng.search(SearchRequest(queries=q, k=k, tier="int8", spec_trigger=trigger))
            spec[trigger] = r.stats["speculation"]
            check_d &= (torch.equal(r.topk.scores, got8.topk.scores)
                        and torch.equal(r.topk.indices, got8.topk.indices))
        log(f"streamed check (d): results at spec_trigger {cfg['triggers']} bit-identical="
            f"{check_d}; speculation {spec}")

        # ---- timings at depth 1 and 2, beside copy-only and compute-only
        f32_parts = [device_put_partition(p, self.dev) for p in store.shard_source("f32")]
        int8_parts = [device_put_partition(p, self.dev) for p in store.shard_source("int8")]
        r_budget = max(1, min(n_shards * shard_rows, eng.rescore_factor * k))
        step = make_partition_step(k, "l2", "cuda")
        bound_step = make_int8_bound_step(r_budget, "cuda")

        def compute_f32():
            state = step.init(m, self.dev)
            for p in f32_parts:
                state = step(state, qv, p.vectors, p.norms, p.base_index, p.n_valid)
            return step.finish(state)

        def compute_int8():
            lb = torch.full((m, r_budget + 1), torch.inf, device=self.dev)
            li = torch.full((m, r_budget + 1), -1, dtype=torch.int32, device=self.dev)
            for p in int8_parts:
                lb, li = bound_step(lb, li, qv, p.q, p.scales, p.err, p.qnorm, p.base_index)
            return lb, li

        def copy_only(tier, depth):
            for _ in DoubleBufferedStream(store.shard_source(tier), depth=depth,
                                          device=self.dev):
                pass

        timing = {"card": self.card, "copy_ms_one_shard": copy_ms, "copy_GBps": rate / 1e9,
                  "host_ram": self.host_ram()}
        reps = cfg["repeats"]
        for tier, shipped, compute in (("f32", f32_bytes, compute_f32),
                                       ("int8", int8_bytes, compute_int8)):
            compute_ms, _ = self.host_clock_ms(compute, reps)
            bound_ms = shipped / rate * 1e3
            per_tier = {"bytes_shipped": shipped, "bound_ms": bound_ms,
                        "compute_only_ms": compute_ms}
            # int8: the default trigger at both depths, then no speculation
            runs = [(depth, None) for depth in cfg["depths"]]
            if tier == "int8":
                runs.append((cfg["depths"][-1], 1.0))
            for depth, trigger in runs:
                req = SearchRequest(queries=q, k=k, tier=tier, prefetch_depth=depth,
                                    spec_trigger=trigger)
                search_ms, all_ms = self.host_clock_ms(lambda: eng.search(req), reps)
                copy_only_ms, _ = self.host_clock_ms(lambda: copy_only(tier, depth), reps)
                res = eng.search(req)
                self.sync()
                row = {"search_ms": search_ms, "all_ms": [round(t, 3) for t in all_ms],
                       "copy_only_ms": copy_only_ms, "transfers": res.stats["transfers"],
                       "GBps": shipped / (search_ms * 1e-3) / 1e9,
                       "share_of_copy_rate": shipped / (search_ms * 1e-3) / rate,
                       "overlap": search_ms < copy_only_ms + compute_ms}
                if tier == "int8":
                    row.update({key: res.stats[key] for key in ("scan_ms", "gather_ms",
                                                                "rescore_ms")})
                label = f"depth{depth}" + ("" if trigger is None else f"_trigger{trigger}")
                per_tier[label] = row
                log(f"streamed {tier} {label}: search {search_ms:.3f} ms (median of "
                    f"{reps}), copy-only {copy_only_ms:.3f} ms, compute-only {compute_ms:.3f} "
                    f"ms, bound {bound_ms:.3f} ms, {row['GBps']:.3f} GB/s = "
                    f"{row['share_of_copy_rate']:.3f} of the copy rate, transfers "
                    f"{row['transfers']} [{self.card}]")
            if tier == "int8":
                per_tier["speculation"] = spec
                per_tier["certified_share"] = share
            timing[tier] = per_tier
        overlapped = timing["f32"]["depth2"]["overlap"]
        log(f"streamed: f32 depth 2 below copy-only + compute-only={overlapped}")
        log("streamed timings " + json.dumps(timing))

        # ---- (c) each per-shard kernel step against its plain step, and the
        # kernels' per-launch numbers at the shard shape
        check_c = self._streamed_kernels(eng, qv, f32_parts, int8_parts, r_budget, results)
        del f32_parts, int8_parts, eng, store
        torch.cuda.empty_cache()
        return ok and check_a and check_b and check_c and check_d

    def _streamed_kernels(self, eng, qv, f32_parts, int8_parts, r, results,
                          label: str = "streamed") -> bool:
        """One shard's step on the kernels against the plain step (scan plain +
        knn_merge_plain), with the running queue of the shards before it; the
        per-launch times and bounds of the three kernels at the shard shape
        (shard 1 of the parts given, after shard 0)."""
        torch, K, ops = self.torch, self.K, self.ops
        cfg = STREAMED
        m, k, d = cfg["m"], cfg["k"], cfg["d"]
        shard, prev = f32_parts[1], f32_parts[0]
        ok = True
        # f32: the running queue after shard 0, then shard 1
        call0 = ops.prepare(qv, prev.vectors, k, "l2", prev.norms)
        bm, bn, _ = call0.blocks
        v0 = torch.full((m, call0.k_eff), torch.inf, device=self.dev)
        i0 = torch.full((m, call0.k_eff), -1, dtype=torch.int32, device=self.dev)
        v, i = ops.knn_shard(v0, i0, qv, prev.vectors, prev.norms, k, "l2", prev.base_index)
        call = ops.prepare(qv, shard.vectors, k, "l2", shard.norms)
        qn = torch.sum(call.q * call.q, dim=-1)
        m_tiles, n_tiles = call.q.shape[0] // bm, call.x.shape[0] // bn
        splits = K.scan_config(m_tiles, n_tiles, bm, self.dev)[0]
        got = ops.knn_shard(v, i, qv, shard.vectors, shard.norms, k, "l2", shard.base_index)
        pv, pi, _ = K.knn_scan_plain(call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn,
                                     True, splits)
        want = ops.merge_shard(v, i, pv[:m], pi[:m], shard.base_index, merge=K.knn_merge_plain)
        f32_ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        sv, si, _ = K.knn_scan(call.q, call.x, qn, call.xn, call.k_eff, "l2", bm, bn, True,
                               splits)
        scan_exact = torch.equal(sv, pv) and torch.equal(si, pi)
        # the queues the step's merge takes: the shard's S, then the running one
        qv_all = torch.cat([sv[:m], v[:, None]], 1)
        qi_all = torch.cat([torch.where(torch.isfinite(sv[:m]), si[:m] + shard.base_index, -1),
                            i[:, None]], 1)
        mv, mi = K.knn_merge(qv_all, qi_all)
        pmv, pmi = K.knn_merge_plain(qv_all, qi_all)
        merge_exact = torch.equal(mv, pmv) and torch.equal(mi, pmi)
        # int8: the running bound queue after shard 0, then shard 1
        p8, prev8 = int8_parts[1], int8_parts[0]
        lb0 = torch.full((m, r + 1), torch.inf, device=self.dev)
        li0 = torch.full((m, r + 1), -1, dtype=torch.int32, device=self.dev)
        lb, li = ops.knn_int8_shard(lb0, li0, qv, prev8.q, prev8.scales, prev8.err, prev8.qnorm,
                                    prev8.base_index, r)
        got8 = ops.knn_int8_shard(lb, li, qv, p8.q, p8.scales, p8.err, p8.qnorm, p8.base_index, r)
        args = ops.int8_shard_operands(qv, p8.q, p8.scales, p8.err, p8.qnorm, r)
        q_len, bm8, bn8 = args[6], args[7], args[8]
        splits8 = K.int8_scan_config(args[0].shape[0] // bm8, args[5].shape[0] // bn8, bm8,
                                     self.dev)[0]
        pv8, pi8, _ = K.knn_int8_scan_plain(*args, True, splits8)
        wv8, wi8 = ops.merge_shard(lb, li, pv8[:m], pi8[:m], p8.base_index,
                                   merge=K.knn_merge_plain)
        int8_ok = torch.equal(got8[0], wv8[:, : r + 1]) and torch.equal(got8[1], wi8[:, : r + 1])
        sv8, si8, _ = K.knn_int8_scan(*args, True, splits8)
        scan8_exact = torch.equal(sv8, pv8) and torch.equal(si8, pi8)
        self.sync()
        ok = f32_ok and int8_ok and scan_exact and scan8_exact and merge_exact
        log(f"{label} check (c): f32 shard step bit-identical to its plain step={f32_ok} "
            f"(scan {scan_exact}, merge {merge_exact}); int8 shard step={int8_ok} "
            f"(scan {scan8_exact}); S={splits} / {splits8}, q_len={q_len}")

        # per-launch numbers at the shard shape (shard 1: all its rows valid)
        rows = shard.n_valid
        lq8 = torch.cat([sv8[:m], lb.new_full((m, 1, q_len), torch.inf)], 1)
        li8 = torch.cat([torch.where(torch.isfinite(sv8[:m]), si8[:m] + p8.base_index, -1),
                         li.new_full((m, 1, q_len), -1)], 1)
        lm8 = K.knn_merge(lq8, li8)
        numbers = {
            "knn_scan": (self.ms(lambda: K.knn_scan(call.q, call.x, qn, call.xn, call.k_eff,
                                                     "l2", bm, bn, True, splits)),
                         self.ms(lambda: K.knn_scan_plain(call.q, call.x, qn, call.xn,
                                                          call.k_eff, "l2", bm, bn, True,
                                                          splits)),
                         self._library_scan_ms("streamed", qv[:, :d], shard.vectors[:rows, :d],
                                               k)[0],
                         "torch.topk(torch.cdist(q, shard)**2)",
                         self.bound((rows + m) * d * 4 + (rows + m) * 4 + m * k * 8,
                                    m * rows * (2 * d + L2_EPILOGUE_OPS)),
                         0.0 if scan_exact else math.inf),
            "knn_merge": (self.ms(lambda: K.knn_merge(qv_all, qi_all)),
                          self.ms(lambda: K.knn_merge_plain(qv_all, qi_all)),
                          self.ms(lambda: torch.topk(qv_all.reshape(m, -1), call.k_eff,
                                                     largest=False)),
                          "torch.topk(queues.reshape(m, -1))",
                          self.bound(*self.merge_work(qv_all, qi_all, mv, mi)),
                          0.0 if merge_exact else math.inf),
            "knn_int8_scan": (self.ms(lambda: K.knn_int8_scan(*args, True, splits8)),
                              self.ms(lambda: K.knn_int8_scan_plain(*args, True, splits8)),
                              None, None,
                              self.bound(rows * d + 3 * rows * 4 + m * (d + 1) * 4
                                         + m * q_len * 8,
                                         m * rows * (2 * d + INT8_EPILOGUE_OPS)),
                              0.0 if scan8_exact else math.inf),
        }
        int8_merge = (self.ms(lambda: K.knn_merge(lq8, li8)),
                      self.ms(lambda: K.knn_merge_plain(lq8, li8)),
                      self.ms(lambda: torch.topk(lq8.reshape(m, -1), q_len, largest=False)),
                      "torch.topk(queues.reshape(m, -1))",
                      self.bound(*self.merge_work(lq8, li8, *lm8)), 0.0)
        for tier, names, merge in (("f32", ("knn_scan", "knn_merge"), numbers["knn_merge"]),
                                   ("int8", ("knn_int8_scan", "knn_merge"), int8_merge)):
            launches = results[tier][1]
            shape = {"shape": f"{label}_gist_{tier}_m{m}_k{k}_one_shard_of_{rows}_rows",
                     "per": "one launch on one shard", "kernels": {}}
            for name in names:
                t, tp, tl, lib, (bb, by), err = merge if name == "knn_merge" else numbers[name]
                shape["kernels"][name] = {
                    "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                    "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
                log(f"{label} {tier}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} "
                    f"bound_ms={bb:.6f} ({by}) per shard; launches a search={launches[name]} "
                    f"[{self.card}]")
            self.shapes.append(shape)
        return ok

    # ------------------------------------------------------ phase 7: mmap
    @staticmethod
    def _filesystem(path: Path) -> str:
        """The mount point and type of the filesystem `path` lies on."""
        best = ("?", "?")
        for line in Path("/proc/mounts").read_text().splitlines():
            parts = line.split()
            if len(parts) > 2 and str(path).startswith(parts[1]) and len(parts[1]) >= len(best[0]):
                best = (parts[1], parts[2])
        return f"{best[0]} ({best[1]})"

    @staticmethod
    def _drop_cache(directory: Path) -> str:
        """Ask the kernel to drop the page cache of every file of the store
        (posix_fadvise DONTNEED, advisory), after an fsync; returns the
        host's Cached line after, so the reader can see what it did."""
        import os

        for f in directory.iterdir():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("Cached:"):
                return line.split(":", 1)[1].strip()
        return "?"

    def mmap_rates(self, directory: Path, store, pinned_shard) -> dict:
        """Measurements, not gates: the read rate of one shard's file from a
        dropped cache and again warm; the mapping -> page-locked staging
        copy of one shard (the double buffer's own routine, median of
        repeats, at 1 thread and at its default); the page-locked -> card
        copy of one shard (CUDA events)."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.core import streaming

        torch, cfg = self.torch, MMAP
        path = directory / "shard_00001.f32.bin"
        nbytes = path.stat().st_size
        buf = bytearray(16 << 20)

        def read_file() -> float:
            t0 = time.perf_counter()
            with open(path, "rb", buffering=0) as f:
                while f.readinto(buf):
                    pass
            return time.perf_counter() - t0

        cached = self._drop_cache(directory)
        cold_s = read_file()
        warm_s = read_file()
        src = store.read_shard(1).vectors
        bank = torch.empty(tuple(src.shape), dtype=torch.float32, pin_memory=True)
        threads = streaming.stage_threads()
        stage_ms = {}
        for n_threads in sorted({1, threads}):
            pool = ThreadPoolExecutor(n_threads) if n_threads > 1 else None
            try:
                times = []
                for _ in range(cfg["repeats"] + 1):
                    t0 = time.perf_counter()
                    streaming.stage(bank, src, pool)
                    times.append((time.perf_counter() - t0) * 1e3)
            finally:
                if pool is not None:
                    pool.shutdown()
            stage_ms[n_threads] = statistics.median(times[1:])
        copy_ms, copy_rate = self.copy_rate(pinned_shard)
        rates = {"shard_file_bytes": nbytes, "cached_after_drop": cached,
                 "disk_read_GBps": nbytes / cold_s / 1e9, "reread_GBps": nbytes / warm_s / 1e9,
                 "stage_threads": threads,
                 "stage_ms": {str(t): v for t, v in stage_ms.items()},
                 "stage_GBps": {str(t): nbytes / (v * 1e-3) / 1e9 for t, v in stage_ms.items()},
                 "pinned_copy_ms": copy_ms, "pinned_copy_GBps": copy_rate / 1e9}
        log(f"mmap rates: read of one shard's file ({nbytes} B) after a cache drop "
            f"{rates['disk_read_GBps']:.3f} GB/s (Cached after the drop {cached}), read again "
            f"{rates['reread_GBps']:.3f} GB/s; mapping -> page-locked staging "
            + ", ".join(f"{rates['stage_GBps'][str(t)]:.3f} GB/s at {t} thread(s)"
                        for t in stage_ms)
            + f" (median of {cfg['repeats']}); page-locked -> card {copy_rate / 1e9:.3f} GB/s "
            f"({copy_ms:.4f} ms, CUDA events) [{self.card}]")
        return rates

    def phase_mmap(self) -> bool:
        """The GIST data of phase 6 written as a store in files, reopened
        with verify=True, and streamed from its mappings at depths 1 and 2;
        every result bit-identical to the same data in a pinned host-RAM
        store. The directory is deleted at the end, whatever the outcome."""
        import shutil

        directory = ROOT / "build" / "mmap_store"
        shutil.rmtree(directory, ignore_errors=True)
        try:
            return self._mmap(directory)
        finally:
            shutil.rmtree(directory, ignore_errors=True)

    def _mmap(self, directory: Path) -> bool:
        import shutil

        torch, K = self.torch, self.K
        from repro_torch import ExactKNN, SearchRequest
        from repro_torch.core.streaming import device_put_partition
        from repro_torch.store import DatasetStore

        cfg = MMAP
        n, d, m, k = cfg["n"], cfg["d"], cfg["m"], cfg["k"]
        x, q = self._dataset(n, d, m, seed=cfg["seed"])
        t0 = time.perf_counter()
        ram = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"], pin_memory=True)
        ram.ensure_tier("int8", device=self.dev)
        self.sync()
        ram_s = time.perf_counter() - t0
        directory.parent.mkdir(parents=True, exist_ok=True)
        free = shutil.disk_usage(directory.parent).free
        t0 = time.perf_counter()
        written = DatasetStore.from_array(x, rows_per_shard=cfg["rows_per_shard"],
                                          directory=str(directory))
        write_s = time.perf_counter() - t0
        del x
        t0 = time.perf_counter()
        written.ensure_tier("int8", device=self.dev)
        int8_s = time.perf_counter() - t0
        written.close()
        disk_bytes = sum(f.stat().st_size for f in directory.iterdir())
        cached = self._drop_cache(directory)
        t0 = time.perf_counter()
        store = DatasetStore.open(str(directory), verify=True)
        open_s = time.perf_counter() - t0
        n_shards = store.n_shards
        log(f"mmap: store in {directory} on {self._filesystem(directory)}, {free} B free before; "
            f"{n_shards} shards x {store.rows_per_shard} rows x {store.padded_dim} "
            f"({store.n_main} valid), {disk_bytes} B on disk; f32 written in {write_s:.2f} s, "
            f"int8 tier quantised on the card and written in {int8_s:.2f} s; "
            f"open(verify=True) from a dropped cache (Cached {cached}) {open_s:.2f} s "
            f"({disk_bytes / open_s / 1e9:.3f} GB/s CRC32 over every file); the pinned "
            f"host-RAM store of the same rows built in {ram_s:.2f} s; host RAM {self.host_ram()}")
        ok = store.is_mmap and store.tiers == ("f32", "int8") and not store.is_pinned
        rates = self.mmap_rates(directory, store, ram.read_shard(0))

        engines = {}
        for name, st in (("ram", ram), ("mmap", store)):
            engines[name] = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(
                st, resident=False).enable_int8()
        ok &= not store.is_pinned  # fit_store never pins a store in files
        qv = engines["mmap"]._pad_queries(q)
        shipped = {"f32": n_shards * store.rows_per_shard * (store.padded_dim + 1) * 4,
                   "int8": sum(store.read_shard(i, "int8").scan_bytes()
                               for i in range(n_shards))}
        stage_rate = rates["stage_GBps"][str(rates["stage_threads"])] * 1e9
        timing = {"card": self.card, "rates": rates, "write_s": write_s, "int8_write_s": int8_s,
                  "verify_open_s": open_s, "disk_bytes": disk_bytes}
        results = {}
        for tier, kernels, want_exec in (
                ("f32", ("knn_scan", "knn_merge"), "fqsd-mmap-streamed"),
                ("int8", ("knn_int8_scan", "knn_merge"), "fqsd-int8-mmap-streamed")):
            per_tier = {"bytes_shipped": shipped[tier],
                        "staging_bound_ms": shipped[tier] / stage_rate * 1e3,
                        "disk_bound_ms": shipped[tier] / (rates["disk_read_GBps"] * 1e9) * 1e3}
            for depth in cfg["depths"]:
                req = SearchRequest(queries=q, k=k, tier=tier, prefetch_depth=depth)
                want = engines["ram"].search(req)
                # a store opened anew maps nothing of its files yet: its first
                # search is what a process that just opened the store sees
                fresh = DatasetStore.open(str(directory))
                eng = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(
                    fresh, resident=False).enable_int8()
                cached = self._drop_cache(directory)
                self.sync()
                K.reset_launch_counts()  # the path: counters at 0 around one search
                t0 = time.perf_counter()
                got = eng.search(req)
                self.sync()
                first_ms = (time.perf_counter() - t0) * 1e3
                launches = dict(K.LAUNCHES)
                same = (torch.equal(got.topk.scores, want.topk.scores)
                        and torch.equal(got.topk.indices, want.topk.indices)
                        and torch.equal(torch.as_tensor(got.certified),
                                        torch.as_tensor(want.certified))
                        and got.stats["transfers"] == want.stats["transfers"] == n_shards
                        and got.stats["bytes_scanned"] == want.stats["bytes_scanned"])
                good = (same and got.plan.executor == want_exec
                        and all(launches[name] == n_shards for name in kernels)
                        and sum(launches.values()) == 2 * n_shards
                        and bool(torch.isfinite(got.topk.scores).all())
                        and tuple(got.topk.scores.shape) == (m, k)
                        and got.stats["health"]["retries"] == 0)
                warm_ms, all_ms = self.host_clock_ms(lambda: eng.search(req), cfg["repeats"])
                again = eng.search(req)
                self.sync()
                good &= (torch.equal(again.topk.scores, want.topk.scores)
                         and torch.equal(again.topk.indices, want.topk.indices))
                row = {"first_ms": first_ms, "cached_before_first": cached, "warm_ms": warm_ms,
                       "warm_all_ms": [round(t, 3) for t in all_ms],
                       "warm_GBps": shipped[tier] / (warm_ms * 1e-3) / 1e9,
                       "transfers": got.stats["transfers"],
                       "bytes_scanned": got.stats["bytes_scanned"], "launches": launches,
                       "bit_identical_to_ram": same}
                if tier == "int8":
                    row["first_split"] = {key: got.stats[key] for key in ("scan_ms", "gather_ms",
                                                                          "rescore_ms")}
                    row.update({key: again.stats[key] for key in ("scan_ms", "gather_ms",
                                                                  "rescore_ms")})
                per_tier[f"depth{depth}"] = row
                log(f"mmap {tier} depth{depth}: executor={got.plan.executor} first search on "
                    f"fresh mappings {first_ms:.3f} ms (Cached {cached}; bound "
                    f"{per_tier['disk_bound_ms']:.3f} ms at the disk rate), warm {warm_ms:.3f} "
                    f"ms (median of {cfg['repeats']}; {row['warm_GBps']:.3f} GB/s) against the "
                    f"staging-only bound {per_tier['staging_bound_ms']:.3f} ms; transfers "
                    f"{row['transfers']}, bytes_scanned {row['bytes_scanned']}, launches "
                    f"{launches}, health {got.stats['health']}, bit-identical to the host-RAM "
                    f"store={same}, ok={good} [{self.card}]")
                ok &= good
                results[tier] = (got, launches)
                fresh.close()
                del eng
            timing[tier] = per_tier

        # every file's CRC re-checked on every read
        checked = ExactKNN(k=k, backend="cuda", device=self.dev).fit_store(
            DatasetStore.open(str(directory), verify_on_read=True), resident=False)
        req = SearchRequest(queries=q, k=k)
        t0 = time.perf_counter()
        got = checked.search(req)
        self.sync()
        verify_ms = (time.perf_counter() - t0) * 1e3
        want = results["f32"][0]
        same = (torch.equal(got.topk.scores, want.topk.scores)
                and torch.equal(got.topk.indices, want.topk.indices)
                and got.stats["health"]["retries"] == 0)
        timing["verify_on_read_f32_ms"] = verify_ms
        log(f"mmap f32 verify_on_read: {verify_ms:.3f} ms, health {got.stats['health']}, "
            f"bit-identical={same} [{self.card}]")
        ok &= same
        log("mmap timings " + json.dumps(timing))

        # (c) the per-shard kernel steps on two shards read from the mapping
        f32_parts = [device_put_partition(store.read_shard(i), self.dev) for i in (0, 1)]
        int8_parts = [device_put_partition(store.read_shard(i, "int8"), self.dev) for i in (0, 1)]
        r_budget = max(1, min(n_shards * store.rows_per_shard, engines["mmap"].rescore_factor * k))
        ok &= self._streamed_kernels(engines["mmap"], qv, f32_parts, int8_parts, r_budget,
                                     results, label="mmap")
        for st in (store, ram):
            st.close()
        del engines, checked, f32_parts, int8_parts
        torch.cuda.empty_cache()
        return bool(ok)

    # --------------------------------------------------- phase 8: kernels
    def phase_kernels(self) -> bool:
        """The standalone entry points: l2dist, then topk over its matrix;
        then l2dist alone at each shape of STANDALONE["l2dist"]."""
        torch, K = self.torch, self.K
        from repro_torch.core.distance import row_norms_sq
        from repro_torch.kernels.l2dist import kernel as L
        from repro_torch.kernels.l2dist import ops as LO
        from repro_torch.kernels.topk import kernel as T
        from repro_torch.kernels.topk import ops as TO
        from repro_torch.kernels.topk.ref import topk_ref

        n, d, m, k = (STANDALONE[key] for key in ("n", "d", "m", "k"))
        x, queries = self._dataset(n, d, max(mm for mm, _ in STANDALONE["l2dist"]), seed=5)
        q = queries[:m]
        self.sync()
        K.reset_launch_counts()
        dist = LO.l2dist(q, x)
        v, i = TO.topk(dist, k)
        self.sync()
        launches = dict(K.LAUNCHES)
        ok = launches["l2dist"] >= 1 and launches["topk"] >= 1 and launches["knn_merge"] == 1
        label = f"standalone_m{m}_n{n}_d{d}_k{k}"
        log(f"{label}: launches={launches}")

        qn, xn = row_norms_sq(q), row_norms_sq(x)
        plain = L.l2dist_plain(q, x, qn, xn)
        tol = TOL_REL * (qn[:, None] + float(xn.max()))
        ok_l2 = bool(((dist - plain).abs() <= tol).all()) and bool(torch.isfinite(dist).all())
        del plain
        rv, ri = topk_ref(dist, k)
        topk_exact = torch.equal(v, rv) and torch.equal(i, ri)
        k_eff, bn = k, max(1024, k)
        n_tiles = -(-n // bn)
        splits = T.topk_splits(m, n_tiles, self.dev)
        sv, si, st = T.topk_scan(dist, k_eff, bn, splits, return_stats=True)
        pv, pi = T.topk_scan_plain(dist, k_eff, bn, splits)
        scan_exact = torch.equal(sv, pv) and torch.equal(si, pi)
        ok &= ok_l2 and topk_exact and scan_exact
        log(f"{label}: l2dist within tol of plain={ok_l2}; topk bit-identical to the full "
            f"sort={topk_exact}; topk scan bit-identical to plain={scan_exact}; ok={ok}")

        tk_ms = self.ms(lambda: T.topk_scan(dist, k_eff, bn, splits))
        tk_fused_ms = self.ms(lambda: T.topk_fused(dist, k_eff, bn))
        tk_plain_ms = self.ms(lambda: T.topk_scan_plain(dist, k_eff, bn, splits))
        tk_lib_ms = self.ms(lambda: torch.topk(dist, k, largest=False))
        merge_ms = self.ms(lambda: K.knn_merge(sv, si))
        merge_plain_ms = self.ms(lambda: K.knn_merge_plain(sv, si))
        flat = sv.reshape(m, -1)
        merge_lib_ms = self.ms(lambda: torch.topk(flat, k_eff, largest=False))

        # topk's function reads the scores once and writes the (m, k) result;
        # the design also writes S queues, and its survivor filter compares
        # every score once and sorts, searches and merges the survivors (the
        # queues are in shared memory: no device bytes)
        tk_bytes = m * n * 4 + m * k * 8
        tk_ops = m * n  # one comparison per score
        sel = self.select_work(st, k_eff, m * n)
        design_ms, _ = self.bound(m * n * 4 + sv.numel() * 8, m * n + sel["ops"])
        merge_bytes, merge_ops = self.merge_work(sv, si, *K.knn_merge_plain(sv, si))
        shape = {"shape": label, "splits": splits, "blocks": [1, bn], "select": sel,
                 "topk_with_merges_ms": tk_fused_ms, "kernels": {}}
        for name, t, tp, tl, lib, (bb, by), err in (
                ("topk", tk_ms, tk_plain_ms, tk_lib_ms, "torch.topk(scores, k, largest=False)",
                 self.bound(tk_bytes, tk_ops), 0.0 if scan_exact else math.inf),
                ("knn_merge", merge_ms, merge_plain_ms, merge_lib_ms,
                 "torch.topk(queues.reshape(m, -1))", self.bound(merge_bytes, merge_ops),
                 0.0 if topk_exact else math.inf)):
            shape["kernels"][name] = {
                "launches": launches[name], "max_abs_err": err, "ms": t, "plain_ms": tp,
                "bound_ms": bb, "bound_by": by, "library_ms": tl, "library": lib}
            log(f"{label}: {name} ms={t:.4f} plain_ms={tp:.4f} library_ms={tl:.4f} "
                f"bound_ms={bb:.4f} ({by}) launches={launches[name]}")
        shape["kernels"]["topk"]["design_bound_ms"] = design_ms
        log(f"{label}: topk S={splits} survivor filter {sel}")
        log(f"{label}: topk scan + merges ms={tk_fused_ms:.4f} (torch.topk {tk_lib_ms:.4f}); "
            f"bound over its S queues and survivor work design_bound_ms={design_ms:.4f}")
        self.shapes.append(shape)
        del dist, sv, si, pv, pi, flat
        for mm, dtype_name in STANDALONE["l2dist"]:
            ok &= self._l2dist_shape(L, x, queries[:mm], getattr(torch, dtype_name))
        self._l2dist_crossover(L, x, queries)
        return ok

    def _l2dist_shape(self, L, x, q, dtype) -> bool:
        """l2dist alone on (q, x) in `dtype`: one launch with the counters
        at 0, held to its plain version within TOL_REL·(qn + max xn), then
        timed beside it and beside torch.cdist's matrix-product form (one
        call, the same function up to the square root), all three over runs
        of STANDALONE["calls"] calls back to back (the wrapper's host work,
        tens of microseconds, would otherwise sit inside each window)."""
        torch = self.torch
        from repro_torch.core.distance import row_norms_sq

        q, x = q.to(dtype).contiguous(), x.to(dtype).contiguous()
        (m, d), n = q.shape, x.shape[0]
        qn, xn = row_norms_sq(q), row_norms_sq(x)
        self.sync()
        self.K.reset_launch_counts()
        got = L.l2dist_tiles(q, x, qn, xn)
        self.sync()
        launches = self.K.LAUNCHES["l2dist"]
        plain = L.l2dist_plain(q, x, qn, xn)
        diff = (got - plain).abs()
        err = float(diff.max())
        ok = (launches == 1 and bool((diff <= TOL_REL * (qn[:, None] + float(xn.max()))).all())
              and bool(torch.isfinite(got).all()))
        del got, plain, diff
        elem = x.element_size()
        nbytes = (m + n) * d * elem + (m + n) * 4 + m * n * 4
        bb, by = self.bound(nbytes, 2 * m * n * d)
        calls = STANDALONE["calls"]
        t = self.ms(lambda: L.l2dist_tiles(q, x, qn, xn), calls=calls)
        tp = self.ms(lambda: L.l2dist_plain(q, x, qn, xn), calls=calls)
        lib = "torch.cdist(q, x, compute_mode='use_mm_for_euclid_dist') (not squared)"
        try:
            tl = self.ms(lambda: torch.cdist(q, x, compute_mode="use_mm_for_euclid_dist"),
                         calls=calls)
        except RuntimeError as e:  # a yardstick only: the port never calls it
            log(f"  torch.cdist refused {dtype}: {e}")
            tl = None
        label = f"l2dist_m{m}_n{n}_d{d}_{str(dtype).split('.')[-1]}"
        shape = {"shape": label, "kernels": {"l2dist": {
            "launches": launches, "max_abs_err": err, "ms": t, "plain_ms": tp, "bound_ms": bb,
            "bound_by": by, "library_ms": tl, "library": lib}}}
        if (m, dtype) == (STANDALONE["m"], torch.float32):
            shape["cdist_direct_ms"] = self.ms(lambda: torch.cdist(
                q, x, compute_mode="donot_use_mm_for_euclid_dist"), calls=calls)
            log(f"{label}: cdist direct form ms={shape['cdist_direct_ms']:.4f}")
        if hasattr(L, "l2dist_config"):
            shape["config"] = L.l2dist_config(m, n, d, dtype)._asdict()
        log(f"{label}: l2dist ms={t:.4f} plain_ms={tp:.4f} library_ms={tl} bound_ms={bb:.4f} "
            f"({by}) max|d|={err:.3e} launches={launches} ok={ok} {shape.get('config', '')} "
            f"[{self.card}]")
        self.shapes.append(shape)
        return ok

    def _l2dist_crossover(self, L, x, queries) -> None:
        """Both l2dist kernels timed at the batches around the crossover
        (f32), the measurement STREAM_MAX_M rests on."""
        from repro_torch.core.distance import row_norms_sq

        if not hasattr(L, "l2dist_config"):
            log("l2dist crossover: this package has one l2dist kernel (no l2dist_config)")
            return
        sms = self.torch.cuda.get_device_properties(self.dev).multi_processor_count
        n, d = x.shape
        xn = row_norms_sq(x)
        for m in STANDALONE["crossover_ms"]:
            q = queries[:m].contiguous()
            qn = row_norms_sq(q)
            times = {path: self.ms(lambda: L.l2dist_launch(
                q, x, qn, xn, L.l2dist_config(m, n, d, q.dtype, sms, path)),
                calls=STANDALONE["calls"]) for path in ("stream", "tiled")}
            log(f"l2dist crossover m={m}: stream_ms={times['stream']:.4f} "
                f"tiled_ms={times['tiled']:.4f} (picked: {L.l2dist_config(m, n, d).path})")

    def kernels_line(self) -> dict:
        """One entry per kernel: the main path's launches and times summed
        over its runs (one of each shape), per-shape numbers beside."""
        out = []
        for name, (source, replaces) in KERNELS.items():
            per = [s["kernels"][name] | {"shape": s["shape"]} for s in self.shapes
                   if name in s["kernels"]]
            if not per:
                continue
            total = lambda key: sum(p[key] for p in per)  # noqa: E731
            lib = [p["library_ms"] for p in per]
            bound_ms = total("bound_ms")
            out.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": total("launches"), "max_abs_err": max(p["max_abs_err"] for p in per),
                "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": bound_ms,
                "bound_by": ("bytes" if sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
                             >= bound_ms / 2 else "operations"),
                "library_ms": None if None in lib else sum(lib),
                "shapes": per,
            })
        return {"kernels": out}


PHASES = ("exact", "gist", "msmarco", "int8", "streamed", "mmap", "kernels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (build always runs)")
    ap.add_argument("--package", type=Path, default=ROOT,
                    help="root of the checkout whose src/repro_torch is driven (default: "
                         "this script's)")
    args = ap.parse_args(argv)
    wanted = args.phases.split(",")
    if not set(wanted) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(wanted) - set(PHASES))}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.package.resolve() / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2
    if torch.cuda.get_device_name(0) != CARD:
        print(f"chip_smoke: the bounds are stated for {CARD}, not for "
              f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    failed = []
    t0 = time.perf_counter()
    try:
        lib = build.build()
        log(f"phase build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
        build.load_library()
    except Exception:
        traceback.print_exc()
        failed.append("build")
    smoke = Smoke(torch, torch.device("cuda"), " ".join(smi)) if not failed else None
    for name in PHASES if smoke else ():
        if name not in wanted:
            continue
        t1 = time.perf_counter()
        try:
            if not getattr(smoke, f"phase_{name}")():
                failed.append(name)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        log(f"phase {name}: {time.perf_counter() - t1:.1f} s, "
            f"{'FAILED' if name in failed else 'ok'}")
    if smoke is not None:
        log(json.dumps(smoke.kernels_line()))
    for line in smi:
        log(line)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
