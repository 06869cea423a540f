#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, in order (any failure makes the run exit non-zero):

1. build   — nvcc builds the kernel library from src/repro_torch/kernels/csrc
             into build/repro_torch/ (seconds printed).
2. exact   — knn_scan, knn_merge and knn_fused against their plain versions
             on integer-valued data in [-8, 8] with planted duplicate rows,
             +inf-norm rows and a ragged N, for l2/ip/cos, f32 and bf16,
             k in {1, 7, 72, 1024}, m in {1, 16}: values, indices and skip
             counts must be bit-identical (d = 960: every sum is below 2^24).
3. gist    — GIST shape, FQ-SD: N = 1,000,000, d = 960, m = 16, k = 1024
             through ExactKNN(backend="cuda").fit(x).search(...).
4. msmarco — MS-MARCO shape, FD-SQ: N = 8,841,823, d = 769, m = 1, k = 72
             and k = 1024, the dataset generated and padded on the card.

Phases 3 and 4 are the main path. The launch counters are set to 0 just
before each search and read just after; every kernel must have launched.
Each result is held against the plain version on the same padded operands
within TOL_REL·(qn + max xn) per score (f32 sums over d terms taken in
another order), with indices equal wherever the plain scores around them
are more than twice that apart. Each kernel is timed with CUDA events
(median of REPEATS after a warm-up) beside its plain version, one PyTorch
call computing the same function (a yardstick the port never calls), and
its bound on this card: over the padded operands the kernel reads, and
for the scan also over the unpadded rows alone. The bounds are stated for
the H100 SXM (CARD); on any other card the run stops before it measures.

Output: progress lines, the card's name and power limit as nvidia-smi gives
them, one {"kernels": [...]} line (per kernel: launches, ms, plain_ms,
library_ms and bound_ms summed over the main path's searches, one of each
shape, with the per-shape numbers under "shapes"), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

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
SOURCE = "src/repro_torch/kernels/csrc/knn.cu"
REPLACES = "src/repro/kernels/knn/kernel.py:121"
#: Shapes of the phases (paper Table 2 via src/repro/configs/knn_paper.py).
EXACT = dict(n=12_345, d=960, ks=(1, 7, 72, 1024), ms=(1, 16))
GIST = dict(n=1_000_000, d=960, m=16, k=1024)
MSMARCO = dict(n=8_841_823, d=769, m=1, ks=(72, 1024))


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, torch, dev):
        from repro_torch.kernels.knn import kernel as K, ops

        self.torch, self.K, self.ops, self.dev = torch, K, ops, dev
        self.bw, self.flops = PEAK_BW, PEAK_F32
        self.shapes: list[dict] = []  # one per main-path search

    # ------------------------------------------------------------ helpers
    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def ms(self, fn, repeats: int = REPEATS) -> float:
        """Median CUDA-event time of fn over `repeats` runs after a warm-up."""
        torch = self.torch
        fn()
        self.sync()
        times = []
        for _ in range(repeats):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def bound(self, nbytes: float, ops: float) -> tuple[float, str]:
        t_b, t_o = nbytes / self.bw * 1e3, ops / self.flops * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    @staticmethod
    def sort_ops(rows: int, L: int) -> int:
        """Compare-exchanges of a full bitonic sort of `rows` rows of L."""
        lg = int(math.log2(L))
        return rows * (L // 2) * lg * (lg + 1) // 2

    @staticmethod
    def update_ops(rows: int, k: int) -> int:
        """Lane minima plus the bitonic merge of one queue update."""
        return rows * (k + (k // 2) * int(math.log2(k)))

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
        log(f"phase exact: {cases - fails}/{cases} cases bit-identical "
            f"(values, indices, skip counts)")
        return fails == 0

    def _exact_case(self, call) -> str:
        torch, K = self.torch, self.K
        bm, bn, bd = call.blocks
        q, x, xn = call.q, call.x, call.xn
        qn = torch.sum(q.to(torch.float32) ** 2, dim=-1)
        m_tiles, n_tiles = q.shape[0] // bm, x.shape[0] // bn
        problems = []
        for splits in (K.scan_splits(m_tiles, n_tiles, bm, bn, call.k_eff, self.dev), 1):
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
        ok = res.plan.executor == "fdsq-cuda" and all(launches.values())
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
        splits = K.scan_splits(m_tiles, n_tiles, bm, bn, call.k_eff, self.dev)
        sv, si, sk = K.knn_scan(cq, cx, qn, cxn, call.k_eff, "l2", bm, bn, True, splits)
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

        merged_tiles = m_tiles * n_tiles - int(sk.sum())
        scan_bytes = (cx.numel() * cx.element_size() + cq.numel() * cq.element_size()
                      + (cxn.numel() + qn.numel()) * 4 + sv.numel() * 8 + sk.numel() * 4)
        scan_ops = (2 * cq.shape[0] * cx.shape[0] * cx.shape[1]
                    + merged_tiles * (self.sort_ops(bm, bn) + self.update_ops(bm, call.k_eff)))
        # the same bound without the zero columns and rows of the padding
        data_bound_ms = ds.n_valid * q.shape[1] * cx.element_size() / self.bw * 1e3
        merge_bytes = sv.numel() * 8 + mv.numel() * 8
        merge_ops = (splits - 1) * self.update_ops(cq.shape[0], call.k_eff)
        shape = {"shape": label, "splits": splits, "blocks": [bm, bn, call.blocks[2]],
                 "search_ms": statistics.median(e2e), "kernels": {}}
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
        shape["kernels"]["knn_scan"]["data_bound_ms"] = data_bound_ms
        log(f"{label}: knn_scan data-only bound_ms={data_bound_ms:.4f} "
            f"({ds.n_valid} rows x d={q.shape[1]}, padding excluded)")
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
        if self.dev.type == "cuda":
            log(f"msmarco: peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del eng
        torch.cuda.empty_cache()
        return ok

    def kernels_line(self) -> dict:
        """One entry per kernel: the main path's launches and times summed
        over its searches (one of each shape), per-shape numbers beside."""
        out = []
        for name in ("knn_scan", "knn_merge"):
            per = [s["kernels"][name] | {"shape": s["shape"]} for s in self.shapes]
            if not per:
                continue
            total = lambda key: sum(p[key] for p in per)  # noqa: E731
            lib = [p["library_ms"] for p in per]
            bound_ms = total("bound_ms")
            out.append({
                "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": total("launches"), "max_abs_err": max(p["max_abs_err"] for p in per),
                "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": bound_ms,
                "bound_by": ("bytes" if sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
                             >= bound_ms / 2 else "operations"),
                "library_ms": None if None in lib else sum(lib),
                "shapes": per,
            })
        return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    smoke = Smoke(torch, torch.device("cuda")) if not failed else None
    phases = (("exact", "phase_exact"), ("gist", "phase_gist"), ("msmarco", "phase_msmarco"))
    for name, method in phases if smoke else ():
        t1 = time.perf_counter()
        try:
            if not getattr(smoke, method)():
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
