"""Per-device block-shape and pipeline autotuner for the card's scan kernels.

The fused scans (``knn_scan`` behind ``fdsq-cuda``, ``knn_int8_scan``
behind ``fqsd-int8-cuda``) take a query block ``bm`` and a tile of ``bn``
dataset rows; which pair is fastest depends on the card and on the problem
(M, N, d, k, the int8 rescore budget). Instead of baked-in constants this
module

1. enumerates the *legal* candidates for a key (:func:`candidate_blocks`:
   the kernels' own limits, and only fixed points of
   ``ops.resolved_blocks``, so a stored winner is exactly what runs);
2. times each candidate on the card (:func:`autotune_knn`; with
   ``device="cpu"`` the kernels' plain versions run and the host clock
   ranks them), holding every candidate's answer to the default blocks'
   bits: a tuned plan answers as a default plan does, or the sweep raises;
3. persists the winner to a JSON cache under ``artifacts/autotune/``,
   named for the card, and
4. answers the planner's pure lookup (:func:`lookup_blocks`), so an
   ``ExecutionPlan`` carries tuned blocks instead of 0 (the kernel
   defaults).

The planner only ever *reads* the cache (a cold cache leaves the kernel
defaults), so planning stays pure and cheap; sweeps are explicit calls.
Tuned blocks ride the plan's ``cache_key()``, so a cache hit reproduces
the previous plan and the executor cache serves it with no new entry.

Cache key format (one entry per key; the JAX package writes the same):

    <kernel>|m<pow2-bucketed batch>|n<padded rows>|d<padded dim>|<dtype>|<metric>|k<k>[|r<rescore_factor>]

``<kernel>`` is the executor (``fdsq-cuda`` or ``fqsd-int8-cuda``; the JAX
package's ``fdsq-pallas`` / ``fqsd-int8-pallas`` entries may share a file
and are never read here). The ``|r`` field appears on int8 keys only: k
and the rescore budget set the queue width, so each gets its own entry.
M is bucketed to the next power of two, as the serving layer pads batches.

Two more entry kinds share the file (told apart by key prefix, validated
per kind on load):

    pipe|<executor>|m<pow2>|n<rows>|d<dim>|<dtype>|<metric>|k<k>
        -> PipelineKnobs(prefetch_depth, spec_trigger, rescore_factor,
           rows_per_shard): the end-to-end winner of
           :func:`autotune_pipeline` for the streamed int8 executors.

    capability|cuda
        -> {"compiled": bool}: whether the card's kernels build and agree
           with their plain versions here, written by
           :func:`probe_cuda_capability`. Where the JAX package falls back
           to plain ops on a negative verdict, ``planner.plan()`` here
           raises: no verdict swaps a kernel for plain ops on a card.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import NamedTuple

SCHEMA_VERSION = 1
DEFAULT_CACHE_DIR = os.path.join("artifacts", "autotune")

#: The bn sweep (the JAX package's); each is raised to the queue width, as
#: ``ops.resolved_blocks`` raises it, and filtered per key.
BN_CANDIDATES = (256, 512, 1024, 2048)

#: Rows of the dataset drawn per numpy stream (one thread each).
_DRAW_ROWS = 1 << 16


class BlockShapes(NamedTuple):
    block_m: int
    block_n: int
    block_d: int


class PipelineKnobs(NamedTuple):
    """End-to-end pipeline knobs for one streamed-int8 problem.

    prefetch_depth   DoubleBufferedStream depth (host->device overlap)
    spec_trigger     shard fraction after which the candidate gather is
                     speculatively started on a background thread
    rescore_factor   candidate budget multiplier (r = factor * k)
    rows_per_shard   advisory shard size for store builds; the planner
                     cannot re-shard an existing store
    """

    prefetch_depth: int
    spec_trigger: float
    rescore_factor: int
    rows_per_shard: int


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def tuning_key(kernel: str, m: int, n: int, d: int, dtype: str,
               metric: str, k: int, rescore_factor: int | None = None) -> str:
    """Stable string key for one tuning problem (see module docstring)."""
    key = (f"{kernel}|m{_next_pow2(max(1, int(m)))}|n{int(n)}|d{int(d)}"
           f"|{dtype}|{metric}|k{int(k)}")
    if rescore_factor is not None:
        key += f"|r{int(rescore_factor)}"
    return key


def pipeline_key(executor: str, m: int, n: int, d: int, dtype: str,
                 metric: str, k: int) -> str:
    """Stable key for one end-to-end streamed-pipeline tuning problem.

    Keyed on the executor: the sweep times whole searches. rescore_factor
    is not part of the key: it is one of the swept knobs.
    """
    return (f"pipe|{executor}|m{_next_pow2(max(1, int(m)))}|n{int(n)}"
            f"|d{int(d)}|{dtype}|{metric}|k{int(k)}")


def _validate_entry(key: str, e: dict) -> None:
    """Raise if one cache entry is malformed for its kind (prefix-typed)."""
    if key.startswith("pipe|"):
        PipelineKnobs(int(e["prefetch_depth"]), float(e["spec_trigger"]),
                      int(e["rescore_factor"]), int(e["rows_per_shard"]))
    elif key.startswith("capability|"):
        bool(e["compiled"])
    else:
        BlockShapes(int(e["block_m"]), int(e["block_n"]), int(e["block_d"]))


def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), sanitised for a
    file name; "cpu" where there is no card."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    kind = torch.cuda.get_device_name()
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", kind).strip("_") or "unknown"


class AutotuneCache:
    """JSON-persisted {key -> entry} map of the three entry kinds.

    Loading is tolerant: a missing, corrupted or wrong-schema file yields
    an empty cache (plans then carry the kernel defaults), a malformed
    entry is dropped alone, and the next put rewrites the file cleanly. A
    damaged cache can only un-tune serving, never take it down.
    ``path=None`` keeps the cache in memory.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._entries: dict[str, dict] = {}
        self._loaded = path is None

    @classmethod
    def for_device(cls, cache_dir: str = DEFAULT_CACHE_DIR) -> "AutotuneCache":
        return cls(os.path.join(cache_dir, f"{device_kind()}.json"))

    # ------------------------------------------------------------- storage
    def load(self) -> "AutotuneCache":
        self._loaded = True
        self._entries = {}
        if self.path is None or not os.path.exists(self.path):
            return self
        try:
            with open(self.path) as f:
                payload = json.load(f)
            entries = payload["entries"]
            if not isinstance(entries, dict):
                raise TypeError("entries must be a dict")
            ok: dict[str, dict] = {}
            for key, e in entries.items():
                try:
                    _validate_entry(key, e)
                except (ValueError, KeyError, TypeError):
                    continue  # a bad entry is dropped, not fatal
                ok[key] = dict(e)
            self._entries = ok
        except (OSError, ValueError, KeyError, TypeError):
            self._entries = {}  # corrupt cache == cold cache, never an error
        return self

    def save(self) -> None:
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        payload = {
            "schema_version": SCHEMA_VERSION,
            "device": os.path.splitext(os.path.basename(self.path))[0],
            "entries": self._entries,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    # -------------------------------------------------------------- access
    def _ensure(self) -> None:
        if not self._loaded:
            self.load()

    def get(self, key: str) -> BlockShapes | None:
        self._ensure()
        e = self._entries.get(key)
        if e is None or "block_m" not in e:
            return None
        return BlockShapes(int(e["block_m"]), int(e["block_n"]), int(e["block_d"]))

    def put(self, key: str, blocks: BlockShapes, **meta) -> None:
        self._ensure()
        self._entries[key] = {
            "block_m": int(blocks.block_m),
            "block_n": int(blocks.block_n),
            "block_d": int(blocks.block_d),
            **meta,
        }
        self.save()

    def get_pipeline(self, key: str) -> PipelineKnobs | None:
        self._ensure()
        e = self._entries.get(key)
        if e is None or "prefetch_depth" not in e:
            return None
        return PipelineKnobs(int(e["prefetch_depth"]), float(e["spec_trigger"]),
                             int(e["rescore_factor"]), int(e["rows_per_shard"]))

    def put_pipeline(self, key: str, knobs: PipelineKnobs, **meta) -> None:
        self._ensure()
        self._entries[key] = {
            "prefetch_depth": int(knobs.prefetch_depth),
            "spec_trigger": float(knobs.spec_trigger),
            "rescore_factor": int(knobs.rescore_factor),
            "rows_per_shard": int(knobs.rows_per_shard),
            **meta,
        }
        self.save()

    def get_capability(self, name: str = "cuda") -> bool | None:
        """Persisted capability verdict, or None if never probed."""
        self._ensure()
        e = self._entries.get(f"capability|{name}")
        if e is None or "compiled" not in e:
            return None
        return bool(e["compiled"])

    def put_capability(self, compiled: bool, name: str = "cuda", **meta) -> None:
        self._ensure()
        self._entries[f"capability|{name}"] = {"compiled": bool(compiled), **meta}
        self.save()

    def without_capability(self) -> "AutotuneCache":
        """Detached in-memory view of this cache minus capability verdicts
        (tuned entries stay visible; a persisted verdict does not)."""
        self._ensure()
        view = AutotuneCache(path=None)
        view._entries = {k: dict(v) for k, v in self._entries.items()
                         if not k.startswith("capability|")}
        return view

    def __len__(self) -> int:
        self._ensure()
        return len(self._entries)

    def keys(self):
        self._ensure()
        return tuple(self._entries)


# ------------------------------------------------------- default instance
_default_cache: AutotuneCache | None = None


def default_cache() -> AutotuneCache:
    """Process-wide cache for the live device (lazy; read by the planner)."""
    global _default_cache
    if _default_cache is None:
        _default_cache = AutotuneCache.for_device()
    return _default_cache


def set_default_cache(cache: AutotuneCache | None) -> None:
    """Swap the planner-visible cache (tests, sweeps; None resets to the
    lazy per-device default)."""
    global _default_cache
    _default_cache = cache


def lookup_blocks(kernel: str, m: int, n: int, d: int, dtype: str,
                  metric: str, k: int,
                  rescore_factor: int | None = None) -> BlockShapes | None:
    """Pure read the planner calls: tuned blocks for a key, else None.

    Never raises: a broken cache must not break planning; it only costs the
    tuning."""
    try:
        return default_cache().get(
            tuning_key(kernel, m, n, d, dtype, metric, k, rescore_factor))
    except Exception:
        return None


def lookup_pipeline(executor: str, m: int, n: int, d: int, dtype: str,
                    metric: str, k: int) -> PipelineKnobs | None:
    """Pure read the planner calls: tuned pipeline knobs, else None. Never
    raises."""
    try:
        return default_cache().get_pipeline(
            pipeline_key(executor, m, n, d, dtype, metric, k))
    except Exception:
        return None


def lookup_cuda_capability() -> bool | None:
    """Pure read: the persisted CUDA verdict for this device, else None
    (never probed: planning stays permissive). Never raises."""
    try:
        return default_cache().get_capability("cuda")
    except Exception:
        return None


def probe_cuda_capability(cache: AutotuneCache | None = None) -> bool:
    """Build the kernel library, launch ``knn_scan`` (and its merge) once on
    a small integer-valued input, hold the answer to the plain version's
    bits, and persist the verdict under ``capability|cuda``.

    Returns True. A failure (the build, the launch, or a disagreement)
    persists ``false`` and raises; from then on ``planner.plan()`` refuses
    every ``backend="cuda"`` plan on this device until the entry changes.
    With no card there is nothing to probe: RuntimeError, nothing persisted.
    Called at serving start-up, never from planning.
    """
    import torch

    if cache is None:
        cache = default_cache()
    if not torch.cuda.is_available():
        raise RuntimeError("probe_cuda_capability: there is no CUDA device to probe")
    from repro_torch.kernels.knn import ops

    name = torch.cuda.get_device_name()
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-8, 9, (4096, 128), generator=g).to(torch.float32)
    q = torch.randint(-8, 9, (16, 128), generator=g).to(torch.float32)
    try:
        want = ops.knn(q, x, 10)
        got = ops.knn(q.cuda(), x.cuda(), 10)
        torch.cuda.synchronize()
        if not (torch.equal(got.scores.cpu(), want.scores)
                and torch.equal(got.indices.cpu(), want.indices)):
            raise RuntimeError("knn_scan disagrees with its plain version")
    except Exception as e:  # record the verdict, then re-raise
        cache.put_capability(False, device=name, error=repr(e)[:300])
        raise RuntimeError(
            f"probe_cuda_capability: the kernels fail on {name}; verdict false persisted "
            f"in {cache.path or 'the in-memory autotune cache'}") from e
    cache.put_capability(True, device=name)
    return True


# --------------------------------------------------------------- sweeping
def candidate_blocks(m: int, n: int, d: int, k: int,
                     rescore_factor: int | None = None) -> list[BlockShapes]:
    """The legal (bm, bn, bd) sweep for one problem.

    ``rescore_factor=None`` is the f32 scan (queue k_eff), an int the int8
    scan (queue q_len = 2·next_pow2(rescore_factor·k_eff)). bm is a row
    block the kernels are built for, at most next_pow2(m) and the kernel's
    shared-memory limit; bn is a ``BN_CANDIDATES`` value raised to the
    queue width (so q_len <= bn), at most 2·round_up(n, 256) unless it is
    the smallest; bd is the one value ``resolved_blocks`` gives: the card
    stages 32 features a slice whatever bd is, so it is not swept. Every
    candidate is a fixed point of ``ops.resolved_blocks``: the blocks a
    plan stores are the blocks that run, never clamped again.
    """
    from repro_torch.kernels.knn import kernel as K
    from repro_torch.kernels.knn.ops import resolved_blocks

    int8 = rescore_factor is not None
    _, queue_bn, bd = resolved_blocks(k, d, 1, 1, m=m, rescore_factor=rescore_factor)
    bm_max = min(_next_pow2(max(1, m)), K.int8_max_block_m() if int8 else K.max_block_m())
    bns = sorted({max(bn, queue_bn) for bn in BN_CANDIDATES})
    bns = [bn for i, bn in enumerate(bns) if i == 0 or bn <= 2 * _round_up(max(1, n), 256)]
    return [BlockShapes(bm, bn, bd) for bm in K._BLOCK_ROWS if bm <= bm_max for bn in bns]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_call(fn, dev, repeats: int):
    """(median seconds of `repeats` calls after a warm one, the warm call's
    result); each call ends in a synchronise on the card."""
    out = fn()
    _sync(dev)
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2], out


def _draw(seed, rows: int, d: int, dev):
    """A (rows, d) f32 tensor of standard normal draws on `dev`: one numpy
    stream a block of _DRAW_ROWS rows (``SeedSequence(seed).spawn``), drawn
    on threads, so the values depend on the seed alone."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    out = torch.empty((rows, d), dtype=torch.float32, device=dev)
    starts = range(0, rows, _DRAW_ROWS)
    seqs = np.random.SeedSequence(seed).spawn(len(starts))

    def fill(i):
        r0 = starts[i]
        block = np.random.default_rng(seqs[i]).standard_normal(
            (min(_DRAW_ROWS, rows - r0), d), dtype=np.float32)
        out[r0: r0 + block.shape[0]].copy_(torch.from_numpy(block))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(len(starts))))
    return out


def _same(a, b) -> bool:
    """Two answers (TopK, or (TopK, certificate)) agree bit for bit."""
    import torch

    if isinstance(a, tuple) and not hasattr(a, "scores"):
        return all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "scores"):
        return torch.equal(a.scores, b.scores) and torch.equal(a.indices, b.indices)
    return torch.equal(a, b)


def autotune_knn(
    m: int,
    n: int,
    d: int,
    k: int = 10,
    metric: str = "l2",
    dtype: str = "float32",
    tier: str = "f32",
    rescore_factor: int = 4,
    cache: AutotuneCache | None = None,
    repeats: int = 2,
    max_candidates: int | None = None,
    seed: int = 0,
    device=None,
) -> tuple[BlockShapes, dict]:
    """Sweep the legal blocks of one key and persist the winner. Returns
    (winner, {"bmxbnxbd" -> median seconds}).

    Pass the PLANNER-VISIBLE geometry: m = plan.m, n = plan.padded_rows,
    d = plan.padded_dim (``ExactKNN.plan_for`` gives them), so the stored
    key is the one ``planner.plan()`` looks up. Rows and queries are
    seeded numpy draws; each candidate runs through ``ops.knn`` (tier
    "f32", the ``fdsq-cuda`` executor's call, dataset norms given) or
    ``ops.knn_int8`` (tier "int8", ``fqsd-int8-cuda``), timed on the host
    clock around a synchronise. ``device=None`` is the card (raising where
    there is none); ``device="cpu"`` ranks the plain versions.

    The default blocks' answer is computed first; every candidate must
    return the same values, indices (and int8 certificates) bit for bit, or
    the sweep raises: on the card each score is summed in one order
    whatever the blocks. Nothing falls back: a candidate that fails to
    build or launch raises.
    """
    import torch

    from repro_torch.core.distance import row_norms_sq
    from repro_torch.core.engine import _normalize_rows, resolve_device
    from repro_torch.kernels.knn import ops

    dev = resolve_device(device)
    if cache is None:
        cache = default_cache()
    q = _draw([seed, 1], m, d, dev)
    x = _draw([seed, 2], n, d, dev)
    xn = row_norms_sq(x)
    if tier == "int8":
        from repro_torch.core.quantized import quantize_dataset

        kernel, key_factor = "fqsd-int8-cuda", rescore_factor
        ds = quantize_dataset(x)

        def run(blocks):
            return ops.knn_int8(q, ds, x, k, rescore_factor, *blocks)
    elif tier == "f32":
        kernel, key_factor = "fdsq-cuda", None
        wdtype = getattr(torch, dtype)
        q, x = q.to(wdtype), x.to(wdtype)
        if metric == "cos":  # the engine normalises resident rows once, at fit
            x = _normalize_rows(x, wdtype)

        def run(blocks):
            return ops.knn(q, x, k, metric, x_norms=xn, block_m=blocks[0],
                           block_n=blocks[1], block_d=blocks[2],
                           x_prenormalized=metric == "cos")
    else:
        raise ValueError(f"unknown tier {tier!r}; known: f32, int8")

    default = ops.resolved_blocks(k, d, m=m, rescore_factor=key_factor)
    want = run(default)
    cands = candidate_blocks(m, n, d, k, key_factor)
    if max_candidates is not None:
        cands = cands[:max_candidates]
    timings: dict[str, float] = {}
    best: BlockShapes | None = None
    best_t = float("inf")
    for blocks in cands:
        t, got = _time_call(lambda: run(blocks), dev, repeats)
        if not _same(got, want):
            raise RuntimeError(
                f"autotune_knn: blocks {tuple(blocks)} answer differently from the default "
                f"blocks {default} ({kernel}, m={m}, n={n}, d={d}, k={k})")
        timings["x".join(map(str, blocks))] = t
        if t < best_t:
            best, best_t = blocks, t
    cache.put(tuning_key(kernel, m, n, d, dtype, metric, k, key_factor), best,
              us_per_call=best_t * 1e6, n_candidates=len(cands))
    return best, timings


# ------------------------------------------------- end-to-end pipeline sweep
#: Pipeline sweep space (small by design: each point is a whole timed
#: search).
PIPE_PREFETCH_CANDIDATES = (1, 2, 4)
PIPE_TRIGGER_CANDIDATES = (0.25, 0.5, 0.75, 1.0)
PIPE_RESCORE_CANDIDATES = (2, 4, 8)


def autotune_pipeline(
    m: int,
    n: int,
    d: int,
    k: int = 10,
    metric: str = "l2",
    cache: AutotuneCache | None = None,
    repeats: int = 2,
    prefetch_candidates: tuple[int, ...] = PIPE_PREFETCH_CANDIDATES,
    trigger_candidates: tuple[float, ...] = PIPE_TRIGGER_CANDIDATES,
    rescore_candidates: tuple[int, ...] = PIPE_RESCORE_CANDIDATES,
    shard_candidates: tuple[int, ...] | None = None,
    directory: str | None = None,
    seed: int = 0,
    device=None,
) -> tuple[PipelineKnobs, dict]:
    """End-to-end sweep of the streamed-int8 pipeline knobs: a store of
    seeded numpy rows per shard-size candidate (host RAM, or files under
    ``directory/shard<rows>``), whole ``search()`` calls timed per
    (prefetch_depth, spec_trigger, rescore_factor), the winner persisted
    under :func:`pipeline_key`. Returns (winner, {label -> median s}).

    Each store's int8 tier is quantised once and shared by the engines of
    every rescore candidate. Every combination's answer must equal, bit for
    bit, the answer at the default knobs (depth 2, trigger 0.5, rescore 4)
    over the first store, or the sweep raises: the knobs reschedule reads
    and resize the candidate set, and the certificate and the exact
    fallback keep every answer exact.

    The winner is persisted for both ``fqsd-int8-streamed`` and
    ``fqsd-int8-mmap-streamed`` (the mirror tagged ``mirrored=True``).
    Default shard candidates are exact divisors of n (multiples of 128), so
    the swept store keeps ``padded_rows == n``. ``rows_per_shard`` in the
    winner is advisory: it applies when a store is built.
    """
    from repro_torch.api.types import SearchRequest
    from repro_torch.core.engine import (
        DEFAULT_PREFETCH_DEPTH,
        DEFAULT_RESCORE_FACTOR,
        ExactKNN,
        resolve_device,
    )
    from repro_torch.core.executors import DEFAULT_SPEC_TRIGGER
    from repro_torch.store import DatasetStore

    if metric != "l2":
        raise ValueError("the streamed int8 pipeline serves l2 only")
    dev = resolve_device(device)
    if cache is None:
        cache = default_cache()
    x = _draw([seed, 2], n, d, "cpu").numpy()
    q = _draw([seed, 1], m, d, "cpu").numpy()
    if shard_candidates is None:
        shard_candidates = tuple(
            s for s in (n // 4, n // 8, n // 16)
            if s >= 128 and s % 128 == 0 and n % s == 0
        ) or (max(128, (n // 8) // 128 * 128 or 128),)

    def engine(store, rescore):
        eng = ExactKNN(k=k, metric=metric, backend="cuda", device=dev,
                       rescore_factor=rescore).fit_store(store, resident=False)
        return eng.enable_int8()

    def search(eng, prefetch, trigger):
        res = eng.search(SearchRequest(queries=q, k=k, tier="int8", prefetch_depth=prefetch,
                                       spec_trigger=trigger))
        return res.topk

    timings: dict[str, float] = {}
    best: PipelineKnobs | None = None
    best_t = float("inf")
    geom = None  # planner-visible (padded_rows, padded_dim) of the winner
    want = None
    for rows_per_shard in shard_candidates:
        where = (None if directory is None
                 else os.path.join(directory, f"shard{rows_per_shard}"))
        store = DatasetStore.from_array(x, rows_per_shard=rows_per_shard, directory=where)
        try:
            if want is None:
                want = search(engine(store, DEFAULT_RESCORE_FACTOR), DEFAULT_PREFETCH_DEPTH,
                              DEFAULT_SPEC_TRIGGER)
            for rescore in rescore_candidates:
                eng = engine(store, rescore)
                meta = eng.dataset_meta(tier="int8")
                for prefetch in prefetch_candidates:
                    for trigger in trigger_candidates:
                        t, got = _time_call(lambda: search(eng, prefetch, trigger), dev,
                                            repeats)
                        label = f"shard{rows_per_shard}|pf{prefetch}|tr{trigger}|r{rescore}"
                        if not _same(got, want):
                            raise RuntimeError(
                                f"autotune_pipeline: {label} answers differently from the "
                                "default knobs")
                        timings[label] = t
                        if t < best_t:
                            best_t = t
                            best = PipelineKnobs(prefetch, trigger, rescore, rows_per_shard)
                            geom = (meta.padded_rows, meta.padded_dim)
        finally:
            store.close()

    for i, executor in enumerate(("fqsd-int8-streamed", "fqsd-int8-mmap-streamed")):
        cache.put_pipeline(
            pipeline_key(executor, m, geom[0], geom[1], "float32", metric, k),
            best, us_per_call=best_t * 1e6, n_candidates=len(timings),
            mirrored=bool(i))
    return best, timings
