"""ExactKNN — thin facade over the store + planner/executor core.

    ExactKNN (this module)          facade: owns config + device views only
        -> store.DatasetStore       the padded resident dataset
        -> planner.plan(...)        PURE: shapes + store meta -> ExecutionPlan
        -> executors.execute(...)   registry: plan -> cached callable
             fdsq-torch / fqsd-torch / fdsq-cuda       f32 tier
             fqsd-int8-torch / fqsd-int8-cuda          certified int8 tier

One engine plays the role of the single physical configuration: FD-SQ and
FQ-SD are logical configurations over the same building blocks, chosen per
request, and switching between them for shapes already seen adds nothing
to the executable cache (``repro_torch.core.executors.cache_info()``).

The engine runs on a CUDA device: ``device=None`` means ``cuda`` and raises
``RuntimeError`` where there is none. The plain paths run on the CPU only
when the caller asks with ``device="cpu"``.

Usage (request-first API — every option is a per-request fact):
    eng = ExactKNN(k=10, metric="l2", backend="cuda")
    eng.fit(dataset)                         # numpy array or tensor
    res = eng.search(SearchRequest(queries=q))             # auto mode
    res = eng.search(SearchRequest(queries=Q, mode_hint="fqsd", k=3))
    res.topk, res.plan, res.kernel_stats, res.stats

    eng.enable_int8()                        # quantise once (l2 engines)
    res = eng.search(SearchRequest(queries=Q, tier="int8"))
    res.certified                            # (m,) bool; every row exact

The port serves resident single-device data. Out-of-core stores,
mutations and meshes raise ``NotImplementedError`` naming the slice of the
port that brings them.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from repro_torch.api.types import AUTO_FDSQ_MAX_BATCH, SearchRequest, SearchResult
from repro_torch.core import partition as part
from repro_torch.core.distance import Metric, row_norms_sq, validate_metric
from repro_torch.core.executors import ExecContext, TieredResident, execute
from repro_torch.core.planner import (
    Backend,
    DatasetMeta,
    DatasetStoreMeta,
    EngineConfig,
    ExecutionPlan,
    plan as plan_fn,
)
from repro_torch.core.quantized import QuantizedDataset
from repro_torch.core.topk import TopK


def resolve_device(device) -> torch.device:
    """The engine's device: ``None`` means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ExactKNN runs on a CUDA device and none is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _normalize_rows(vec: torch.Tensor, dtype) -> torch.Tensor:
    """L2-normalised rows (zero rows stay zero), cast to `dtype`."""
    rn = torch.sqrt(row_norms_sq(vec))[:, None]
    return torch.where(torch.isfinite(rn) & (rn > 0),
                       vec.to(torch.float32) / torch.clamp_min(rn, 1e-30),
                       0.0).to(dtype)


class ExactKNN:
    def __init__(
        self,
        k: int,
        metric: Metric = "l2",
        backend: Backend = "torch",
        chunk_rows: int = 8192,
        n_partitions: int = 8,
        dtype=torch.float32,
        device=None,
        mesh=None,
        rescore_factor: int | None = None,
    ):
        validate_metric(metric)
        if k < 1:
            raise ValueError("k must be >= 1")
        if rescore_factor is not None and rescore_factor < 1:
            raise ValueError(f"rescore_factor must be >= 1, got {rescore_factor}")
        if mesh is not None:
            raise NotImplementedError("sharded (mesh) search is ported in the mesh slice")
        self.device = resolve_device(device)
        self.k = int(k)
        self.metric = metric
        self.backend: Backend = backend
        self.chunk_rows = int(chunk_rows)
        self.n_partitions = int(n_partitions)
        self.dtype = dtype
        #: int8 rescore budget: r = next_pow2(rescore_factor·next_pow2(k))
        self.rescore_factor = 4 if rescore_factor is None else int(rescore_factor)
        self._store = None
        # cos + fused backend: the resident view is normalised at fit time,
        # so the kernel skips its own dataset pass per query batch
        self._cos_prenormalized = metric == "cos" and backend == "cuda"
        self._ds: part.PaddedDataset | None = None  # device f32 view
        self._int8: QuantizedDataset | None = None  # device int8 view
        self._plans: list[ExecutionPlan] = []
        self._last_ctx: ExecContext | None = None

    # ------------------------------------------------------------------ fit
    def fit(self, vectors) -> "ExactKNN":
        """Load the dataset device-resident (FD-SQ, fig. 2 arrow 1).

        Accepts a numpy array or a tensor; a tensor already on the engine's
        device is padded there, with no host copy.
        """
        from repro_torch.store import DatasetStore

        v = vectors if isinstance(vectors, torch.Tensor) else np.asarray(vectors)
        if v.ndim != 2:
            raise ValueError(f"expected (N, d) dataset, got {tuple(v.shape)}")
        store = DatasetStore.from_array(v, row_mult=self._row_mult())
        return self.fit_store(store)

    def fit_store(self, store, resident: bool | None = True) -> "ExactKNN":
        """Attach a DatasetStore and put its rows on the engine's device."""
        if resident is False:
            raise NotImplementedError(
                "out-of-core (non-resident) stores are ported in the streaming slice")
        self._store = store
        self._int8 = None
        host = store.resident()
        self._attach(host.vectors, host.norms, host.n_valid,
                     prenormalized=False)
        return self

    def _attach(self, vectors: torch.Tensor, norms: torch.Tensor, n_valid: int,
                prenormalized: bool) -> None:
        """Make (vectors, norms) the resident view. Rows are normalised here
        for cos on the fused backend unless `prenormalized` says they are."""
        vec = vectors.to(device=self.device, dtype=self.dtype)
        if self._cos_prenormalized and not prenormalized:
            # cos is scale-invariant; the norms channel keeps the RAW norms
            # (it is the validity mask: +inf = padding)
            vec = _normalize_rows(vec, self.dtype)
        self._ds = part.PaddedDataset(vec, norms.to(self.device), int(n_valid), 0)

    def _row_mult(self) -> int:
        """Row alignment: rows must split evenly over the partitions."""
        return part.LANE * self.n_partitions

    @property
    def store(self):
        """The attached DatasetStore (None before fit)."""
        return self._store

    @property
    def is_fitted(self) -> bool:
        return self._ds is not None

    @property
    def n(self) -> int:
        self._require_fit()
        return self._store.n_live if self._store is not None else self._ds.n_valid

    def _require_fit(self):
        if not self.is_fitted:
            raise RuntimeError("call .fit(dataset) first")

    def _padded_dim(self) -> int:
        return int(self._ds.vectors.shape[1])

    def _pad_queries(self, q) -> torch.Tensor:
        q = torch.as_tensor(q).to(device=self.device, dtype=self.dtype)
        if q.ndim == 1:
            q = q[None, :]
        return part.pad_dim(q, self._padded_dim())

    # --------------------------------------------------- later slices
    def upsert(self, vectors):
        raise NotImplementedError("store mutations are ported in the store slice")

    def delete(self, ids):
        raise NotImplementedError("store mutations are ported in the store slice")

    # ---------------------------------------------------------- int8 tier
    def enable_int8(self) -> "ExactKNN":
        """Materialise the store's int8 tier (the 1 B/element scan tier) and
        put it on the engine's device beside the f32 view."""
        self._require_fit()
        if self._store is None:
            raise RuntimeError("int8 tier requires a DatasetStore-backed fit")
        if self.metric != "l2":
            raise ValueError("int8 tier supports the l2 metric only")
        self._store.ensure_tier("int8")
        self._int8 = QuantizedDataset(
            *(t.to(self.device) for t in self._store.int8_resident()))
        return self

    @property
    def has_int8(self) -> bool:
        """The engine can serve tier="int8" (a device int8 view exists)."""
        return self._int8 is not None

    @property
    def last_certificate(self):
        """Per-query exactness certificate of the most recent int8 plan
        (None when the last plan read the f32 tier)."""
        return self._last_ctx.certificate if self._last_ctx else None

    @property
    def last_kernel_stats(self) -> dict | None:
        """Observability of the most recent fused-kernel plan (pruning skip
        rate, resolved tile shapes); None for the plain executors."""
        return self._last_ctx.kernel_stats if self._last_ctx else None

    # ------------------------------------------------------------ planning
    def config(self) -> EngineConfig:
        """The engine's knobs as pure planner input."""
        return EngineConfig(
            k=self.k, metric=self.metric, backend=self.backend,
            chunk_rows=self.chunk_rows, n_partitions=self.n_partitions,
            rescore_factor=self.rescore_factor,
            dtype=str(self.dtype).removeprefix("torch."),
        )

    def dataset_meta(self, tier: str = "f32") -> DatasetMeta:
        """Planner-visible storage facts."""
        self._require_fit()
        if self._store is not None:
            return self._store.meta(device_resident=True, tier=tier)
        rows = int(self._ds.vectors.shape[0])
        return DatasetStoreMeta(padded_rows=rows, padded_dim=self._padded_dim(),
                                n_valid=int(self._ds.n_valid), tier=tier,
                                rows_per_shard=rows)

    def plan_for(self, mode: str, m: int = 1, tier: str = "f32", **kw) -> ExecutionPlan:
        """Plan without executing — what `mode` with an m-row batch would run."""
        self._require_fit()
        return plan_fn((m, self._padded_dim()), self.dataset_meta(tier=tier),
                       self.config(), mode, **kw)

    def _run(self, p: ExecutionPlan, queries: torch.Tensor, dataset) -> TopK:
        self._plans.append(p)
        ctx = ExecContext(cos_prenormalized=self._cos_prenormalized)
        self._last_ctx = ctx
        return execute(p, queries, dataset, ctx)

    @property
    def plans(self) -> list[ExecutionPlan]:
        """Every plan executed, in order (observability / tests)."""
        return list(self._plans)

    # ------------------------------------------------------------ request API
    @property
    def n_ids(self) -> int:
        """Size of the row-id space; ``SearchRequest.filter_mask`` must have
        exactly this length."""
        self._require_fit()
        return self._store.n_ids if self._store is not None else int(self._ds.n_valid)

    def _masked_resident(self, mask: torch.Tensor | None) -> part.PaddedDataset:
        """Resident view with a filter mask folded onto the norms channel
        (+inf = excluded: runtime data, shapes unchanged)."""
        ds = self._ds
        if mask is None:
            return ds
        keep = torch.ones(ds.vectors.shape[0], dtype=torch.bool, device=self.device)
        keep[: ds.n_valid] = mask[: ds.n_valid]
        norms = torch.where(keep, ds.norms, torch.inf)
        return part.PaddedDataset(ds.vectors, norms, ds.n_valid, ds.base_index)

    def _masked_int8(self, mask: torch.Tensor | None) -> QuantizedDataset:
        """Int8 view under the same mask: norms_sq is the int8 executors'
        validity channel, exactly as the f32 norms are."""
        q8 = self._int8
        if mask is None:
            return q8
        keep = torch.ones(q8.norms_sq.shape[0], dtype=torch.bool, device=self.device)
        keep[: self._ds.n_valid] = mask[: self._ds.n_valid]
        return q8._replace(norms_sq=torch.where(keep, q8.norms_sq, torch.inf))

    def search(self, request: SearchRequest) -> SearchResult:
        """Serve one :class:`SearchRequest` — the single entry point.

        Normalises the per-request options (k, metric, mode, filter mask,
        deadline) and routes through ``planner.plan``. mode_hint="auto"
        takes the FD-SQ plan for micro-batches (<= AUTO_FDSQ_MAX_BATCH
        rows) and the FQ-SD plan beyond.
        """
        if not isinstance(request, SearchRequest):
            raise TypeError(
                f"search() takes a SearchRequest, got {type(request).__name__}")
        self._require_fit()
        k = self.k if request.k is None else int(request.k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        metric = self.metric if request.metric is None else request.metric
        validate_metric(metric)
        if self._cos_prenormalized and metric != "cos":
            raise ValueError(
                "this engine L2-normalised its resident rows at fit time "
                f"(cos metric, cuda backend); per-request metric={metric!r} "
                "would score normalised rows — fit a separate engine")
        tier = "f32" if request.tier == "auto" else request.tier
        if tier == "int8":
            if request.mode_hint == "fdsq":
                raise ValueError(
                    "tier='int8' is a throughput (FQ-SD) tier and cannot "
                    "serve an explicit mode_hint='fdsq' request")
            if not self.has_int8:
                raise RuntimeError("int8 tier not enabled; call enable_int8() first")
            if metric != "l2":
                raise ValueError("int8 tier supports the l2 metric only")
        return self._search_pinned(request, k, metric, tier)

    def _search_pinned(self, request: SearchRequest, k: int, metric: str,
                       tier: str) -> SearchResult:
        """The body of :meth:`search` on the resident view."""
        qv = self._pad_queries(request.queries)
        m = int(qv.shape[0])
        mode = request.mode_hint
        if tier == "int8":
            mode = "fqsd"  # the int8 tier is an FQ-SD tier whatever the batch
        elif mode == "auto":
            mode = "fdsq" if m <= AUTO_FDSQ_MAX_BATCH else "fqsd"
        mask = request.filter_mask
        if mask is not None:
            mask = torch.as_tensor(mask).to(device=self.device, dtype=torch.bool).reshape(-1)
            if mask.shape[0] != self.n_ids:
                raise ValueError(
                    "filter_mask must cover the engine's global id space "
                    f"({self.n_ids} rows), got {mask.shape[0]}")
        t0 = time.perf_counter()
        p = plan_fn((m, self._padded_dim()), self.dataset_meta(tier=tier),
                    self.config(), mode, k=k, metric=metric)
        dataset = self._masked_resident(mask)
        if p.tier == "int8":
            dataset = TieredResident(dataset, self._masked_int8(mask))
        out = self._run(p, qv, dataset)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        ctx = self._last_ctx
        stats = {
            "k": k, "metric": metric, "m": m, "batched": m,
            "bytes_scanned": p.padded_rows * p.padded_dim * (
                1 if p.tier == "int8" else self._ds.vectors.element_size()),
            "dispatch_ms": dispatch_ms,
            "health": {"retries": 0, "failed_shards": [], "degraded": [],
                       "slow_shards": [], "shed": False},
            "partial": False,
        }
        if request.deadline_ms is not None:
            stats["deadline_ms"] = request.deadline_ms
        return SearchResult(topk=out, plan=p, tier=p.tier,
                            certified=True if ctx.certificate is None else ctx.certificate,
                            kernel_stats=ctx.kernel_stats, stats=stats,
                            rid=request.rid)

    def query_batch_int8(self, queries) -> TopK:
        """Deprecated int8-tier path; delegates to :meth:`search`."""
        warnings.warn(
            "ExactKNN.query_batch_int8(Q) is deprecated; use ExactKNN.search("
            "SearchRequest(queries=Q, tier='int8')) instead",
            DeprecationWarning, stacklevel=2)
        return self.search(SearchRequest(queries=queries, tier="int8",
                                         mode_hint="fqsd")).topk


__all__ = ["ExactKNN", "ExecutionPlan", "SearchRequest", "SearchResult",
           "resolve_device"]
