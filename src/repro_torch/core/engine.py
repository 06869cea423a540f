"""ExactKNN — thin facade over the store + planner/executor core.

    ExactKNN (this module)          facade: owns config + device views only
        -> store.DatasetStore       equal padded shards: one resident, or
                                    many in (pinned) host RAM
        -> planner.plan(...)        PURE: shapes + store meta -> ExecutionPlan
        -> executors.execute(...)   registry: plan -> cached callable
             fdsq-torch / fqsd-torch / fdsq-cuda       f32 tier, resident
             fqsd-int8-torch / fqsd-int8-cuda          certified int8 tier, resident
             fqsd-streamed / fqsd-mmap-streamed        f32 tier, out of core
             fqsd-int8-streamed / -mmap-streamed       int8 tier, out of core
             fdsq-sharded / fqsd-sharded               f32 tier, on a mesh
             fdsq-sharded-int8                         int8 tier, on a mesh
             fqsd-sharded-int8 / -int8-streamed        int8 tier, ring over a mesh

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

    store = DatasetStore.from_array(x, rows_per_shard=65536, pin_memory=True)
    eng = ExactKNN(k=10, backend="cuda").fit_store(store, resident=False)
    res = eng.search(SearchRequest(queries=Q))   # shards stream to the card
    res.stats["transfers"], res.stats["bytes_scanned"], res.stats["health"]

    store = DatasetStore.open(directory, verify=True)   # a store in files
    eng = ExactKNN(k=10, backend="cuda").fit_store(store, resident=False)
    res = eng.search(SearchRequest(queries=Q))   # mapped shards stream

    ids = eng.upsert(new_rows)               # visible to the next request
    eng.delete(ids[:1])                      # ditto; still exact
    eng.store.compact()                      # the next search refits

Data is resident on one device or row-sharded over a device mesh
(``mesh=``, :mod:`repro_torch.core.mesh`; the engine's device is then the
mesh's first), or streamed from host RAM or from a store's memory-mapped
files. Mutations ride the store's delta shards and tombstones (+inf
norms), so they change no shape; a resident engine merges its delta shards
on the kernels of its backend (``knn_scan`` + ``knn_merge`` a shard on
``cuda``), a mesh engine on its first device.

    mesh = make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
    eng = ExactKNN(k=10, backend="cuda", mesh=mesh).fit(x)   # fdsq-sharded
"""
from __future__ import annotations

import math
import time
import warnings
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.api.types import AUTO_FDSQ_MAX_BATCH, SearchRequest, SearchResult
from repro_torch.core import partition as part
from repro_torch.core import sharded as sh
from repro_torch.core.distance import Metric, row_norms_sq, validate_metric
from repro_torch.core.executors import (
    ExecContext,
    MeshTiered,
    TieredResident,
    cached_direct_step,
    cached_partition_step,
    execute,
)
from repro_torch.core.mesh import Mesh
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
from repro_torch.runtime import tracing

#: the engine's defaults where the caller sets nothing and no tuned plan
#: says otherwise: the int8 rescore budget (× k) and the streamed depth
DEFAULT_RESCORE_FACTOR = 4
DEFAULT_PREFETCH_DEPTH = 2
#: plans :attr:`ExactKNN.plans` keeps (one a search; the oldest fall out)
PLANS_KEPT = 4096


def _deprecated_shim(old: str, new: str) -> None:
    warnings.warn(
        f"ExactKNN.{old} is deprecated; use ExactKNN.search("
        f"SearchRequest({new})) instead", DeprecationWarning, stacklevel=3)


def resolve_device(device) -> torch.device:
    """The device of the port's entry points (the engine, the LM): ``None``
    means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA device and none is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _keep_rows(mask: torch.Tensor, base_index: int, n_valid: int, n_pad: int) -> torch.Tensor:
    """Slice a global-id filter mask down to one padded row block: True =
    row eligible; padding rows stay True (their norms are +inf already).
    The one place the id-space -> row-block arithmetic lives."""
    keep = torch.ones(n_pad, dtype=torch.bool, device=mask.device)
    keep[:n_valid] = mask[base_index: base_index + n_valid]
    return keep


class _MaskedShardSource:
    """A DatasetStore view with a per-request filter mask folded onto each
    shard's validity channel as it streams (+inf norm on f32 shards, +inf
    quantised norm on int8 partitions): the store surface the streamed
    executors read (``read_shard`` / ``iter_shards`` / ``shard_source`` /
    ``delta_shards`` / ``gather_rows`` / ``n_shards``). The mask lives on
    the host beside the shards."""

    def __init__(self, store, mask: torch.Tensor):
        self._store = store
        self._mask = mask

    def _fold_f32(self, p: part.PaddedDataset) -> part.PaddedDataset:
        keep = _keep_rows(self._mask, p.base_index, p.n_valid, int(p.vectors.shape[0]))
        if bool(keep.all()):
            return p
        return p._replace(norms=torch.where(keep, p.norms, torch.inf))

    def _fold_int8(self, p):
        keep = _keep_rows(self._mask, p.base_index, p.n_valid, int(p.qnorm.shape[0]))
        if bool(keep.all()):
            return p
        return p._replace(qnorm=torch.where(keep, p.qnorm, torch.inf))

    def _fold(self, p):
        # quarantine can turn an int8 read into an f32 shard: fold by type
        return self._fold_f32(p) if isinstance(p, part.PaddedDataset) else self._fold_int8(p)

    def iter_shards(self, tier: str = "f32"):
        for p in self._store.iter_shards(tier):
            yield self._fold(p)

    def read_shard(self, i: int, tier: str = "f32"):
        return self._fold(self._store.read_shard(i, tier))

    def shard_source(self, tier: str = "f32"):
        return _MaskedTierSource(self, tier)

    def delta_shards(self):
        return [self._fold_f32(p) for p in self._store.delta_shards()]

    def gather_rows(self, ids):
        # candidates already passed the masked scan (excluded rows carry
        # +inf bounds and index -1), so no mask re-check is needed here
        return self._store.gather_rows(ids)

    @property
    def n_shards(self) -> int:
        return self._store.n_shards


class _MaskedTierSource:
    """Restartable iterable over one tier of a masked shard source."""

    def __init__(self, source: _MaskedShardSource, tier: str):
        self._source = source
        self._tier = tier

    def __iter__(self):
        return self._source.iter_shards(self._tier)


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
        mesh: Mesh | None = None,
        mesh_axes=("data", "model"),
        rescore_factor: int | None = None,
        device_budget_bytes: int | None = None,
        prefetch_depth: int | None = None,
        spec_trigger: float | None = None,
        max_retries: int | None = None,
        retry_backoff_s: float | None = None,
    ):
        validate_metric(metric)
        if k < 1:
            raise ValueError("k must be >= 1")
        if prefetch_depth is not None and prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {prefetch_depth}")
        if max_retries is not None and max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s is not None and retry_backoff_s < 0:
            raise ValueError(f"retry_backoff_s must be >= 0, got {retry_backoff_s}")
        if spec_trigger is not None and not (0.0 <= spec_trigger <= 1.0):
            raise ValueError(
                "spec_trigger must be a shard fraction in [0, 1] "
                f"(1 disables speculation), got {spec_trigger}")
        if rescore_factor is not None and rescore_factor < 1:
            raise ValueError(f"rescore_factor must be >= 1, got {rescore_factor}")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch.core.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            for ax in mesh_axes:
                if ax not in mesh.axis_names:
                    raise ValueError(f"mesh_axes {tuple(mesh_axes)} not in the mesh's "
                                     f"axes {mesh.axis_names}")
            if device is not None and torch.device(device) != mesh.first:
                raise ValueError(f"device={device!r} but the mesh's first device is "
                                 f"{mesh.first}")
            device = mesh.first
        self.device = resolve_device(device)
        #: the device mesh the resident rows shard over (None: one device)
        self.mesh = mesh
        self.mesh_axes = tuple(mesh_axes)
        self.k = int(k)
        self.metric = metric
        self.backend: Backend = backend
        self.chunk_rows = int(chunk_rows)
        self.n_partitions = int(n_partitions)
        self.dtype = dtype
        #: int8 rescore budget: r = next_pow2(rescore_factor·next_pow2(k))
        #: resident, r = rescore_factor·k streamed (the reference's budgets).
        #: None = the default, which a tuned streamed plan may override; an
        #: explicit value is pinned: tuning never overrides a caller's budget
        self.rescore_factor = (DEFAULT_RESCORE_FACTOR if rescore_factor is None
                               else int(rescore_factor))
        self._rescore_pinned = rescore_factor is not None
        #: fit_store(store) keeps a store resident when its f32 bytes fit
        #: this budget (None = unlimited)
        self.device_budget_bytes = device_budget_bytes
        #: streamed-scan double-buffer depth (2 = the paper's two memory
        #: banks: one shard in flight); a request's own value wins. None =
        #: the default, overridable by a tuned plan; explicit = pinned
        self.prefetch_depth = (DEFAULT_PREFETCH_DEPTH if prefetch_depth is None
                               else int(prefetch_depth))
        self._prefetch_pinned = prefetch_depth is not None
        #: streamed-int8 speculation trigger (shard fraction after which the
        #: candidate gather starts on a background thread; 1.0 = none);
        #: None = the tuned plan's value, else the executor default
        self.spec_trigger = spec_trigger
        #: bounded retry budget for streamed shard reads, candidate gathers
        #: and transfers (exponential backoff from retry_backoff_s)
        self.max_retries = 2 if max_retries is None else int(max_retries)
        self.retry_backoff_s = 0.05 if retry_backoff_s is None else float(retry_backoff_s)
        self._store = None
        self._resident = True
        # cos + fused backend on one device: the resident view is normalised
        # at fit time, so the kernel skips its own dataset pass per query
        # batch (a mesh's blocks score raw rows, as the reference's do)
        self._cos_prenormalized = metric == "cos" and backend == "cuda" and mesh is None
        self._ds: part.PaddedDataset | None = None  # device f32 view
        self._int8: QuantizedDataset | None = None  # device int8 view
        self._delta_dev: list[part.PaddedDataset] = []  # device delta shards
        self._seen_mutations = 0
        self._seen_generation = 0  # store generation the device views mirror
        self._plans: deque[ExecutionPlan] = deque(maxlen=PLANS_KEPT)
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

    def fit_store(self, store, resident: bool | None = None) -> "ExactKNN":
        """Attach a DatasetStore. Residency: the explicit `resident` flag,
        else the store's f32 bytes against ``device_budget_bytes`` (None =
        unlimited). A resident store's rows go to the engine's device (a
        store in files is read once for that); a non-resident one stays in
        host memory or in its files and every search streams its shards
        (fqsd-mmap-streamed / fqsd-int8-streamed / fqsd-int8-mmap-streamed).
        On a CUDA device a host-RAM store's shards are pinned here, once (a
        store that cannot be pinned raises): the double buffer overlaps
        copies only from pinned memory. A store in files is never pinned
        (that would read every file into page-locked RAM): the double
        buffer stages its mapped shards through page-locked banks of its
        own. A resident engine on a store with the int8 tier (l2) puts the
        tier on its device too, and every resident engine puts the store's
        delta shards there.
        """
        if resident is None:
            budget = self.device_budget_bytes
            resident = budget is None or store.nbytes("f32") <= budget
        self._store = store
        self._resident = bool(resident)
        self._ds = None
        self._int8 = None
        self._delta_dev = []
        self._seen_generation = store.generation
        self._seen_mutations = store.mutation_count
        if self._resident:
            host = store.resident()
            self._attach(host.vectors, host.norms, host.n_valid, prenormalized=False)
            if store.has_tier("int8") and self.metric == "l2":
                self._put_int8()
        elif self.device.type == "cuda" and not store.is_mmap:
            store.pin()
        self._put_delta_shards()
        return self

    def _attach(self, vectors: torch.Tensor, norms: torch.Tensor, n_valid: int,
                prenormalized: bool) -> None:
        """Make (vectors, norms) the resident view: on the engine's device,
        or row-sharded over the mesh (each block straight to its device).
        Rows are normalised here for cos on the fused backend unless
        `prenormalized` says they are."""
        if self.mesh is not None:
            vec, nrm = sh.shard_dataset(self.mesh, vectors.to(dtype=self.dtype), norms,
                                        self.mesh_axes)
            self._ds = part.PaddedDataset(vec, nrm, int(n_valid), 0)
            return
        vec = vectors.to(device=self.device, dtype=self.dtype)
        if self._cos_prenormalized and not prenormalized:
            # cos is scale-invariant; the norms channel keeps the RAW norms
            # (it is the validity mask: +inf = padding)
            vec = _normalize_rows(vec, self.dtype)
        self._ds = part.PaddedDataset(vec, norms.to(self.device), int(n_valid), 0)

    def _row_mult(self) -> int:
        """Row alignment: rows must split evenly over the partitions, and
        over the mesh's blocks."""
        mult = part.LANE * self.n_partitions
        if self.mesh is not None:
            mult = max(mult, part.LANE * math.prod(self.mesh.shape[ax]
                                                   for ax in self.mesh_axes))
        return mult

    def _put_rows(self, t: torch.Tensor):
        """A per-row channel (norms, a filter mask, an int8 channel) where
        the resident view lives: row-sharded like it over the mesh, else on
        the engine's device. A mutation re-puts only such channels."""
        if self.mesh is not None:
            return sh.shard_rows(self.mesh, t, self.mesh_axes)
        return t.to(self.device)

    @property
    def store(self):
        """The attached DatasetStore (None before fit)."""
        return self._store

    @property
    def is_fitted(self) -> bool:
        return self._store is not None or self._ds is not None

    @property
    def n(self) -> int:
        self._require_fit()
        return self._store.n_live if self._store is not None else self._ds.n_valid

    def _require_fit(self):
        if not self.is_fitted:
            raise RuntimeError("call .fit(dataset) first")

    def _require_store(self, what: str):
        """A store is attached (every fit; not a view carried in by
        ``convert.engine_state_from_jax``)."""
        self._require_fit()
        if self._store is None:
            raise RuntimeError(f"{what} requires a DatasetStore-backed fit")

    def _padded_dim(self) -> int:
        return (int(self._ds.vectors.shape[1]) if self._ds is not None
                else self._store.padded_dim)

    def _pad_queries(self, q) -> torch.Tensor:
        q = torch.as_tensor(q).to(device=self.device, dtype=self.dtype)
        if q.ndim == 1:
            q = q[None, :]
        return part.pad_dim(q, self._padded_dim())

    # ----------------------------------------------------------- mutation
    def upsert(self, vectors) -> np.ndarray:
        """Append rows under live traffic; returns their external ids. The
        rows land in the store's fixed-geometry delta shards, so the next
        search sees them exactly and no shape changes."""
        self._require_store("mutations")
        ids = self._store.upsert(vectors)
        self._sync_mutations()
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows by external id; searches exclude them at once. A
        tombstone is a +inf norm: data, not a shape."""
        self._require_store("mutations")
        self._store.delete(ids)
        self._sync_mutations()

    def _sync_mutations(self) -> None:
        """Bring the device views up to the store. A moved generation (a
        compaction folded the delta into new shards) is a full re-put through
        :meth:`fit_store`: geometry is kept across generations, so nothing
        new is built. Otherwise, after mutations, the norms (tombstones)
        are refreshed in place, with the same shape, and the delta shards
        re-put; the resident vectors are untouched."""
        if self._store is None:
            return
        if self._store.generation != self._seen_generation:
            self.fit_store(self._store, resident=self._resident)
            return
        if self._store.mutation_count == self._seen_mutations:
            return
        self._seen_mutations = self._store.mutation_count
        if self._resident:
            self._ds = self._ds._replace(norms=self._put_rows(self._store.resident_norms()))
            if self._int8 is not None:
                # only the validity channel moves on a mutation; the codes,
                # scales and errors went to the device once
                self._int8 = self._int8._replace(
                    norms_sq=self._put_rows(self._store.int8_resident_norms()))
        self._put_delta_shards()

    def _put_delta_shards(self) -> None:
        """The store's delta shards on the device, for a resident engine
        (a streamed search reads them from the store with its shards). A
        full shard's rows never change: its device vectors are reused and
        only its norms (tombstones) put again. Rows are cast to the view's
        dtype, and L2-normalised for cos on the fused backend as the
        resident rows were at fit."""
        if not self._resident:
            self._delta_dev = []
            return
        prev, fresh = self._delta_dev, []
        for i, p in enumerate(self._store.delta_shards()):
            rows = int(p.vectors.shape[0])
            if i < len(prev) and prev[i].n_valid == rows == p.n_valid:
                vec = prev[i].vectors
            else:
                vec = p.vectors.to(device=self.device, dtype=self.dtype)
                if self._cos_prenormalized:
                    vec = _normalize_rows(vec, self.dtype)
            fresh.append(part.PaddedDataset(vec, p.norms.to(self.device), p.n_valid,
                                            p.base_index))
        self._delta_dev = fresh

    def _masked_delta(self, mask: torch.Tensor | None) -> tuple[part.PaddedDataset, ...]:
        """The device delta shards under a filter mask (+inf norm =
        excluded), as :meth:`_masked_resident` folds it on the main view."""
        if mask is None:
            return tuple(self._delta_dev)
        return tuple(p._replace(norms=torch.where(
            _keep_rows(mask, p.base_index, p.n_valid, int(p.vectors.shape[0])),
            p.norms, torch.inf)) for p in self._delta_dev)

    def _merge_delta(self, out: TopK, queries: torch.Tensor, k: int, metric: str,
                     tier: str, deltas: tuple[part.PaddedDataset, ...]) -> TopK:
        """Fold the device delta shards into a resident result whose
        executor left them out, exactly (fdsq-cuda merges them itself, one
        ``knn_scan`` + ``knn_merge`` a shard into its kernel queue).

        * an int8 result merges them through the direct-form step, the form
          of every int8 answer (``knn_exact_direct``'s bits);
        * a plain f32 result steps the (m, k) result through the cached
          partition step on ``torch``, as the reference does."""
        if tier == "int8":
            step = cached_direct_step(k)
            s, i = out.scores, out.indices
            for p in deltas:
                s, i = step(s, i, queries, p.vectors, p.norms, p.base_index)
            return TopK(s, torch.where(torch.isfinite(s), i, -1))
        step = cached_partition_step(k, metric, "torch")
        for p in deltas:
            out = step(out, queries, p.vectors, p.norms, p.base_index, p.n_valid)
        return out

    # ---------------------------------------------------------- int8 tier
    def enable_int8(self) -> "ExactKNN":
        """Materialise the store's int8 tier (the 1 B/element scan tier). A
        resident engine puts it on its device beside the f32 view; a
        non-resident one streams the per-shard codes through the
        fqsd-int8-streamed executor (quantised on the engine's device, kept
        in host memory beside the f32 shards)."""
        self._require_store("int8 tier")
        if self.metric != "l2":
            raise ValueError("int8 tier supports the l2 metric only")
        if not self._resident:
            self._store.ensure_tier("int8", device=self.device)
            return self
        self._store.ensure_tier("int8")
        self._put_int8()
        return self

    def _put_int8(self) -> None:
        """The int8 view: every channel on the engine's device, or
        row-sharded over the mesh (the f32 tier stays off the mesh's int8
        path: only candidate rows of it are gathered)."""
        self._int8 = QuantizedDataset(*(self._put_rows(t) for t in self._store.int8_resident()))

    @property
    def has_int8(self) -> bool:
        """The engine can serve tier="int8": a device int8 view exists, or
        (out of core) the attached store has the tier for the streamed
        scan."""
        if self._store is not None and not self._resident:
            return self._store.has_tier("int8")
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
            sharded=self.mesh is not None, mesh_axes=self.mesh_axes,
            rescore_factor=self.rescore_factor,
            dtype=str(self.dtype).removeprefix("torch."),
            rescore_pinned=self._rescore_pinned,
        )

    def dataset_meta(self, tier: str = "f32") -> DatasetMeta:
        """Planner-visible storage facts."""
        self._require_fit()
        sharded = self.mesh is not None
        if self._store is not None:
            return self._store.meta(device_resident=self._resident, tier=tier, sharded=sharded)
        rows = int(self._ds.vectors.shape[0])
        return DatasetStoreMeta(padded_rows=rows, padded_dim=self._padded_dim(),
                                n_valid=int(self._ds.n_valid), sharded=sharded, tier=tier,
                                rows_per_shard=rows)

    def plan_for(self, mode: str, m: int = 1, tier: str = "f32", **kw) -> ExecutionPlan:
        """Plan without executing — what `mode` with an m-row batch would run."""
        self._require_fit()
        return plan_fn((m, self._padded_dim()), self.dataset_meta(tier=tier),
                       self.config(), mode, **kw)

    def _run(self, p: ExecutionPlan, queries: torch.Tensor, dataset,
             prefetch_depth: int | None = None, spec_trigger: float | None = None,
             max_retries: int | None = None, allow_partial: bool = False,
             delta: tuple[part.PaddedDataset, ...] = ()) -> TopK:
        self._plans.append(p)
        ctx = ExecContext(
            mesh=self.mesh, mesh_axes=self.mesh_axes,
            cos_prenormalized=self._cos_prenormalized,
            prefetch_depth=self.prefetch_depth if prefetch_depth is None else prefetch_depth,
            spec_trigger=spec_trigger,
            max_retries=self.max_retries if max_retries is None else int(max_retries),
            retry_backoff_s=self.retry_backoff_s, allow_partial=bool(allow_partial),
            delta=delta)
        self._last_ctx = ctx
        with tracing.span("executor.launch"):
            return execute(p, queries, dataset, ctx)

    @property
    def plans(self) -> list[ExecutionPlan]:
        """The last ``PLANS_KEPT`` plans executed, in order (observability /
        tests)."""
        return list(self._plans)

    # ------------------------------------------------------------ request API
    @property
    def n_ids(self) -> int:
        """Size of the external row-id space (every id ever allocated,
        deleted and compacted-away ids included: ids are never reused);
        ``SearchRequest.filter_mask`` must have exactly this length."""
        self._require_fit()
        return self._store.n_ids if self._store is not None else int(self._ds.n_valid)

    def _masked_resident(self, mask: torch.Tensor | None) -> part.PaddedDataset:
        """Resident view with a filter mask folded onto the norms channel
        (+inf = excluded: runtime data, shapes unchanged)."""
        ds = self._ds
        if mask is None:
            return ds
        keep = _keep_rows(mask, 0, ds.n_valid, int(ds.vectors.shape[0]))
        return ds._replace(norms=self._masked(ds.norms, keep))

    def _masked(self, norms, keep: torch.Tensor):
        """`norms` with +inf where `keep` is False (block by block on a
        mesh, each block's slice of the mask shipped to its device)."""
        if self.mesh is None:
            return torch.where(keep, norms, torch.inf)
        return sh.map_blocks(lambda n, kb: torch.where(kb, n, torch.inf), norms,
                             sh.shard_rows(norms.mesh, keep, norms.axes))

    def _masked_int8(self, mask: torch.Tensor | None) -> QuantizedDataset:
        """Int8 view under the same mask: norms_sq is the int8 executors'
        validity channel, exactly as the f32 norms are."""
        q8 = self._int8
        if mask is None:
            return q8
        keep = _keep_rows(mask, 0, self._ds.n_valid, int(q8.norms_sq.shape[0]))
        return q8._replace(norms_sq=self._masked(q8.norms_sq, keep))

    def search(self, request: SearchRequest) -> SearchResult:
        """Serve one :class:`SearchRequest` — the single entry point.

        Normalises the per-request options (k, metric, mode, filter mask,
        deadline) and routes through ``planner.plan``. mode_hint="auto"
        takes the FD-SQ plan for micro-batches (<= AUTO_FDSQ_MAX_BATCH
        rows) and the FQ-SD plan beyond.
        """
        with tracing.span("engine.search"):
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
            self._sync_mutations()
            if not hasattr(self._store, "snapshot"):
                # no store (a resident view carried in by engine_state_from_jax)
                # or a store wrapper without generations: nothing to pin
                return self._search_pinned(request, k, metric, tier, None)
            # pin the generation this search reads: a concurrent compaction may
            # swap the store's live generation, and the pin keeps the pinned
            # shards (and the id tables that read their positions) alive until
            # the search ends. Re-sync until the pinned generation is the one
            # the device views mirror.
            view = self._store.snapshot()
            while view.generation != self._seen_generation:
                view.release()
                self._sync_mutations()
                view = self._store.snapshot()
            try:
                return self._search_pinned(request, k, metric, tier, view)
            finally:
                view.release()

    def _search_pinned(self, request: SearchRequest, k: int, metric: str,
                       tier: str, view) -> SearchResult:
        """The body of :meth:`search`, with `view` pinning the generation the
        device views mirror: the resident view plus its delta shards, or the
        streamed shards of a non-resident store. A filter mask comes in
        external ids and is translated to the generation's positions here;
        result indices go back to external ids at the end."""
        qv = self._pad_queries(request.queries)
        m = int(qv.shape[0])
        mode = request.mode_hint
        if tier == "int8":
            mode = "fqsd"  # the int8 tier is an FQ-SD tier whatever the batch
        elif mode == "auto":
            mode = "fdsq" if m <= AUTO_FDSQ_MAX_BATCH else "fqsd"
        mask = request.filter_mask
        if mask is not None:
            mask = torch.as_tensor(mask).to(dtype=torch.bool).reshape(-1)
            if mask.shape[0] != self.n_ids:
                raise ValueError(
                    "filter_mask must cover the engine's global id space "
                    f"({self.n_ids} rows), got {mask.shape[0]}")
            if view is not None:
                mask = torch.from_numpy(view.positional_mask(mask.cpu().numpy()))
            # streamed shards live on the host: so does their mask
            mask = mask.to(self.device if self._resident else "cpu")
        t0 = time.perf_counter()
        meta = (view.meta(device_resident=self._resident, tier=tier,
                          sharded=self.mesh is not None)
                if view is not None else self.dataset_meta(tier=tier))
        if not self._resident:
            # tier="int8" survives planning here: the out-of-core scan
            # streams 1 B/element codes and rescores candidate rows only.
            # Every read goes through the pinned view when there is one, so a
            # generation swap mid-search cannot mix shards of two epochs
            src = view if view is not None else self._store
            p = plan_fn(qv.shape, meta, self.config(), "fqsd-streamed",
                        stream_rows=src.rows_per_shard, k=k, metric=metric)
            source = src if mask is None else _MaskedShardSource(src, mask)
            # pipeline-knob precedence: request pin > engine pin > tuned plan
            # > engine default (the executor resolves a None trigger against
            # plan.spec_trigger, then DEFAULT_SPEC_TRIGGER)
            if request.prefetch_depth is not None:
                prefetch = int(request.prefetch_depth)
            elif self._prefetch_pinned or p.prefetch_depth <= 0:
                prefetch = self.prefetch_depth
            else:
                prefetch = int(p.prefetch_depth)
            out = self._run(
                p, qv, source, prefetch_depth=prefetch,
                spec_trigger=(request.spec_trigger if request.spec_trigger is not None
                              else self.spec_trigger),
                max_retries=request.max_retries, allow_partial=request.allow_partial)
        else:
            p = plan_fn((m, self._padded_dim()), meta, self.config(), mode, k=k, metric=metric)
            if p.executor == "fdsq-sharded-int8":
                # the sharded int8 view and the backing store for the
                # candidate-only rescore (under the request's mask, so the
                # gather, delta merge and fallback see the same exclusions)
                src = view if view is not None else self._store
                dataset = MeshTiered(self._masked_int8(mask),
                                     src if mask is None else _MaskedShardSource(
                                         src, mask.to("cpu")))
            elif p.tier == "int8":
                dataset = TieredResident(self._masked_resident(mask), self._masked_int8(mask))
            else:
                dataset = self._masked_resident(mask)
            deltas = self._masked_delta(mask)
            out = self._run(p, qv, dataset, max_retries=request.max_retries,
                            allow_partial=request.allow_partial, delta=deltas)
            if deltas and not self._last_ctx.delta_folded:
                out = self._merge_delta(out, qv, k, metric, p.tier, deltas)
        if view is not None and not view.identity:
            # positions within a compacted generation are internal: the
            # caller gets the stable external ids back (a relabelling of the
            # indices; scores and order are untouched)
            ext = view.external_ids(out.indices.cpu().numpy())
            out = TopK(out.scores, torch.from_numpy(ext).to(out.indices.device,
                                                            out.indices.dtype))
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        ctx = self._last_ctx
        elem = 4 if self._ds is None else self._ds.vectors.element_size()
        stats = {
            "k": k, "metric": metric, "m": m, "batched": m,
            # streamed int8 reports its own traffic (codes + side channels +
            # candidate-row reads); plans predict the rest
            "bytes_scanned": (ctx.bytes_scanned if ctx.bytes_scanned is not None
                              else p.padded_rows * p.padded_dim
                              * (1 if p.tier == "int8" else elem)),
            "dispatch_ms": dispatch_ms,
        }
        if ctx.stream_stats is not None:
            stats["transfers"] = ctx.stream_stats.get("transfers", 0)
            stats["restarts"] = ctx.stream_stats.get("restarts", 0)
        if ctx.device_bytes is not None:
            # the mesh int8 executors: scan bytes split by device (the total,
            # with the gather, delta and fallback traffic, is bytes_scanned)
            stats["bytes_per_device"] = list(ctx.device_bytes)
        if ctx.phase_ms is not None:
            stats.update(ctx.phase_ms)
        if ctx.speculation is not None:
            stats["speculation"] = dict(ctx.speculation)
        # health is always present; shard lists are dedup'd and sorted
        h = ctx.health or {}
        stats["health"] = {
            "retries": int(h.get("retries", 0)),
            "failed_shards": sorted(set(h.get("failed_shards", ()))),
            "degraded": sorted(set(h.get("degraded", ()))),
            "slow_shards": sorted(set(h.get("slow_shards", ()))),
            "shed": False,
        }
        # partial is loud: only an allow_partial=True request can see it
        stats["partial"] = bool(stats["health"]["failed_shards"])
        if request.deadline_ms is not None:
            stats["deadline_ms"] = request.deadline_ms
        return SearchResult(topk=out, plan=p, tier=p.tier,
                            certified=True if ctx.certificate is None else ctx.certificate,
                            kernel_stats=ctx.kernel_stats, stats=stats,
                            rid=request.rid)

    # ------------------------------------------- deprecated query_* shims
    def query(self, q) -> TopK:
        """Deprecated low-latency path; delegates to :meth:`search`."""
        _deprecated_shim("query(q)", "queries=q, mode_hint='fdsq'")
        return self.search(SearchRequest(queries=q, mode_hint="fdsq")).topk

    def query_stream(self, queries_iter: Iterable) -> Iterator[TopK]:
        """Deprecated streamed-queries path; delegates to :meth:`search`,
        yielding one (k,) TopK per query."""
        _deprecated_shim("query_stream(qs)", "queries=q, mode_hint='fdsq'")
        for q in queries_iter:
            out = self.search(SearchRequest(queries=q, mode_hint="fdsq")).topk
            yield TopK(out.scores[0], out.indices[0])

    def query_batch(self, queries) -> TopK:
        """Deprecated throughput path; delegates to :meth:`search`."""
        _deprecated_shim("query_batch(Q)", "queries=Q, mode_hint='fqsd'")
        return self.search(SearchRequest(queries=queries, mode_hint="fqsd")).topk

    def query_batch_int8(self, queries) -> TopK:
        """Deprecated int8-tier path; delegates to :meth:`search`."""
        _deprecated_shim("query_batch_int8(Q)", "queries=Q, tier='int8'")
        return self.search(SearchRequest(queries=queries, tier="int8",
                                         mode_hint="fqsd")).topk

    def search_streamed(self, queries, host_vectors, rows_per_partition: int = 65536,
                        prefetch_depth: int = 2) -> TopK:
        """FQ-SD over host vectors too large for the device (fig. 1), through
        the fqsd-streamed executor over :func:`partition.iter_partitions`.

        Deprecated: attach a non-resident store instead —
        ``fit_store(DatasetStore.from_array(x, rows_per_shard=...),
        resident=False)`` then ``search(SearchRequest(queries=Q))``.
        """
        warnings.warn(
            "ExactKNN.search_streamed() is deprecated; attach a non-resident "
            "DatasetStore (fit_store(..., resident=False)) and call "
            "search(SearchRequest(queries=Q))", DeprecationWarning, stacklevel=2)
        q = torch.as_tensor(queries).to(device=self.device, dtype=self.dtype)
        if q.ndim == 1:
            q = q[None, :]
        d_pad = part.round_up(host_vectors.shape[1], part.LANE)
        q = part.pad_dim(q, d_pad)
        rows = part.round_up(rows_per_partition, part.LANE)
        meta = DatasetMeta(padded_rows=int(host_vectors.shape[0]), padded_dim=d_pad,
                           n_valid=int(host_vectors.shape[0]), resident=False)
        p = plan_fn(q.shape, meta, self.config(), "fqsd-streamed", stream_rows=rows)
        return self._run(p, q, part.iter_partitions(host_vectors, rows),
                         prefetch_depth=prefetch_depth)


__all__ = ["ExactKNN", "ExecutionPlan", "SearchRequest", "SearchResult",
           "resolve_device"]
