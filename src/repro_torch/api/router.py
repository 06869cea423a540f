"""Multi-collection Router — named DatasetStore-backed engines, one cache.

A retrieval service rarely serves one corpus: the Router maps a collection
name to an :class:`~repro_torch.core.engine.ExactKNN` engine (each backed by
its own :class:`~repro_torch.store.DatasetStore`) and routes
:class:`~repro_torch.api.types.SearchRequest` traffic by name. All
collections share the process-wide bounded executable cache
(``repro_torch.core.executors``): plans are keyed by shapes and options,
not by collection, so two collections of the same geometry reuse each
other's entries, and mode switches and store mutations across collections
add none for shapes already seen.

Per-collection stats (requests, queries, bytes scanned per tier) make the
multi-tenant traffic visible; :meth:`cache_info` exposes the shared cache.

Core imports are lazy: ``repro_torch.api`` must be importable from
``repro_torch.core.engine`` (which imports the request/result types)
without a cycle.
"""
from __future__ import annotations

from typing import Iterator

from repro_torch.api.types import SearchRequest, SearchResult

#: one Mesh per device group, so collections placed on the same group share
#: executable-cache keys (plan.cache_key(), mesh, axes)
_MESH_BY_GROUP: dict = {}


class Router:
    """Route search traffic across named collections.

    Usage:
        router = Router()
        router.create("passages", corpus, k=10, metric="ip", backend="cuda")
        router.attach("images", prebuilt_engine)
        res = router.search("passages", SearchRequest(queries=q, k=5))
        router.stats()        # per-collection traffic + shared cache info

    ``executable_cache_entries`` bounds the shared executable LRU (None
    keeps the current process-wide limit).
    """

    def __init__(self, executable_cache_entries: int | None = None):
        if executable_cache_entries is not None:
            from repro_torch.core.executors import set_executable_cache_limit

            set_executable_cache_limit(executable_cache_entries)
        self._engines: dict[str, object] = {}
        self._stats: dict[str, dict] = {}

    # ----------------------------------------------------------- collections
    def create(self, name: str, vectors=None, *, store=None, devices=None,
               **engine_kwargs):
        """Build and attach a DatasetStore-backed engine for `name`.

        Pass either raw ``vectors`` (an (N, d) numpy array or tensor, handed
        to ``ExactKNN.fit`` as it is: a tensor already on the engine's device
        is padded there, with no host copy) or a prebuilt ``store``.
        Remaining kwargs go to the ``ExactKNN`` constructor (k, metric,
        backend, device, device_budget_bytes, ...).

        ``devices`` places the collection's rows across a device group: a
        count (the first N CUDA devices) or a sequence of ``torch.device`` or
        device strings, which may repeat a device (logical devices: each
        position holds its own block). The Router builds a one-axis
        ``("data",)`` mesh over them and hands it to the engine, so resident
        tiers shard row-wise across the group and the int8 tier of a store
        kept off the devices ring-streams over it; the process-wide
        executable cache stays shared: collections placed on the same group
        reuse each other's entries (same ``(cache_key, mesh, axes)``).
        """
        from repro_torch.core.engine import ExactKNN

        self._check_name(name)  # fail before any fitting or device work
        if (vectors is None) == (store is None):
            raise ValueError("pass exactly one of `vectors` or `store`")
        if devices is not None:
            if "mesh" in engine_kwargs:
                raise ValueError("pass either `devices` or `mesh`, not both")
            engine_kwargs = dict(engine_kwargs, mesh=self._make_mesh(devices),
                                 mesh_axes=("data",))
        engine = ExactKNN(**engine_kwargs)
        if store is not None:
            engine.fit_store(store)
        else:
            engine.fit(vectors)
        return self.attach(name, engine)

    @staticmethod
    def _make_mesh(devices):
        """A one-axis ``("data",)`` mesh over a device group: a count (the
        first N CUDA devices; raises where there are fewer) or a sequence of
        devices, repeats allowed. The same group always gives the identical
        Mesh object."""
        import torch

        from repro_torch.core.mesh import make_mesh

        if isinstance(devices, int):
            avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if not 1 <= devices <= avail:
                raise ValueError(f"devices={devices} but {avail} CUDA device(s) present")
            devices = [torch.device("cuda", i) for i in range(devices)]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("`devices` must name at least one device")
        group = tuple(str(d) for d in devices)
        if group not in _MESH_BY_GROUP:
            _MESH_BY_GROUP[group] = make_mesh((len(devices),), ("data",), devices=devices)
        return _MESH_BY_GROUP[group]

    def _check_name(self, name: str) -> None:
        if not isinstance(name, str) or not name:
            raise ValueError(f"collection name must be a non-empty str, got {name!r}")
        if name in self._engines:
            raise ValueError(f"collection {name!r} already exists")

    def attach(self, name: str, engine):
        """Attach an already-fitted engine under `name`."""
        self._check_name(name)
        if not engine.is_fitted:
            raise ValueError(f"engine for collection {name!r} must be fitted")
        mesh = getattr(engine, "mesh", None)
        self._engines[name] = engine
        self._stats[name] = {
            "requests": 0,
            "queries": 0,
            "bytes_scanned": {"f32": 0, "int8": 0},
            "tiers": set(),
            "devices": [str(d) for d in mesh.devices.flat] if mesh is not None else None,
        }
        return engine

    def drop(self, name: str) -> None:
        """Detach a collection (cached executables stay: they are keyed by
        shapes, and another collection may share them)."""
        self.engine(name)  # the uniform KeyError on unknown names
        del self._engines[name]
        del self._stats[name]

    def engine(self, name: str):
        """The engine behind `name` (for fitting-time ops: enable_int8...)."""
        try:
            return self._engines[name]
        except KeyError:
            raise KeyError(
                f"unknown collection {name!r}; known: {self.collections()}"
            ) from None

    def collections(self) -> tuple:
        return tuple(sorted(self._engines))

    def __contains__(self, name: str) -> bool:
        return name in self._engines

    def __len__(self) -> int:
        return len(self._engines)

    def __iter__(self) -> Iterator[str]:
        return iter(self.collections())

    # ------------------------------------------------------------- traffic
    def search(self, collection: str, request: SearchRequest) -> SearchResult:
        """Serve one request against the named collection."""
        result = self.engine(collection).search(request)
        s = self._stats[collection]
        s["requests"] += 1
        s["queries"] += int(result.stats.get("m", 1))
        s["bytes_scanned"][result.tier] = (
            s["bytes_scanned"].get(result.tier, 0)
            + int(result.stats.get("bytes_scanned", 0)))
        s["tiers"].add(result.tier)
        return result

    def upsert(self, collection: str, vectors):
        """Append rows to the named collection (visible to the next
        request; adds no executable for shapes already seen)."""
        return self.engine(collection).upsert(vectors)

    def delete(self, collection: str, ids) -> None:
        """Tombstone rows of the named collection by external id."""
        self.engine(collection).delete(ids)

    # ----------------------------------------------------------- compaction
    def compact(self, collection: str, wait: bool = False) -> dict:
        """Fold the named collection's delta rows and tombstones into a
        new store generation (atomic swap; searches never block, see
        ``DatasetStore.compact``). ``wait=False`` starts the store's
        background compactor and returns at once; ``wait=True`` runs it
        here. Returns the collection's compaction status after the start."""
        store = self._compactable_store(collection)
        if wait:
            store.compact()
        else:
            store.compact_async()
        return self.compaction_status(collection)

    def compaction_status(self, collection: str) -> dict:
        """Live compaction and generation state of the named collection."""
        return self._compactable_store(collection).compaction_status()

    def _compactable_store(self, collection: str):
        store = getattr(self.engine(collection), "store", None)
        if store is None or not hasattr(store, "compact"):
            raise ValueError(
                f"collection {collection!r} is not backed by a compactable "
                f"DatasetStore")
        return store

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Per-collection traffic + the shared executable cache counters.
        ``queries`` counts engine rows per dispatch: a batch the scheduler
        padded to a power of two counts its padded size."""
        out = {}
        for name in self.collections():
            s = self._stats[name]
            store = getattr(self._engines[name], "store", None)
            out[name] = {
                "requests": s["requests"],
                "queries": s["queries"],
                "bytes_scanned": dict(s["bytes_scanned"]),
                "tiers": sorted(s["tiers"]),
                "n_rows": int(self._engines[name].n),
                "devices": s["devices"],
                "compaction": (store.compaction_status()
                               if hasattr(store, "compaction_status") else None),
            }
        return {"collections": out, "executable_cache": self.cache_info()}

    def cache_info(self) -> dict:
        """The shared executable cache (hits/misses/evictions/size)."""
        from repro_torch.core.executors import cache_info

        return cache_info()


__all__ = ["Router"]
