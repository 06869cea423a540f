"""Host->device double-buffered dataset streaming (paper section 3.3).

The paper keeps the PCIe link busy by writing partition i+1 into one FPGA
memory bank while the FPGA computes on partition i from the other. On the
card the two banks are literal: :class:`DoubleBufferedStream` allocates
``depth`` device slots per partition layout (one tensor per array field:
vectors + norms for an f32 shard; codes + scales + err + qnorm for an
:class:`~repro_torch.core.quantized.Int8Partition`) and cycles through
them. For each slot:

1. the copy of stream position i goes into slot ``i % depth`` on a
   dedicated copy stream, after waiting on that slot's "consumer done"
   event (so it never overwrites a shard the scan still reads);
2. "copy done" is recorded on the copy stream;
3. the compute stream waits on "copy done" before the consumer's step;
4. "consumer done" is recorded after the step.

``depth=2`` keeps one partition in flight while the consumer computes on
the other (two banks); ``depth=1`` copies and computes in turn. The slots
belong to the stream for its lifetime, so the caching allocator never hands
one back while a copy into it is pending.

A copy overlaps compute only from page-locked host memory: from pageable
memory it is synchronous. A pinned store's shards go to their slot
directly. Pageable fields (a memory-mapped shard of a store in files, a
store that was never pinned) are staged: the stream owns ``depth``
page-locked host banks beside its device slots, fills bank ``i % depth``
from the source on a pool of host threads, then copies the bank to the
slot asynchronously. A bank is refilled only after the copy out of it has
completed ("copy done" of the same slot). A mapping is never pinned.

On the CPU (``device="cpu"``) a partition is handed over as it is: the
structure (order, transfer counts, retries, restarts, fault hooks) is the
same.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def _fresh_health() -> dict:
    """One search's resilience accounting (the engine surfaces it as
    ``stats["health"]``): failed attempts retried, shards quarantined to
    the f32 tier, shards skipped under ``allow_partial``, straggler reads.
    """
    return {"retries": 0, "degraded": [], "failed_shards": [],
            "slow_shards": []}


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _as_tensor(v) -> torch.Tensor:
    """A tensor as it is; a numpy array shared, or copied when it is
    read-only (a mapping): a tensor over a read-only mapping would fault on
    any write."""
    if not isinstance(v, np.ndarray):
        return v
    return torch.from_numpy(np.ascontiguousarray(v) if v.flags.writeable else np.array(v))


def _array_fields(p) -> dict:
    """The array fields of a NamedTuple partition, by name (host scalars
    such as n_valid and base_index are left out)."""
    return {name: v for name, v in zip(type(p)._fields, p) if _is_array(v)}


def _on_device_put(p) -> None:
    """The process-wide fault injector's hook, once per partition transfer."""
    from repro_torch import faults

    inj = faults.active()
    if inj is not None:
        inj.on_device_put(getattr(p, "base_index", -1))


def _move(p, dev: torch.device, non_blocking: bool = False, copy: bool = False):
    """Every array field of a partition record on `dev` (a bare array moved
    as it is), host scalars untouched; ``copy=True`` gives memory of its
    own even where a field already lives on `dev`."""
    if not isinstance(p, tuple) or not hasattr(p, "_fields"):
        return (_as_tensor(p).to(dev, non_blocking=non_blocking, copy=copy) if _is_array(p)
                else p)
    arrays = _array_fields(p)
    if not arrays:
        return p
    return p._replace(**{name: _as_tensor(v).to(dev, non_blocking=non_blocking, copy=copy)
                         for name, v in arrays.items()})


def _tensors(p) -> list:
    """The tensors of a partition record (or the bare tensor)."""
    if isinstance(p, tuple) and hasattr(p, "_fields"):
        return [v for v in _array_fields(p).values() if isinstance(v, torch.Tensor)]
    return [p] if isinstance(p, torch.Tensor) else []


_COPY_STREAMS: dict = {}
_COPY_STREAMS_LOCK = threading.Lock()


def _cuda_device(dev) -> torch.device:
    """`dev` with its index (a bare "cuda" is the current device)."""
    dev = torch.device(dev)
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


class CopyStreams:
    """The process's copy stream of each CUDA device, and the ordering
    every transfer on them keeps: a copy starts after the work queued so
    far on its sources' compute streams; each device source is recorded on
    the stream that reads it and each copy on its device's compute stream
    (``record_stream``: neither is freed under the other side's work); the
    compute stream waits for the copies (:meth:`join`) before it reads
    them. The streamed scans' slot copies, ``make_ring_put`` and the mesh
    ring's block shipping all run on one of these.

    A copy from another card (the mesh ring's peer copies) runs where
    PyTorch runs a copy between two cards, on the source card's current
    stream, which :meth:`put` makes that card's send stream, a second copy
    stream of its own. On the source's compute stream the copy would queue
    between that card's scans; on the copy stream its destination joins, a
    card's outgoing copy would wait for its incoming one, and the copies
    around a ring would run one after another.

    One stream of each kind a device for the whole process, made at first
    use: the caching allocator keeps a block in the pool of the stream it
    was allocated on, so a stream made anew for each search would find none
    of the last search's copies free and allocate them again (a ring step's
    four 1 GB blocks: a cudaMalloc each, and the cache growing until it
    frees everything). An instance remembers the devices it copied to, for
    :meth:`join`."""

    def __init__(self):
        self._streams: dict = {}

    @staticmethod
    def _shared(dev: torch.device, kind: str) -> "torch.cuda.Stream":
        with _COPY_STREAMS_LOCK:
            cs = _COPY_STREAMS.get((dev, kind))
            if cs is None:
                cs = _COPY_STREAMS[dev, kind] = torch.cuda.Stream(dev)
            return cs

    def stream(self, dev: torch.device) -> "torch.cuda.Stream":
        dev = _cuda_device(dev)
        cs = self._streams.get(dev)
        if cs is None:
            cs = self._streams[dev] = self._shared(dev, "copy")
        return cs

    def put(self, p, dev: torch.device, copy: bool = False):
        """Partition record (or bare array) `p` moved to CUDA device `dev` on
        its copy stream, ordered as the class says (a source on another card
        read on that card's send stream); ``copy=True`` gives memory of its
        own even where `p` already lives on `dev`."""
        cs = self.stream(dev)
        sources = [t for t in _tensors(p) if t.is_cuda]
        send = {}
        for src in {t.device for t in sources}:
            cs.wait_stream(torch.cuda.current_stream(src))
            if src != cs.device:
                send[src] = self._shared(src, "send")
        with contextlib.ExitStack() as current:
            for ss in send.values():
                current.enter_context(torch.cuda.stream(ss))
            current.enter_context(torch.cuda.stream(cs))
            out = _move(p, dev, non_blocking=True, copy=copy)
        for t in sources:
            t.record_stream(send.get(t.device, cs))
        compute = torch.cuda.current_stream(dev)
        for t in _tensors(out):
            t.record_stream(compute)
        return out

    def join(self, dev: torch.device | None = None) -> None:
        """The compute stream of `dev` (None: of every device this instance
        copied to) waits for the copies queued so far on its copy stream."""
        for d, cs in self._streams.items():
            if dev is None or d == _cuda_device(dev):
                torch.cuda.current_stream(d).wait_stream(cs)


def device_put_partition(p, device=None):
    """Every array field of a partition record on `device`, host scalar
    metadata (n_valid, base_index) untouched; a bare array is moved as it
    is. ``device=None`` means CUDA, which must exist. Works for any
    NamedTuple partition: ``PaddedDataset`` and the int8 tier's multi-array
    ``Int8Partition`` alike. The active fault injector's ``on_device_put``
    fires first, as for every streamed transfer."""
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    _on_device_put(p)
    return _move(p, dev)


#: staging copies split into pieces of at least this many bytes, one a
#: host thread
STAGE_PIECE_BYTES = 4 << 20


def stage_threads() -> int:
    """Host threads that fill a staging bank: the cores this process may
    run on, at most 8 (the copy out of a mapping is bound by page faults,
    which threads overlap)."""
    return max(1, min(8, len(os.sched_getaffinity(0))))


def stage(dst: torch.Tensor, src, pool: ThreadPoolExecutor | None) -> None:
    """Copy host array `src` (a numpy array or mapping, or a host tensor)
    into host tensor `dst` of its shape, in row pieces of at least
    STAGE_PIECE_BYTES spread over `pool`'s stage_threads() threads (numpy
    and torch copies release the interpreter lock); in one piece without a
    pool."""
    if isinstance(src, np.ndarray):
        d = dst.numpy()

        def piece(a, b):
            np.copyto(d[a:b], src[a:b])
    else:
        def piece(a, b):
            dst[a:b].copy_(src[a:b])

    rows = int(dst.shape[0])
    n = min(rows, dst.numel() * dst.element_size() // STAGE_PIECE_BYTES,
            stage_threads() if pool is not None else 1)
    if n <= 1:
        piece(0, rows)
        return
    cuts = [rows * j // n for j in range(n + 1)]
    for f in [pool.submit(piece, a, b) for a, b in zip(cuts, cuts[1:])]:
        f.result()


def _dtype(v) -> torch.dtype:
    """The torch dtype of a tensor or numpy array (without reading it)."""
    return v.dtype if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.empty(0, v.dtype)).dtype


def _pinned_or_device(v) -> bool:
    return isinstance(v, torch.Tensor) and (v.device.type != "cpu" or v.is_pinned())


class _Banks:
    """``depth`` device slots for one partition layout, with their events,
    and the page-locked host banks that stage its pageable fields."""

    def __init__(self, template: dict, depth: int, device: torch.device):
        compute = torch.cuda.current_stream(device)
        self.slots = [{name: torch.empty(tuple(v.shape), dtype=_dtype(v), device=device)
                       for name, v in template.items()} for _ in range(depth)]
        self.ready = [torch.cuda.Event() for _ in range(depth)]
        # the slots' memory may have served tensors the compute stream still
        # reads: the first copy into each waits on the compute stream
        allocated = torch.cuda.Event()
        allocated.record(compute)
        self.consumed = [allocated] * depth
        self.staging: list[dict] = [{} for _ in range(depth)]  # made at first use
        self.next = 0

    def bank(self, i: int, name: str, like: torch.Tensor) -> torch.Tensor:
        """Staging bank `i`'s page-locked tensor for field `name`."""
        t = self.staging[i].get(name)
        if t is None:
            t = self.staging[i][name] = torch.empty(tuple(like.shape), dtype=like.dtype,
                                                    pin_memory=True)
        return t


class DoubleBufferedStream:
    """Iterate device-resident partitions while ``depth - 1`` more are in
    flight (``depth`` slots, see the module docstring).

    ``put_fn`` replaces the slot copy by the caller's own transfer (it gets
    the host item and returns the item to yield). Without one, every
    transfer first fires the active fault injector's ``on_device_put``, and
    pageable fields go through the stream's page-locked staging banks (see
    the module docstring). ``device=None`` means
    CUDA, which must exist; on ``device="cpu"`` items pass unchanged (numpy
    arrays become tensors).

    Re-iteration: if the source is a restartable iterable (a list, a
    DatasetStore's ``shard_source``, anything whose ``iter()`` opens a fresh
    pass), every ``iter(stream)`` starts a new scan. A one-shot source (a
    bare generator) supports exactly one pass: a second ``iter()`` raises
    instead of silently yielding nothing.

    A failed put is retried ``put_retries`` times with exponential backoff
    from ``retry_backoff_s``; every failed attempt counts into
    ``health["retries"]``, and the last failure escapes tagged with its
    stream position (``err.shard_index``). ``transfers`` counts partitions
    delivered to the consumer, ``restarts`` completed re-iterations.
    """

    def __init__(
        self,
        host_iter: Iterable[T],
        depth: int = 2,
        put_fn: Callable[[T], T] | None = None,
        put_retries: int = 0,
        retry_backoff_s: float = 0.05,
        health: dict | None = None,
        device=None,
    ):
        from repro_torch.core.engine import resolve_device

        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._device = resolve_device(device)
        self._source = host_iter
        self._it = iter(host_iter)
        self._depth = depth
        self._put_fn = put_fn
        self._put_retries = max(0, int(put_retries))
        self._retry_backoff_s = max(0.0, float(retry_backoff_s))
        self._health = health
        self._buf: collections.deque = collections.deque()
        self._banks: dict = {}
        self._copies = CopyStreams()
        self._pool: ThreadPoolExecutor | None = None  # staging threads, one pass
        self._started = False
        self._next_i = 0  # stream position of the next item the source yields
        self.transfers = 0  # observability: number of partitions delivered
        self.restarts = 0  # observability: completed re-iterations

    @staticmethod
    def _tag(err: BaseException, index: int) -> None:
        # failure forensics: which stream position died
        try:
            err.shard_index = index
        except Exception:
            pass

    def _put(self, item):
        """Issue the transfer of one host item; returns (device item, slot)
        where slot is (banks, i) for a slot copy, else None."""
        if self._put_fn is not None:
            return self._put_fn(item), None
        _on_device_put(item)
        if self._device.type != "cuda":
            return _move(item, self._device), None
        named = isinstance(item, tuple) and hasattr(item, "_fields")
        arrays = _array_fields(item) if named else {"": item}
        if not arrays:
            return item, None
        key = (type(item),) + tuple((name, tuple(v.shape), str(v.dtype))
                                    for name, v in arrays.items())
        banks = self._banks.get(key)
        if banks is None:
            banks = self._banks[key] = _Banks(arrays, self._depth, self._device)
        copy_stream = self._copies.stream(self._device)
        i = banks.next
        banks.next = (i + 1) % self._depth
        slot = banks.slots[i]
        sources = {}
        for name, v in arrays.items():
            if _pinned_or_device(v):
                sources[name] = v
                continue
            # pageable: fill page-locked bank i once the copy out of it (the
            # slot's previous "copy done") has completed
            banks.ready[i].synchronize()
            if self._pool is None and stage_threads() > 1:
                self._pool = ThreadPoolExecutor(stage_threads(),
                                                thread_name_prefix="stream-stage")
            sources[name] = banks.bank(i, name, slot[name])
            stage(sources[name], v, self._pool)
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(banks.consumed[i])
            for name, v in sources.items():
                slot[name].copy_(v, non_blocking=True)
            banks.ready[i].record(copy_stream)
        out = item._replace(**slot) if named else slot[""]
        return out, (banks, i)

    def _fill(self) -> None:
        while len(self._buf) < self._depth:
            try:
                item = next(self._it)
            except StopIteration:
                return
            except BaseException as e:
                self._tag(e, self._next_i)
                raise
            idx = self._next_i
            self._next_i += 1
            delay = self._retry_backoff_s
            for attempt in range(self._put_retries + 1):
                try:
                    self._buf.append(self._put(item))
                    break
                except Exception as e:
                    if self._health is not None:
                        self._health["retries"] = self._health.get("retries", 0) + 1
                    if attempt == self._put_retries:
                        self._tag(e, idx)
                        raise
                    if delay > 0:
                        time.sleep(delay)
                        delay *= 2

    def __iter__(self) -> Iterator[T]:
        if self._started:
            fresh = iter(self._source)
            if fresh is self._source:
                raise RuntimeError(
                    "DoubleBufferedStream source is a one-shot iterator that "
                    "was already consumed; a second pass would silently "
                    "yield nothing. Pass a restartable iterable (list, "
                    "a store's shard_source, or a callable-backed source) "
                    "to re-iterate.")
            self._it = fresh
            self._buf.clear()
            self._next_i = 0
            self.restarts += 1
        self._started = True
        compute = (torch.cuda.current_stream(self._device)
                   if self._device.type == "cuda" else None)
        try:
            self._fill()
            while self._buf:
                item, slot = self._buf.popleft()
                if slot is not None:
                    banks, i = slot
                    compute.wait_event(banks.ready[i])
                self.transfers += 1  # count on delivery, not on (maybe lost) ship
                yield item
                if slot is not None:
                    done = torch.cuda.Event()
                    done.record(compute)
                    banks.consumed[i] = done
                self._fill()  # the freed bank takes the next partition
        finally:
            # copies still in flight finish before the compute stream (and
            # the allocator, in its order) moves on
            self._copies.join()
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


def prefetch_to_device(host_iter: Iterable[T], depth: int = 2, put_fn=None, device=None):
    """Functional alias used by the data pipelines."""
    return iter(DoubleBufferedStream(host_iter, depth=depth, put_fn=put_fn, device=device))


def make_ring_put(devices) -> Callable:
    """Round-robin ``put_fn`` for mesh streaming: call i ships its partition
    (or bare array) to ``devices[i % len(devices)]``, firing the active fault
    injector's ``on_device_put`` first, as every streamed transfer does.

    This is the paper's ring-streamed FQ-SD schedule generalised to a device
    group: shard i lands on device i mod P and every device scans every
    P-th shard, P double-buffered pipelines out of one host iterator. On a
    CUDA device the copy runs on that device's copy stream (asynchronous
    from page-locked memory), the moved tensors are recorded on the
    device's compute stream, and the compute stream waits for the copy
    before any work queued after the put: a stream deep enough to put
    ahead of the consumer (the mesh executors use at least one shard a
    device) keeps copies of later shards under the scans of earlier ones.
    Devices may repeat (logical devices). Each call gives a fresh ring
    (counter at device 0).
    """
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_ring_put needs at least one device")
    counter = iter(range(1 << 62))
    copies = CopyStreams()

    def put(p):
        dev = devices[next(counter) % len(devices)]
        _on_device_put(p)
        if dev.type != "cuda":
            return _move(p, dev)
        out = copies.put(p, dev)
        copies.join(dev)
        return out

    return put


class ResilientShardSource:
    """Restartable shard iterable with bounded retry, quarantine, and
    straggler accounting — the self-healing front of every streamed scan.

    Wraps anything with the store surface (``read_shard(i, tier)``,
    ``n_shards``, ``delta_shards()`` — ``DatasetStore`` or the engine's
    masked view) and yields its shards in order:

    * a failed read is retried up to ``max_retries`` times with exponential
      backoff starting at ``backoff_s``; every failed attempt counts into
      ``health["retries"]``;
    * an int8 shard that stays unreadable is **quarantined with certified
      degradation**: its f32 rows are read (same retry budget) and yielded
      instead — exact distances are valid lower bounds, so the streamed
      int8 certificate stays sound and results stay bit-identical to the
      f32 oracle; the shard id lands in ``health["degraded"]``;
    * a shard unrecoverable on every tier raises unless the request opted
      in with ``allow_partial=True``, in which case it is skipped and
      listed in ``health["failed_shards"]`` (the engine flags the result
      ``partial``) — never a silent wrong top-k;
    * reads slower than ``straggler_factor ×`` the EWMA of recent read
      times are recorded in ``health["slow_shards"]``; reads are timed on
      ``clock`` (seconds, ``time.perf_counter`` by default).

    The f32 pass also yields the store's delta shards; the int8 pass covers
    main shards only.
    """

    def __init__(self, store, tier: str, max_retries: int = 2,
                 backoff_s: float = 0.05, allow_partial: bool = False,
                 health: dict | None = None, straggler_factor: float = 4.0,
                 clock: Callable[[], float] = time.perf_counter):
        self._store = store
        self._tier = tier
        self._retries = max(0, int(max_retries))
        self._backoff_s = max(0.0, float(backoff_s))
        self._allow_partial = bool(allow_partial)
        self._straggler_factor = float(straggler_factor)
        self._clock = clock
        self._mean_read_s: float | None = None  # EWMA of shard read times
        self.health = health if health is not None else _fresh_health()

    def _note_read_time(self, i: int, dt: float) -> None:
        mean = self._mean_read_s
        if mean is None:
            self._mean_read_s = dt
            return
        if mean > 1e-6 and dt > self._straggler_factor * mean:
            self.health["slow_shards"].append(i)
        self._mean_read_s = 0.8 * mean + 0.2 * dt

    def _read(self, i: int, tier: str):
        delay = self._backoff_s
        for attempt in range(self._retries + 1):
            try:
                t0 = self._clock()
                p = self._store.read_shard(i, tier)
                self._note_read_time(i, self._clock() - t0)
                return p
            except Exception as e:
                self.health["retries"] += 1
                if attempt == self._retries:
                    try:
                        e.shard_index = i
                    except Exception:
                        pass
                    raise
                if delay > 0:
                    time.sleep(delay)
                    delay *= 2

    def __iter__(self):
        for i in range(int(self._store.n_shards)):
            try:
                p = self._read(i, self._tier)
            except Exception:
                p = None
                if self._tier == "int8":
                    try:
                        p = self._read(i, "f32")
                    except Exception:
                        p = None
                    else:
                        if i not in self.health["degraded"]:
                            self.health["degraded"].append(i)
                if p is None:
                    if not self._allow_partial:
                        raise
                    if i not in self.health["failed_shards"]:
                        self.health["failed_shards"].append(i)
                    continue
            yield p
        if self._tier == "f32":
            yield from self._store.delta_shards()


class SpeculativeGather:
    """Background speculative gather of candidate rows.

    The double buffer pointed the other way: while the card drains the
    remaining shards of a streamed int8 scan, a thread resolves a snapshot
    of the candidate queue to host ids, dedups them and reads their f32 rows
    through ``store.gather_rows`` (host reads, safe beside the scan's own
    shard reads). The consumer joins at rescore time and tops up only ids
    the final queue added after the snapshot.

    The snapshot is a clone taken on the compute stream, with an event
    recorded after it; the thread waits on that event and copies the clone
    to the host on a stream of its own, so it neither reads a queue still
    being written nor queues behind the rest of the scan.

    The speculation is advisory by construction: the exact rescore always
    runs on the final queue's ids, with speculated rows keyed by id — a
    wrong guess costs wasted bytes (reported, charged to bytes_scanned),
    never a wrong result. A failed speculation is advisory too:
    ``result()`` returns ``None`` (the error is kept on ``.error``) and the
    executor degrades to the synchronous gather it would have run anyway.
    """

    def __init__(self, candidate_ids: torch.Tensor, store):
        self._snapshot = candidate_ids.clone()
        self._ready = None
        if self._snapshot.is_cuda:
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self._snapshot.device))
        self._store = store
        self.ids: torch.Tensor | None = None  # sorted unique snapshot ids (int64)
        self.rows: torch.Tensor | None = None  # f32 rows, aligned with ids
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="speculative-gather")
        self._thread.start()

    def _host_snapshot(self) -> torch.Tensor:
        if self._ready is None:
            return self._snapshot
        self._ready.synchronize()
        side = torch.cuda.Stream(self._snapshot.device)
        with torch.cuda.stream(side):
            host = self._snapshot.to("cpu")
        return host

    def _run(self) -> None:
        try:
            ids = torch.unique(self._host_snapshot().to(torch.int64))  # sorted
            self.rows = self._store.gather_rows(ids)
            self.ids = ids
        except Exception as e:  # surfaced to the consumer on result()
            self.error = e

    def result(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Join the thread; (sorted unique ids, their f32 rows), or ``None``
        if the background gather failed (``.error`` holds the exception)."""
        self._thread.join()
        if self.error is not None:
            return None
        assert self.ids is not None and self.rows is not None
        return self.ids, self.rows


__all__ = ["DoubleBufferedStream", "ResilientShardSource", "SpeculativeGather",
           "device_put_partition", "make_ring_put", "prefetch_to_device"]
