"""Fused exact kNN on Hopper: distances folded into top-k queues on chip.

Replaces ``repro/kernels/knn/kernel.py::knn_pallas`` (``_knn_kernel``),
``repro/kernels/knn/kernel_int8.py::knn_pallas_int8``
(``_knn_int8_kernel``) and the bitonic routines of
``repro/kernels/bitonic.py`` they call. The CUDA sources are
``../csrc/knn.cu`` (``knn_scan``, ``knn_merge``), ``../csrc/knn_int8.cu``
(``knn_int8_scan``), ``../csrc/select.cuh`` (the survivor filter),
``../csrc/ring.cuh`` (``cp.async``) and ``../csrc/bitonic.cuh``.

What ``knn_scan`` computes, exactly as the TPU kernel does: for each query,
the k_eff lexicographically smallest (score, index) pairs over the dataset,
sorted; l2 scores are ``max(qn - 2·q·x + xn, 0)``, ip scores ``-q·x``,
rows whose norm is not finite score +inf. The (M, N) score matrix never
reaches device memory. ``knn_int8_scan`` computes the same over int8 codes
read at 1 B/element, whose epilogue turns the widened dot product into the
certified lower bound of ``repro_torch.core.quantized``
(``max(sqrt(max((qn - 2·acc·scale) + hn, 0)) - err, 0)²``, +inf on rows
whose quantised norm is not finite) and keeps a q_len = 2r wide queue.

Design of ``knn_scan``. The TPU grid runs in order with one queue per
m-tile, and only the m axis is parallel, so for FD-SQ (m = 1) it would be
one block on a card of 132 SMs. Here the n-tiles are split instead: the
scan runs a grid of (m / bm, S) blocks, block (i, s) scanning a contiguous
range of n-tiles into its own sorted queues, with S chosen to fill the card
with two blocks per SM; ``knn_merge`` then reduces the S sorted queues of
each query. The result is the exact top-k of the union, so it equals the
sequential TPU result bit for bit whenever the scores do. It reads x once
per m-tile (N·d·4 bytes, half that in bf16) and does 2·M·N·d f32 FLOPs on
the CUDA cores (no tensor cores, no TF32: f32 stays IEEE, bf16 is widened
exactly); at the main path's shapes (M <= 16) the bytes bound it. A block
scores all bm (up to 16) queries of its m-tile, so x is read once at
M = 16. Each thread owns a bm × kRows micro-tile (queries × rows; kRows
is 2 for bm >= 8, else 4) in registers: each row element is read once from
shared memory and used for every query, each query value (staged as f32)
comes in a 16-byte broadcast. At bm = 16 the scoring is bound by those
broadcasts (shared-memory bytes, not FMAs), so a stage holds 64 bytes of
two rows a thread and each query value feeds 8 FMAs, with L2 asked to
fetch each row's whole 128-byte line, whose other half the next stage
reads (32-byte pieces read without it ran at half the memory rate); at
small bm, where the scan only streams, a stage holds 128 bytes of one row
a thread. Stages of 32 KB and the query slices come through a two-stage
``cp.async`` ring, the next stage loading under the current one's FMAs. The scores never reach shared memory as a tile: after
each chunk of 256·kRows rows they go from registers through
``select.cuh``, which keeps only the lanes below each queue's worst pair,
sorts those (counting ranks when a few, ``bitonic_sort_rows`` otherwise)
and merges them into the queue along merge paths. The bm queues live in
device memory (the output, and a scratch buffer as the second of two), so
shared memory holds only the ring and a survivor buffer of 128 to 1024
lanes a row, and k no longer limits bm. The per-tile semantics stay the
TPU kernel's: after each bn-row tile every queue holds the k smallest pairs
of (queue ∪ tile), and a tile whose every row's minimum is strictly above
its queue's tile-start worst value counts as a skip, so values, indices
and skip counts are the plain version's at the same (bm, bn, S).

The bound of ``knn_scan``. A block's filter starts at (+inf, -1) and only
tightens once its queues hold k pairs, so a block that sees few rows a
query admits most of them: at GIST's shape (k = 1024, S = 245) a block
scans 4,096 rows in random order and admits about k·(1 + ln 4) ≈ 2,400
a query, each admitted batch sorted and merged into queues in device
memory. An optional (M,) bound (bound_v, bound_i) starts each query's
filter at that pair instead: a lane enters only at or below it (as
strictly below (bound_v, bound_i + 1)), and once the queue is full below
its worst pair, which then lies at or below the bound; the prune test's
tile-start value is the smaller of the two. Empty slots stay (+inf, -1),
a +inf bound bounds nothing, and the plain version models it exactly
(lanes past the bound score +inf for the update), so values, indices and
skips still agree at the same (bm, bn, S, bound). ``knn_fused`` takes
the bound from a pilot (:func:`pilot_bound`, where :func:`pilot_rows`
says so): the k-th pair of a strided sample of the rows, scanned first by
the same kernels on the same queries (a pair's
score has the same bits in any batch and at any bm). The sample's pairs
are pairs of the scan, so at least k pairs lie at or below the bound and
the merged answer is bit-identical to the unbounded one; only the skip
counts, a statistic, may change. The kernel reads the sample in place: x's
rows lie x_pitch elements apart and xn's xn_step apart (a row-strided view;
the main scan's pitch is d, its step 1), so no copy of the rows is made.

Design of ``knn_int8_scan`` (its own kernel, the same structure). At
M = 16 the widened codes' f32 FMAs, not the 1 B/element reads, bound it.
Its stages hold 32 codes a row, widened by a byte permute and a float
subtraction (exact, full rate), and its epilogue gives certified lower
bounds into queues of q_len pairs.

Design of ``knn_merge``: one launch, one block of 1024 threads per query
row, reading only what can reach the answer. Queue s's pair at place
(j+1)·stride - 1 has at least (j+1)·stride pairs of its queue at or below
it, so the (k / stride)-th smallest of these samples over all S queues,
tau, has at least k pairs of the union at or below it and fewer than
k + S·stride strictly below. One binary search per queue finds its prefix
strictly below tau; the answer is the k smallest of those candidates,
sorted, then copies of tau. Both selections (the samples', the
candidates') gather their pairs in rounds of 8192 into shared memory
beside the pairs kept so far and keep the smallest by a radix select over
a 64-bit key whose order is the pair order (8 bits a pass, stopping as
soon as the bucket of the k-th is taken whole), so only the k kept pairs
are ever sorted (``bitonic_sort_rows``). With stride ≈ sqrt(k) a row reads
fewer than S·(k / stride + stride) + k of its S·k pairs, and the binary
searches (at S = 123, k = 8192, stride 128: 31,808 of 1,007,616, 3.2 %).

The union's q_len smallest pairs are the sequential queue's q_len smallest
pairs, so the certificate's entry r is the TPU kernel's. Pruning skips a
tile when every query's tile minimum is strictly worse than its block
queue's current worst value. A block's queue has seen only its own range,
so on the same data the skip count reads lower than the TPU's sequential
grid (the plain version with S = 1 gives the TPU's count); it is a
statistic, not a result.

On a CPU tensor every wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Every launch, here and in ``kernels/topk``
and ``kernels/l2dist``, runs under its operands' device
(:func:`on_card`, a no-op where that card is current already): CUDA
launches into the current device and sets a kernel's shared-memory limit
for the current device alone, and a launch onto another card's stream
returns no error yet does not run as asked (without the guard, half of a
four-card ring's answers came out malformed). So operands on any card of
the host launch on it, and operands on two devices raise before anything
is launched. ``LAUNCHES`` counts kernel launches only,
for these kernels and for ``topk`` and ``l2dist`` (``kernels/topk``,
``kernels/l2dist``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.distance import query_norms_sq
from repro_torch.core.quantized import sqrt_rn
from repro_torch.core.topk import topk_smallest, tree_merge_sorted
from repro_torch.runtime import tracing

#: Kernel launches per kernel name, counted where each wrapper launches.
LAUNCHES = {"knn_scan": 0, "knn_merge": 0, "knn_int8_scan": 0, "topk": 0, "l2dist": 0}

_METRICS = {"l2": 0, "ip": 1}
_BLOCK_ROWS = (1, 2, 4, 8, 16)  # bm values every kernel is built for
_THREADS = 256  # threads per block
_DEPTH = 32  # dim must be a multiple
_SM_SMEM_BYTES = 233_472  # shared memory per SM on Hopper (228 KB)
_BLOCK_SMEM_MAX = 232_448  # shared memory one block may take (227 KB)
_SM_BLOCK_RESERVED = 1024  # shared memory the SM keeps back per resident block
_SELECT_BOOK = 1024  # bookkeeping bytes of csrc/select.cuh (kSelectBookBytes)
_INT8_CHUNK = 1024  # dataset rows an int8 block scores per pass: 256 threads × 4
_STAGE_BYTES = 32_768  # rows of one stage of the f32/bf16 scan's ring
_QUERY_BYTES = 256  # room per query row in a stage of that ring
_INT8_DEPTH = 32  # features (bytes) per stage of the int8 scan's ring
_CAP_MIN, _CAP_MAX = 128, 1024  # survivor lanes per query row of a scan
_MERGE_THREADS = 1024  # threads of a merge block
_MERGE_POOL = 8192  # pairs a merge round gathers


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def scan_smem_bytes(bm: int, cap: int) -> int:
    """Shared memory of one f32/bf16 scan block (``scan_smem_bytes`` in
    knn.cu): selection bookkeeping, two ring stages of 32 KB of rows and of
    f32 query slices, a survivor buffer of ``cap`` (value, index) lanes per
    query row, and the rows' qn and tile-start worst values. The queues live in device memory, so k does
    not enter."""
    return _SELECT_BOOK + 2 * (_STAGE_BYTES + bm * _QUERY_BYTES) + bm * cap * 8 + 128


def int8_scan_smem_bytes(bm: int, cap: int) -> int:
    """Shared memory of one int8 scan block (``int8_smem_bytes`` in
    knn_int8.cu): as :func:`scan_smem_bytes`, with stages of 32 int8 codes
    a row and query slices of 32 f32 features."""
    return (_SELECT_BOOK + 2 * (_INT8_CHUNK * _INT8_DEPTH + bm * _INT8_DEPTH * 4)
            + bm * cap * 8 + 128)


def _max_block_m(smem) -> int:
    fit = [b for b in _BLOCK_ROWS if 2 * (smem(b, _CAP_MIN) + _SM_BLOCK_RESERVED)
           <= _SM_SMEM_BYTES]
    return fit[-1]


def max_block_m() -> int:
    """Largest bm for which two f32/bf16 scan blocks share an SM: the
    scoring's 16, whatever the queue width."""
    return _max_block_m(scan_smem_bytes)


def int8_max_block_m() -> int:
    """Largest bm for which two int8 blocks share an SM: the scoring's 16,
    whatever q_len is."""
    return _max_block_m(int8_scan_smem_bytes)


def _survivor_cap(smem, bm: int, blocks: int, sms: int) -> int:
    room = (_SM_SMEM_BYTES // 2 - _SM_BLOCK_RESERVED if blocks > sms else _BLOCK_SMEM_MAX)
    cap = _CAP_MIN
    while cap < _CAP_MAX and smem(bm, 2 * cap) <= room:
        cap *= 2
    return cap


def scan_survivor_cap(bm: int, blocks: int, sms: int) -> int:
    """Survivor lanes per query row of the f32/bf16 scan: the largest power
    of two (128 to 1024) whose block still fits the grid's blocks per SM
    (two when the grid has more blocks than the card has SMs, else one),
    so the first batches, where every lane survives, sort in as few passes
    as fit."""
    return _survivor_cap(scan_smem_bytes, bm, blocks, sms)


def int8_survivor_cap(bm: int, blocks: int, sms: int) -> int:
    """As :func:`scan_survivor_cap`, for the int8 scan."""
    return _survivor_cap(int8_scan_smem_bytes, bm, blocks, sms)


def merge_smem_bytes(k: int) -> int:
    """Shared memory of one merge block (``merge_smem_bytes`` in knn.cu):
    the pool of gathered pairs, two buffers of k kept pairs, the radix
    histogram and the candidate offsets of 1024 queues."""
    return _MERGE_POOL * 8 + k * 16 + (256 + _MERGE_THREADS) * 4 + 128


def merge_stride(k: int) -> int:
    """Sample stride of the merge: the power of two at or just above
    sqrt(k), which keeps the S·k / stride samples and the fewer than
    k + S·stride candidates about equal."""
    return 1 << (k.bit_length() // 2)


def tiles_per_split(n_tiles: int, splits: int) -> int:
    return -(-n_tiles // splits)


def _check(q, x, qn, xn, k_eff, metric, bm, bn):
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and x {tuple(x.shape)} must be (M, d), (N, d)")
    for name, t, rows in (("qn", qn, q.shape[0]), ("xn", xn, x.shape[0])):
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 of shape ({rows},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if q.dtype != x.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q and x must both be f32 or both bf16, got {q.dtype}, {x.dtype}")
    if metric not in _METRICS:
        raise ValueError(f"kernel metric must be l2 or ip, got {metric!r}")
    m, n = q.shape[0], x.shape[0]
    if bm not in _BLOCK_ROWS or m % bm:
        raise ValueError(f"bm={bm} must be one of {_BLOCK_ROWS} and divide M={m}")
    if bn % _THREADS or bn & (bn - 1) or n % bn:
        raise ValueError(f"bn={bn} must be a power of two >= {_THREADS} dividing N={n}")
    if k_eff & (k_eff - 1) or not 1 <= k_eff <= bn:
        raise ValueError(f"k_eff={k_eff} must be a power of two <= bn={bn}")


def _check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"a kernel's operands must share one CUDA device, got {t.device} "
                             f"and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tensors must be contiguous and 16-byte aligned")


def _check_rows(q, x, xn):
    """x and xn may be row-strided views of the scan's rows (the pilot's
    sample): x with unit stride along d and rows on 16-byte boundaries."""
    for t in (x, xn):
        if t.device != q.device:
            raise ValueError(f"a kernel's operands must share one CUDA device, got {t.device} "
                             f"and {q.device}")
    if (x.stride(1) != 1 or x.stride(0) < x.shape[1] or x.stride(0) >= 2**31
            or (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16
            or not 1 <= xn.stride(0) < 2**31):
        raise ValueError(f"x must have unit stride along d and rows on 16-byte boundaries, "
                         f"got strides {x.stride()}; xn stride {xn.stride()}")


_CURRENT = contextlib.nullcontext()


def on_card(dev: torch.device):
    """The guard every launch runs under: a context that makes ``dev``
    current (``torch.cuda.device``) and restores the card that was, or a
    shared no-op context where ``dev`` is current already (one read of the
    current device, where entering ``torch.cuda.device`` costs ~3 µs)."""
    return _CURRENT if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _resolve_splits(splits: int, n_tiles: int):
    """(S, tiles per split) of a given S, which must leave no split empty."""
    if not 1 <= splits <= min(n_tiles, 65535):
        raise ValueError(f"splits={splits} must be in [1, min({n_tiles}, 65535)]")
    tps = tiles_per_split(n_tiles, splits)
    if -(-n_tiles // tps) != splits:
        raise ValueError(f"splits={splits} leaves a split of {n_tiles} tiles empty")
    return splits, tps


def _scan_config(cap_of, m_tiles: int, n_tiles: int, bm: int, device, splits):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if splits is None:
        splits = min(n_tiles, 65535, max(1, 2 * sms // m_tiles))
        splits = -(-n_tiles // tiles_per_split(n_tiles, splits))
    splits, tps = _resolve_splits(splits, n_tiles)
    return splits, tps, cap_of(bm, m_tiles * splits, sms)


def scan_config(m_tiles: int, n_tiles: int, bm: int, device,
                splits: int | None = None) -> tuple[int, int, int]:
    """(S, tiles per split, survivor cap) of an f32/bf16 scan: ``None``
    fills the card with two blocks per SM (one wave), a given S must leave
    no split empty."""
    return _scan_config(scan_survivor_cap, m_tiles, n_tiles, bm, device, splits)


def _check_bound(q, bound_v, bound_i):
    if (bound_v is None) != (bound_i is None):
        raise ValueError("bound_v and bound_i come together")
    if bound_v is None:
        return
    m = q.shape[0]
    for name, t, dtype in (("bound_v", bound_v, torch.float32), ("bound_i", bound_i, torch.int32)):
        if t.shape != (m,) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name} must be {dtype} of shape ({m},) on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def knn_scan(q, x, qn, xn, k_eff: int, metric: str, bm: int, bn: int,
             prune: bool = True, splits: int | None = None, return_stats: bool = False,
             bound_v=None, bound_i=None):
    """Per-split sorted queues: (M, S, k_eff) f32 values and i32 indices,
    and (M / bm, S) i32 skip counts. ``splits=None`` fills the card.
    ``return_stats=True`` (CUDA tensors only) adds the kernel's selection
    counters, (M / bm, S, 4) i32: survivors, passes, comparisons of the
    survivor sorts, queue pairs moved. ``bound_v`` / ``bound_i``, (M,) f32
    and i32, admit only the (score, index) pairs at or below each query's
    (bound_v, bound_i); empty queue slots stay (+inf, -1) (see the design
    note). x and xn may be row-strided views (``x[::s]``, ``xn[::s]``):
    the kernel reads them in place, and indices count their rows."""
    _check(q, x, qn, xn, k_eff, metric, bm, bn)
    _check_bound(q, bound_v, bound_i)
    if q.device.type == "cpu":
        if return_stats:
            raise ValueError("selection counters come from the kernel: CUDA tensors only")
        return knn_scan_plain(q, x, qn, xn, k_eff, metric, bm, bn, prune, splits or 1,
                              bound_v, bound_i)
    _check_cuda(q, qn, *(() if bound_v is None else (bound_v, bound_i)))
    _check_rows(q, x, xn)
    if q.shape[1] % _DEPTH:
        raise ValueError(f"d={q.shape[1]} must be a multiple of {_DEPTH}")
    from repro_torch.kernels.build import load_library

    m, n, d = q.shape[0], x.shape[0], q.shape[1]
    m_tiles, n_tiles = m // bm, n // bn
    splits, tps, cap = scan_config(m_tiles, n_tiles, bm, q.device, splits)
    shape = (m, splits, k_eff)
    out_v, scratch_v = (torch.empty(shape, dtype=torch.float32, device=q.device)
                        for _ in range(2))
    out_i, scratch_i = (torch.empty(shape, dtype=torch.int32, device=q.device)
                        for _ in range(2))
    skips = torch.empty((m_tiles, splits), dtype=torch.int32, device=q.device)
    stats = (torch.zeros((m_tiles, splits, 4), dtype=torch.int32, device=q.device)
             if return_stats else None)
    q32 = q.to(torch.float32).contiguous()  # bf16 widens exactly
    with on_card(q.device):
        err = load_library().knn_scan(
            q32.data_ptr(), x.data_ptr(), qn.data_ptr(), xn.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), scratch_v.data_ptr(), scratch_i.data_ptr(), skips.data_ptr(),
            None if stats is None else stats.data_ptr(),
            None if bound_v is None else bound_v.data_ptr(),
            None if bound_i is None else bound_i.data_ptr(), m, n, d, x.stride(0),
            xn.stride(0), k_eff, bm, bn,
            _METRICS[metric], int(prune), splits, tps, cap, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "knn_scan")
    LAUNCHES["knn_scan"] += 1
    return (out_v, out_i, skips, stats) if return_stats else (out_v, out_i, skips)


def knn_merge(v, i):
    """(M, S, k) sorted queues -> (M, k): the k smallest pairs of each
    query's S queues, sorted; one launch."""
    if v.ndim != 3 or v.shape != i.shape or v.dtype != torch.float32 or i.dtype != torch.int32:
        raise ValueError(f"expected (M, S, k) f32 and i32 queues, got {v.dtype} {i.dtype} "
                         f"{tuple(v.shape)} {tuple(i.shape)}")
    m, splits, k = v.shape
    if k & (k - 1) or not k:
        raise ValueError(f"queue width k={k} must be a power of two")
    if v.device.type == "cpu":
        return knn_merge_plain(v, i)
    _check_cuda(v, i)
    if merge_smem_bytes(k) > _BLOCK_SMEM_MAX or not 1 <= splits * k < 2**31:
        raise ValueError(f"(S, k) = ({splits}, {k}): the merge takes k <= 8192, S·k < 2^31")
    from repro_torch.kernels.build import load_library

    out_v = torch.empty((m, k), dtype=torch.float32, device=v.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=v.device)
    with on_card(v.device):
        err = load_library().knn_merge(
            v.data_ptr(), i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), m, splits, k,
            merge_stride(k), torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on(err, "knn_merge")
    LAUNCHES["knn_merge"] += 1
    return out_v, out_i


def int8_scan_config(m_tiles: int, n_tiles: int, bm: int, device,
                     splits: int | None = None) -> tuple[int, int, int]:
    """As :func:`scan_config`, for the int8 scan."""
    return _scan_config(int8_survivor_cap, m_tiles, n_tiles, bm, device, splits)


def _check_int8(q, x8, qn, scales, err, hn, q_len, bm, bn):
    if q.ndim != 2 or x8.ndim != 2 or q.shape[1] != x8.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and x8 {tuple(x8.shape)} must be (M, d), (N, d)")
    if q.dtype != torch.float32 or x8.dtype != torch.int8:
        raise ValueError(f"q must be f32 and x8 int8, got {q.dtype}, {x8.dtype}")
    m, n = q.shape[0], x8.shape[0]
    if bm not in _BLOCK_ROWS or m % bm:
        raise ValueError(f"bm={bm} must be one of {_BLOCK_ROWS} and divide M={m}")
    if bn % _THREADS or bn & (bn - 1):
        raise ValueError(f"bn={bn} must be a power of two >= {_THREADS}")
    if q_len & (q_len - 1) or not 1 <= q_len <= bn:
        raise ValueError(f"q_len={q_len} must be a power of two <= bn={bn}")
    rows = -(-n // bn) * bn
    for name, t, want in (("qn", qn, m), ("scales", scales, rows), ("err", err, rows),
                          ("hn", hn, rows)):
        if t.shape != (want,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 of shape ({want},), got {t.dtype} "
                             f"{tuple(t.shape)}")


def knn_int8_scan(q, x8, qn, scales, err, hn, q_len: int, bm: int, bn: int,
                  prune: bool = True, splits: int | None = None, return_stats: bool = False):
    """Per-split sorted queues of certified lower bounds: (M, S, q_len) f32
    bounds and i32 indices, and (M / bm, S) i32 skip counts.

    q (M, d) f32, x8 (N, d) int8 codes; qn (M,) f32; scales, err and hn
    cover ceil(N / bn)·bn rows (padded with 1, 0 and +inf: hn is the exact
    quantised norm with +inf on invalid rows). N need not be a multiple of
    bn: the codes are never copied to pad them. ``splits=None`` fills the
    card. ``return_stats=True`` (CUDA tensors only) adds the kernel's
    selection counters, (M / bm, S, 4) i32: survivors, passes,
    comparisons of the survivor sorts, queue pairs moved."""
    _check_int8(q, x8, qn, scales, err, hn, q_len, bm, bn)
    if q.device.type == "cpu":
        if return_stats:
            raise ValueError("selection counters come from the kernel: CUDA tensors only")
        return knn_int8_scan_plain(q, x8, qn, scales, err, hn, q_len, bm, bn, prune,
                                   splits or 1)
    _check_cuda(q, x8, qn, scales, err, hn)
    if q.shape[1] % _DEPTH:
        raise ValueError(f"d={q.shape[1]} must be a multiple of {_DEPTH}")
    from repro_torch.kernels.build import load_library

    m, n, d = q.shape[0], x8.shape[0], q.shape[1]
    m_tiles, n_tiles = m // bm, -(-n // bn)
    splits, tps, cap = int8_scan_config(m_tiles, n_tiles, bm, q.device, splits)
    shape = (m, splits, q_len)
    out_v, scratch_v = (torch.empty(shape, dtype=torch.float32, device=q.device)
                        for _ in range(2))
    out_i, scratch_i = (torch.empty(shape, dtype=torch.int32, device=q.device)
                        for _ in range(2))
    skips = torch.empty((m_tiles, splits), dtype=torch.int32, device=q.device)
    stats = (torch.zeros((m_tiles, splits, 4), dtype=torch.int32, device=q.device)
             if return_stats else None)
    with on_card(q.device):
        rc = load_library().knn_int8_scan(
            q.data_ptr(), x8.data_ptr(), qn.data_ptr(), scales.data_ptr(), err.data_ptr(),
            hn.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), scratch_v.data_ptr(),
            scratch_i.data_ptr(), skips.data_ptr(),
            None if stats is None else stats.data_ptr(), m, n, d, q_len, bm, bn, int(prune),
            splits, tps, cap, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "knn_int8_scan")
    LAUNCHES["knn_int8_scan"] += 1
    return (out_v, out_i, skips, stats) if return_stats else (out_v, out_i, skips)


#: A pilot scans PILOT·k_eff rows, for scans whose splits see fewer rows
#: than that, over at least PILOT times the pilot's rows (:func:`pilot_rows`).
PILOT = 16
#: The fewest rows a pilot pays for: its fixed cost, two launches and about
#: 0.2 ms on an H100, exceeds the selection it saves below them.
PILOT_MIN_ROWS = 1 << 18


def pilot_rows(n: int, k_eff: int, split_rows: int, bm: int) -> int:
    """The rows of the pilot that bounds a scan's survivor filter, or 0
    for none. A split of the scan sees ``split_rows`` rows (its tiles × bn)
    and admits about k_eff·(1 + ln(split_rows / k_eff)) of them a query
    when their order is random: below PILOT·k_eff rows that is most of
    them, and every admitted batch is sorted and merged. Then, when the n
    rows number at least PILOT times as many, a pilot of PILOT·k_eff rows
    bounds the filter at about a PILOT-th of the lanes. It pays only where
    the selection is a large share of the scan: at the full m-tile of 16
    queries a block (at bm <= 4 the scan, bound by its rows' read, ran
    slower with it at every n measured) and over at least PILOT_MIN_ROWS
    rows."""
    rows = PILOT * k_eff
    engage = (split_rows < rows and n >= max(PILOT * rows, PILOT_MIN_ROWS)
              and bm == _BLOCK_ROWS[-1])
    return rows if engage else 0


def pilot_bound(q, x, qn, xn, k_eff: int, metric: str, bm: int, bn: int, rows: int):
    """Each query's bound on its answer over the rows x (norms xn),
    (bound_v, bound_i): (M,) f32 and i32. The pilot is ``rows`` of x's rows
    at the stride len(x) // rows, their norms with them (excluded rows stay
    +inf), read in place (strided views: no copy), scanned by ``knn_scan``
    + ``knn_merge`` on the same q and qn, so it scores a pair with the bits
    the main scan gives it; the bound is its k_eff-th pair, the pilot's
    index mapped back to the row's. The pilot's rows are rows of the scan,
    so at least k_eff pairs lie at or below the bound and the answer passes
    it whole. With fewer than k_eff finite pairs in the pilot the bound is
    (+inf, -1), which bounds nothing. ``rows`` must be a multiple of bn.

    The pilot has few tiles (PILOT at bn = k_eff), each one block's serial
    scan, so it runs at an eighth of the scan's bm: eight times the
    blocks (128 at GIST's shape), each selecting for an eighth of the
    queries, the pilot's rows read that many times (a pair's score has the
    same bits at any bm)."""
    stride = x.shape[0] // rows
    sv, si, _ = knn_scan(q, x[::stride][:rows], qn, xn[::stride][:rows], k_eff, metric,
                         max(1, bm // 8), bn)
    v, i = knn_merge(sv, si)
    bound_i = torch.where(i[:, -1] >= 0, i[:, -1] * stride, -1)
    return v[:, -1].clone(memory_format=torch.contiguous_format), bound_i


def knn_fused(q, x, xn, k_eff: int, metric: str = "l2", bm: int = 16,
              bn: int = 512, bd: int = 512, prune: bool = True):
    """Fused exact kNN with the TPU kernel's contract: M % bm == N % bn ==
    d % bd == 0, k_eff a power of two <= bn, xn (N,) f32 with +inf on
    padded rows, q and x of one dtype. Returns (values (M, k_eff), indices
    (M, k_eff), skips (M / bm, 1)) — skips summed over the splits.

    ``bd`` is checked against d and has no other effect on the card: the
    scan stages ``kDepth`` (32) features per slice whatever ``bd`` is. It
    stays in the signature so the plan's blocks match the TPU kernel's.

    The query norms are summed in one fixed order (``query_norms_sq``):
    each pair's score is one FMA chain over d whatever bm, so a query's
    scores have the same bits in any batch.

    On the card, where :func:`pilot_rows` engages at the scan's split, a
    pilot bounds the scan's filter first (:func:`pilot_bound`); the answer
    is the unbounded scan's, bit for bit. While ``runtime.tracing``
    records, the scan's selection counters give the counters
    ``scan.survivors`` (the lanes its filter admitted, read when the
    counters are read) and ``scan.lanes`` (the M × N lanes it scored); the
    pilot's own are not counted."""
    if q.shape[1] % bd:
        raise ValueError(f"d={q.shape[1]} not a multiple of bd={bd}")
    if q.device.type == "cpu":
        return knn_fused_plain(q, x, xn, k_eff, metric, bm, bn, bd, prune)
    qn = query_norms_sq(q)
    splits, tps, _ = scan_config(q.shape[0] // bm, x.shape[0] // bn, bm, q.device)
    rows = pilot_rows(x.shape[0], k_eff, tps * bn, bm)
    bound_v, bound_i = (pilot_bound(q, x, qn, xn, k_eff, metric, bm, bn, rows) if rows
                        else (None, None))
    traced = tracing.recording()
    out = knn_scan(q, x, qn, xn, k_eff, metric, bm, bn, prune, splits, return_stats=traced,
                   bound_v=bound_v, bound_i=bound_i)
    if traced:
        tracing.count("scan.survivors", out[3][..., 0].sum())
        tracing.count("scan.lanes", q.shape[0] * x.shape[0])
    v, i = knn_merge(out[0], out[1])
    return v, i, out[2].sum(dim=1, keepdim=True, dtype=torch.int32)


def knn_int8_fused(q, x8, qn, scales, err, hn, q_len: int, bm: int, bn: int,
                   prune: bool = True):
    """The int8 candidate scan with the TPU kernel's contract: (M, q_len)
    sorted lower bounds and indices, and (M / bm, 1) skips summed over the
    splits. On a CPU tensor the plain version runs with S = 1, so its skip
    count is the TPU kernel's."""
    if q.device.type == "cpu":
        v, i, skips = knn_int8_scan_plain(q, x8, qn, scales, err, hn, q_len, bm, bn, prune, 1)
        return v[:, 0], i[:, 0], skips
    sv, si, skips = knn_int8_scan(q, x8, qn, scales, err, hn, q_len, bm, bn, prune)
    v, i = knn_merge(sv, si)
    return v, i, skips.sum(dim=1, keepdim=True, dtype=torch.int32)


# ------------------------------------------------------------ plain versions
def plain_queues(tile_scores, m: int, n_tiles: int, k: int, bm: int, bn: int,
                  prune: bool, splits: int, device, bound_v=None, bound_i=None):
    """The scan's queue semantics in torch ops: each split runs the TPU
    grid's sequential loop over its n-tiles (score tile, strict prune test
    per m-tile, exact queue update); splits and m-tiles advance together.
    ``tile_scores(rows)`` gives the (M, S, bn) scores of the dataset rows
    ``rows`` (S, bn). With a bound, lanes past their query's (bound_v,
    bound_i) score +inf for the update (an (+inf, index) lane never
    displaces an empty (+inf, -1) slot, as in the kernel) and the prune
    test reads the smaller of the queue's worst value and bound_v."""
    m_tiles = m // bm
    tps = tiles_per_split(n_tiles, splits)
    buf_v = torch.full((m, splits, k), torch.inf, dtype=torch.float32, device=device)
    buf_i = torch.full((m, splits, k), -1, dtype=torch.int32, device=device)
    skips = torch.zeros((m_tiles, splits), dtype=torch.int32, device=device)
    lanes = torch.arange(bn, device=device)
    if bound_v is not None:
        # a +inf bound bounds nothing: the kernel keeps (+inf, -1) then
        bound_i = torch.where(torch.isfinite(bound_v), bound_i, -1)
        bv, bi = bound_v[:, None, None], bound_i[:, None, None]
    for t in range(tps):
        tile = torch.arange(splits, device=device) * tps + t  # (S,)
        live = tile < n_tiles
        rows = tile.clamp(max=n_tiles - 1)[:, None] * bn + lanes  # (S, bn)
        s = tile_scores(rows)
        idx = rows.to(torch.int32).expand(m, splits, bn)
        tile_w = buf_v[:, :, -1]
        if bound_v is not None:
            tile_w = torch.minimum(tile_w, bv[..., 0])
        if prune:
            prunable = torch.amin(s, dim=-1) > tile_w  # (M, S)
            skip = prunable.reshape(m_tiles, bm, splits).all(dim=1) & live
        else:
            skip = torch.zeros((m_tiles, splits), dtype=torch.bool, device=device)
        skips += skip.to(torch.int32)
        if bound_v is not None:
            s = torch.where((s > bv) | ((s == bv) & (idx > bi)), torch.inf, s)
        new_v, new_i = topk_smallest(torch.cat([buf_v, s], -1),
                                     torch.cat([buf_i, idx], -1), k)
        take = (live & ~skip).repeat_interleave(bm, dim=0)[:, :, None]
        buf_v = torch.where(take, new_v, buf_v)
        buf_i = torch.where(take, new_i, buf_i)
    return buf_v, buf_i, skips


def knn_scan_plain(q, x, qn, xn, k_eff: int, metric: str, bm: int, bn: int,
                   prune: bool = True, splits: int = 1, bound_v=None, bound_i=None):
    """``knn_scan`` in torch ops (see :func:`plain_queues`)."""
    _check(q, x, qn, xn, k_eff, metric, bm, bn)
    _check_bound(q, bound_v, bound_i)
    q32 = q.to(torch.float32)

    def scores(rows):
        cross = torch.matmul(q32, x[rows].to(torch.float32).transpose(1, 2))  # (S, M, bn)
        cross = cross.permute(1, 0, 2)  # (M, S, bn)
        xnt = xn[rows][None]  # (1, S, bn)
        if metric == "l2":
            s = torch.clamp_min(qn[:, None, None] - 2.0 * cross + xnt, 0.0)
        else:
            s = -cross
        return torch.where(torch.isfinite(xnt), s, torch.inf)

    return plain_queues(scores, q.shape[0], x.shape[0] // bn, k_eff, bm, bn, prune,
                         splits, q.device, bound_v, bound_i)


def knn_int8_scan_plain(q, x8, qn, scales, err, hn, q_len: int, bm: int, bn: int,
                        prune: bool = True, splits: int = 1):
    """``knn_int8_scan`` in torch ops: the epilogue of kernel_int8.py in its
    rounding order over the widened codes (see :func:`plain_queues`)."""
    _check_int8(q, x8, qn, scales, err, hn, q_len, bm, bn)
    n = x8.shape[0]

    def bounds(rows):
        codes = x8[rows.clamp(max=n - 1)].to(torch.float32)  # (S, bn, d)
        cross = torch.matmul(q, codes.transpose(1, 2)).permute(1, 0, 2)  # (M, S, bn)
        cross = cross * scales[rows][None]
        h = hn[rows][None]
        valid = torch.isfinite(h)
        d_hat = torch.clamp_min(qn[:, None, None] - 2.0 * cross + torch.where(valid, h, 0.0),
                                0.0)
        t = torch.clamp_min(sqrt_rn(d_hat) - err[rows][None], 0.0)
        return torch.where(valid, t * t, torch.inf)

    return plain_queues(bounds, q.shape[0], -(-n // bn), q_len, bm, bn, prune, splits,
                         q.device)


def knn_merge_plain(v, i):
    """(M, S, k) sorted queues -> (M, k) via ``tree_merge_sorted``."""
    out = tree_merge_sorted(v.transpose(0, 1), i.transpose(0, 1))
    return out.scores, out.indices


def knn_fused_plain(q, x, xn, k_eff: int, metric: str = "l2", bm: int = 16,
                    bn: int = 512, bd: int = 512, prune: bool = True):
    """The TPU kernel's semantics in torch ops on any device: one sequential
    queue per m-tile over all n-tiles in order (S = 1), so with the same
    blocks its skip count is the TPU kernel's."""
    if q.shape[1] % bd:
        raise ValueError(f"d={q.shape[1]} not a multiple of bd={bd}")
    qn = query_norms_sq(q)
    v, i, skips = knn_scan_plain(q, x, qn, xn, k_eff, metric, bm, bn, prune, 1)
    return v[:, 0], i[:, 0], skips
