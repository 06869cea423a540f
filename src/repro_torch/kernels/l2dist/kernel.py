"""Squared-L2 distance matrix on Hopper.

Replaces ``repro/kernels/l2dist/kernel.py::l2dist_pallas``
(``_l2dist_kernel``); the CUDA source is ``../csrc/l2dist.cu`` (with the
``cp.async`` helpers of ``../csrc/ring.cuh``).

What it computes, as the TPU kernel does: D[i, j] = max((acc + qn_i) + xn_j,
0) with acc = -2·<q_i, x_j> accumulated in f32 FMA, for f32 or bf16
operands (bf16 widened on load). The product is the kernel's own: no
library GEMM, no tensor cores, no TF32. On integer-valued data every sum is
exact, so the result is the plain version's bit for bit.

Design. One launch per call, any M and N (ragged edges masked, never
padded), d a multiple of 32 (``ops.l2dist`` pads it). The function needs
2·M·N·d FLOPs against 4·N·d bytes of x (2 in bf16) and 4·M·N of output, so
on this card (3.35 TB/s, 67 TFLOP/s f32 without tensor cores: a ridge of
20 FLOPs a byte) it is bound by bytes at small M and by FMAs at large M.
``l2dist_config`` picks one of two kernels by M:

- the stream kernel, M <= ``STREAM_MAX_M``: one wave of blocks (two an
  SM), each reading its own range of dataset rows once through a 3-stage
  ``cp.async`` ring of 32 KB stages and scoring them against up to 16
  queries in a register micro-tile (``knn_scan``'s scoring: each row
  element read once from shared memory, each query value a 16-byte
  broadcast), the scores written from registers, a warp's 32 columns of
  one query row at a time. Above 16 queries the blocks take the queries in
  tiles of 16, each reading x again. At bm <= 2, where it only streams,
  four threads share a row (``stream_split``), so a stage reads 512
  contiguous bytes of each of its rows rather than 128, and their partial
  sums meet by shuffles at the end of a chunk.
- the tiled kernel, larger M: 128 × 128 output tiles, both operands
  brought in 128-byte slices of their rows through a 3-stage ``cp.async``
  ring, each thread an 8 × 8 outer product (256 FMAs for 16 loads of 16
  bytes), so x is read M/128 times. The rows stay d-contiguous in shared
  memory, as the copies bring them, and each thread reads 4 consecutive
  features of each of its rows and queries: the same loads per FMA as a
  d-major layout, without a transpose on the way in. Blocks walk the
  n-tiles in groups of 8 m-tiles, so one tile of x serves its group from
  L2. M goes on the one grid axis with N, so M has no limit of its own.

The crossover: up to five 16-query tiles, reading x five times, the stream
kernel is faster than one 128-query tile that is mostly padding
(``chip_smoke.py`` times both kernels at M = 16 to 128 in its kernels
phase).

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.partition import next_pow2, round_up
from repro_torch.kernels.knn.kernel import (
    _DEPTH,
    LAUNCHES,
    _check_cuda,
    _raise_on,
    on_card,
)

#: Largest batch the stream kernel takes; above it the tiled kernel runs.
STREAM_MAX_M = 80
_STAGES = 3  # ring stages of either kernel (kStages)
_STAGE_BYTES = 32_768  # stream: dataset rows of one stage (kStageBytes)
_QUERY_BYTES = 256  # stream: room per f32 query row in a stage (kQueryBytes)
_STREAM_BM = 16  # stream: most queries a block scores
_STREAM_BLOCKS_PER_SM = 2
_SPLIT_BM, _SPLIT = 2, 4  # stream: at bm <= 2, threads sharing a row (split_of)
_SPAN_ALIGN = 32  # stream: a block's rows start on a warp's 128-byte line
_TILE_M, _TILE_N = 128, 128  # tiled: queries and dataset rows of a block (kTileM, kTileN)
_LINE = 128  # tiled: bytes of a row in a stage (kLine)
_GRID_MAX = 2**31 - 1


class L2distConfig(NamedTuple):
    """One launch of ``l2dist``: the kernel (``path``), the queries and
    dataset rows a block covers, its grid and its shared memory."""
    path: str  # "stream" or "tiled"
    bm: int  # queries per block
    span: int  # dataset rows per block
    grid: tuple[int, int]
    smem: int  # bytes of shared memory per block


def stream_split(bm: int) -> int:
    """Threads of the stream kernel that share a dataset row (``split_of``
    in l2dist.cu): four where it only streams (bm <= 2), so a stage reads
    512 contiguous bytes of a row; else one."""
    return _SPLIT if bm <= _SPLIT_BM else 1


def l2dist_smem_bytes(stage_bytes: int, bm: int, query_bytes: int) -> int:
    """Shared memory of one block (``l2dist_smem_bytes`` in l2dist.cu):
    three ring stages of ``stage_bytes`` of dataset rows and ``bm`` query
    rows of ``query_bytes``, and 64 bytes of query norms."""
    return _STAGES * (stage_bytes + bm * query_bytes) + 64


@functools.lru_cache(maxsize=256)
def l2dist_config(m: int, n: int, d: int, dtype=torch.float32, sms: int = 132,
                  path: str | None = None) -> L2distConfig:
    """The launch for an (m, d) × (n, d) call on a card of ``sms`` SMs: the
    stream kernel up to ``STREAM_MAX_M`` queries, else the tiled one
    (``path`` forces one). The stream grid is one wave of two blocks an SM
    over the query tiles, each block a range of rows a multiple of 32; the
    tiled grid is every 128 × 128 output tile. d (a positive multiple of
    32) and the dtype do not change the launch: the kernels stage 128 bytes
    of a row per slice in either dtype."""
    if m < 1 or n < 1 or d < 1 or d % _DEPTH:
        raise ValueError(f"m={m}, n={n} must be positive and d={d} a positive multiple "
                         f"of {_DEPTH}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be f32 or bf16, got {dtype}")
    path = path or ("stream" if m <= STREAM_MAX_M else "tiled")
    if path == "stream":
        bm = min(_STREAM_BM, next_pow2(m))
        m_tiles = -(-m // bm)
        if m_tiles > 65535:
            raise ValueError(f"M={m} exceeds the stream kernel's {65535 * bm} rows")
        blocks = max(1, _STREAM_BLOCKS_PER_SM * sms // m_tiles)
        span = round_up(-(-n // blocks), _SPAN_ALIGN)
        smem = l2dist_smem_bytes(_STAGE_BYTES, bm, _QUERY_BYTES * stream_split(bm))
        return L2distConfig("stream", bm, span, (-(-n // span), m_tiles), smem)
    if path != "tiled":
        raise ValueError(f"path must be 'stream' or 'tiled', got {path!r}")
    blocks = -(-m // _TILE_M) * -(-n // _TILE_N)
    if blocks > _GRID_MAX:
        raise ValueError(f"({m}, {n}) needs {blocks} tiles, more than a grid's {_GRID_MAX}")
    return L2distConfig("tiled", _TILE_M, _TILE_N, (blocks, 1),
                        l2dist_smem_bytes(_TILE_N * _LINE, _TILE_M, _LINE))


def _check(q, x, qn, xn):
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and x {tuple(x.shape)} must be (M, d), (N, d)")
    if q.dtype != x.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q and x must both be f32 or both bf16, got {q.dtype}, {x.dtype}")
    for name, t, rows in (("qn", qn, q.shape[0]), ("xn", xn, x.shape[0])):
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 of shape ({rows},), got {t.dtype} "
                             f"{tuple(t.shape)}")


def l2dist_tiles(q, x, qn, xn):
    """(M, d) x (N, d) -> (M, N) f32 squared L2 from the given f32 row norms
    qn (M,) and xn (N,)."""
    _check(q, x, qn, xn)
    if q.device.type == "cpu":
        return l2dist_plain(q, x, qn, xn)
    return _launch(q, x, qn, xn, l2dist_config(q.shape[0], x.shape[0], q.shape[1], q.dtype,
                                               _sm_count(q.device.index)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def l2dist_launch(q, x, qn, xn, config: L2distConfig):
    """One launch of the kernel ``config`` names on CUDA tensors (the
    config of :func:`l2dist_config` for these shapes, any path)."""
    _check(q, x, qn, xn)
    return _launch(q, x, qn, xn, config)


def _launch(q, x, qn, xn, config: L2distConfig):
    _check_cuda(q, x, qn, xn)
    m, n, d = q.shape[0], x.shape[0], q.shape[1]
    if d % _DEPTH:
        raise ValueError(f"d={d} must be a multiple of {_DEPTH}")
    from repro_torch.kernels.build import load_library

    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    with on_card(q.device):
        rc = load_library().l2dist(
            q.data_ptr(), x.data_ptr(), qn.data_ptr(), xn.data_ptr(), out.data_ptr(), m, n, d,
            int(config.path == "tiled"), config.bm, config.grid[0], config.span,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "l2dist")
    LAUNCHES["l2dist"] += 1
    return out


def l2dist_plain(q, x, qn, xn):
    """The kernel's function in torch ops, rounded in its order:
    max((-2·cross + qn) + xn, 0)."""
    _check(q, x, qn, xn)
    acc = -2.0 * (q.to(torch.float32) @ x.to(torch.float32).T)
    return torch.clamp_min((acc + qn[:, None]) + xn[None, :], 0.0)
