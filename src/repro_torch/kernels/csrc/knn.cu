// Fused exact kNN for sm_90a: scan kernels that score dataset tiles and fold
// them into per-block sorted top-k queues in shared memory, and a merge kernel
// that reduces the per-block queues. The (M, N) score matrix never leaves the
// block. One templated scan serves both TPU kernels it replaces: knn_scan
// (knn_pallas: f32 or bf16 rows, l2 / ip scores) and knn_int8_scan
// (knn_pallas_int8: int8 codes read at 1 B/element, certified lower bounds
// into a q_len-wide queue). See repro_torch/kernels/knn/kernel.py for the
// design note.
//
// Plain C interface (loaded with ctypes): every pointer and the stream come
// in as void*, outputs and scratch are allocated by the caller, and each
// entry point returns cudaGetLastError() of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "tile.cuh"

namespace {

using rt::kChunk;
using rt::kDepth;
using rt::kStride;
using rt::kThreads;

// Shared memory of one scan block, in bytes (kernel.py mirrors this formula):
// tile values + indices, queue values + indices, the staged dataset slice
// (widened to f32, so the int8 scan takes the same) and the staged queries.
size_t scan_smem_bytes(int bm, int bn, int k) {
  return (size_t)bm * bn * 8 + (size_t)bm * k * 8 + (size_t)kChunk * kStride * 4 +
         (size_t)bm * kDepth * 4;
}

// The tile epilogue: kScores for knn_scan (l2 or ip, chosen by `metric`),
// kInt8Bound for knn_int8_scan (the certified lower bound).
enum Epilogue { kScores = 0, kInt8Bound = 1 };

// Grid (m / BM, splits). Block (i, s) owns query rows [i·BM, (i+1)·BM) and
// the contiguous n-tiles [s·tiles_per_split, (s+1)·tiles_per_split). For each
// tile, in order: the (BM, bn) cross tile in f32 FMA (bf16 and int8 widened on
// load), the epilogue with +inf on invalid rows, the strict prune test against
// the block's own queues, else a bitonic sort of each tile row and a queue
// update. Writes the block's sorted queues to out[(row·splits + s)·k + lane]
// and its skip count to skips[i·splits + s].
//
// kScores: xn is the dataset norms; scales and err are unused; n_rows % bn == 0.
// kInt8Bound: xn is hn (the exact quantised norm, +inf on invalid rows),
// scales the per-row code scale and err the per-row error bound, all three
// over ceil(n_rows / bn)·bn rows; x covers n_rows, and rows past it read as
// zeros. Everything the int8 scan adds is resolved at compile time, so the
// f32 and bf16 instantiations are the plain f32 scan.
template <typename TQ, typename TX, int BM, int EPI>
__global__ void __launch_bounds__(kThreads)
    knn_scan_kernel(const TQ* __restrict__ q, const TX* __restrict__ x,
                    const float* __restrict__ qn, const float* __restrict__ xn,
                    const float* __restrict__ scales, const float* __restrict__ err,
                    float* __restrict__ out_v, int* __restrict__ out_i,
                    int* __restrict__ skips, int n_rows, int dim, int k, int bn, int metric,
                    int prune, int tiles_per_split) {
  constexpr bool kRagged = EPI == kInt8Bound;
  constexpr int kN = rt::Vec<TX>::kN, kPer = kDepth / kN;
  extern __shared__ float smem[];
  float* tile_v = smem;
  int* tile_i = reinterpret_cast<int*>(tile_v + BM * bn);
  float* queue_v = reinterpret_cast<float*>(tile_i + BM * bn);
  int* queue_i = reinterpret_cast<int*>(queue_v + BM * k);
  float* xs = reinterpret_cast<float*>(queue_i + BM * k);
  float* qs = xs + kChunk * kStride;

  const int tid = threadIdx.x;
  const int m_tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int row0 = m_tile * BM;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(kRagged ? (n_rows + bn - 1) / bn : n_rows / bn,
                        t_begin + tiles_per_split);

  for (int e = tid; e < BM * k; e += kThreads) {
    queue_v[e] = CUDART_INF_F;
    queue_i[e] = -1;
  }
  __syncthreads();

  int skipped = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * bn;
    for (int c0 = 0; c0 < bn; c0 += kChunk) {
      float acc[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = 0.f;
      const TX* xchunk = x + (size_t)(n0 + c0) * dim;
      for (int d0 = 0; d0 < dim; d0 += kDepth) {
        // stage x[chunk rows, d0 : d0 + kDepth]: kPer threads per row slice
#pragma unroll
        for (int p = 0; p < kChunk * kPer / kThreads; ++p) {
          const int e = p * kThreads + tid;
          const int r = e / kPer, c = (e % kPer) * kN;
          float v[kN];
          if (!kRagged || n0 + c0 + r < n_rows) {
            rt::Vec<TX>::load(xchunk + (size_t)r * dim + d0 + c, v);
          } else {
#pragma unroll
            for (int j = 0; j < kN; ++j) v[j] = 0.f;
          }
          float* dst = xs + r * kStride + c;
#pragma unroll
          for (int j = 0; j < kN; ++j) dst[j] = v[j];
        }
        for (int e = tid; e < BM * kDepth; e += kThreads)
          qs[e] = rt::to_f32(q[(size_t)(row0 + e / kDepth) * dim + d0 + e % kDepth]);
        __syncthreads();
        const float* xr = xs + tid * kStride;
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
          const float xv = xr[kk];
#pragma unroll
          for (int r = 0; r < BM; ++r) acc[r] = fmaf(qs[r * kDepth + kk], xv, acc[r]);
        }
        __syncthreads();
      }
      const int col = c0 + tid;
      const float xnv = xn[n0 + col];
      const bool valid = isfinite(xnv);
      if constexpr (EPI == kScores) {
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          // l2: (qn - 2·cross) + xn, clamped at 0, rounded in that order
          const float s = metric == 0
                              ? fmaxf(__fadd_rn(__fsub_rn(qn[row0 + r], __fmul_rn(2.f, acc[r])), xnv), 0.f)
                              : -acc[r];
          tile_v[r * bn + col] = valid ? s : CUDART_INF_F;
          tile_i[r * bn + col] = n0 + col;
        }
      } else {
        // kernel_int8.py's epilogue, rounded in its order: cross = acc·scale,
        // d_hat = max((qn - 2·cross) + hn, 0), lower = max(sqrt(d_hat) - err, 0)²
        const float sc = scales[n0 + col], er = err[n0 + col];
        const float hn = valid ? xnv : 0.f;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float cross = __fmul_rn(acc[r], sc);
          const float d_hat =
              fmaxf(__fadd_rn(__fsub_rn(qn[row0 + r], __fmul_rn(2.f, cross)), hn), 0.f);
          const float t = fmaxf(__fsub_rn(__fsqrt_rn(d_hat), er), 0.f);
          tile_v[r * bn + col] = valid ? __fmul_rn(t, t) : CUDART_INF_F;
          tile_i[r * bn + col] = n0 + col;
        }
      }
    }
    __syncthreads();
    if (prune && rt::tile_prunable(tile_v, bn, queue_v, k, BM)) {
      ++skipped;
      continue;
    }
    rt::bitonic_sort_rows(tile_v, tile_i, BM, bn, bn);
    rt::topk_update_rows(queue_v, queue_i, k, tile_v, tile_i, bn, BM, k);
  }

  for (int e = tid; e < BM * k; e += kThreads) {
    const int r = e / k, l = e - r * k;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k + l;
    out_v[o] = queue_v[e];
    out_i[o] = queue_i[e];
  }
  if (tid == 0) skips[m_tile * splits + split] = skipped;
}

// Grid (m, ceil(splits / group)). Block (row, g) merges the sorted queues
// [g·group, (g+1)·group) of one query row into one sorted queue, the k
// smallest pairs of their union, written to out[(row·gridDim.y + g)·k + lane].
__global__ void __launch_bounds__(kThreads)
    knn_merge_kernel(const float* __restrict__ in_v, const int* __restrict__ in_i,
                     float* __restrict__ out_v, int* __restrict__ out_i, int splits,
                     int group, int k) {
  extern __shared__ float smem[];
  float* buf_v = smem;
  int* buf_i = reinterpret_cast<int*>(buf_v + k);
  float* cand_v = reinterpret_cast<float*>(buf_i + k);
  int* cand_i = reinterpret_cast<int*>(cand_v + k);

  const int row = blockIdx.x, g = blockIdx.y;
  const int s0 = g * group, s1 = min(splits, s0 + group);
  const float* src_v = in_v + (size_t)row * splits * k;
  const int* src_i = in_i + (size_t)row * splits * k;
  for (int l = threadIdx.x; l < k; l += kThreads) {
    buf_v[l] = src_v[(size_t)s0 * k + l];
    buf_i[l] = src_i[(size_t)s0 * k + l];
  }
  for (int s = s0 + 1; s < s1; ++s) {
    for (int l = threadIdx.x; l < k; l += kThreads) {
      cand_v[l] = src_v[(size_t)s * k + l];
      cand_i[l] = src_i[(size_t)s * k + l];
    }
    __syncthreads();
    rt::topk_update_rows(buf_v, buf_i, k, cand_v, cand_i, k, 1, k);
  }
  const size_t o = ((size_t)row * gridDim.y + g) * k;
  for (int l = threadIdx.x; l < k; l += kThreads) {
    out_v[o + l] = buf_v[l];
    out_i[o + l] = buf_i[l];
  }
}

// Everything a scan launch passes to the kernel, in its parameter order.
struct ScanArgs {
  const void *q, *x, *qn, *xn, *scales, *err;
  void *out_v, *out_i, *skips;
  int n_rows, dim, k, bn, metric, prune, tiles_per_split;
};

template <typename TQ, typename TX, int BM, int EPI>
cudaError_t launch_scan(const ScanArgs& a, int m, int splits, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(BM, a.bn, a.k);
  auto kernel = knn_scan_kernel<TQ, TX, BM, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(m / BM, splits), kThreads, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TX*>(a.x),
      static_cast<const float*>(a.qn), static_cast<const float*>(a.xn),
      static_cast<const float*>(a.scales), static_cast<const float*>(a.err),
      static_cast<float*>(a.out_v), static_cast<int*>(a.out_i), static_cast<int*>(a.skips),
      a.n_rows, a.dim, a.k, a.bn, a.metric, a.prune, a.tiles_per_split);
  return cudaGetLastError();
}

template <typename TQ, typename TX, int EPI>
cudaError_t dispatch_scan(int bm, const ScanArgs& a, int m, int splits, cudaStream_t stream) {
  switch (bm) {
    case 1:
      return launch_scan<TQ, TX, 1, EPI>(a, m, splits, stream);
    case 2:
      return launch_scan<TQ, TX, 2, EPI>(a, m, splits, stream);
    case 4:
      return launch_scan<TQ, TX, 4, EPI>(a, m, splits, stream);
    case 8:
      return launch_scan<TQ, TX, 8, EPI>(a, m, splits, stream);
    case 16:
      return launch_scan<TQ, TX, 16, EPI>(a, m, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (m, dim), x (n, dim): both f32 (bf16 = 0) or both bf16 (bf16 = 1);
// qn (m,), xn (n,) f32; out_v / out_i (m, splits, k); skips (m / bm, splits).
// metric 0 = l2, 1 = ip. Requires m % bm == 0, n % bn == 0, dim % 32 == 0,
// bn % 256 == 0, k a power of two <= bn, bm in {1, 2, 4, 8, 16}.
int knn_scan(const void* q, const void* x, const void* qn, const void* xn, void* out_v,
             void* out_i, void* skips, int m, int n, int dim, int k, int bm, int bn,
             int metric, int prune, int splits, int tiles_per_split, int bf16,
             void* stream) {
  const ScanArgs a{q, x, qn, xn, nullptr, nullptr, out_v, out_i, skips,
                   n, dim, k, bn, metric, prune, tiles_per_split};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_scan<__nv_bfloat16, __nv_bfloat16, kScores>(bm, a, m, splits, st)
           : dispatch_scan<float, float, kScores>(bm, a, m, splits, st);
  return static_cast<int>(err);
}

// The int8 candidate scan (kernel_int8.py): q (m, dim) f32, x8 (n, dim) int8
// codes; qn (m,); scales, err, hn (ceil(n / bn)·bn,) f32, hn +inf on invalid
// rows (padding included); out_v / out_i (m, splits, q_len) sorted lower
// bounds and indices; skips (m / bm, splits). Requires m % bm == 0,
// dim % 32 == 0, bn % 256 == 0, q_len a power of two <= bn, bm in
// {1, 2, 4, 8, 16}. n need not be a multiple of bn.
int knn_int8_scan(const void* q, const void* x8, const void* qn, const void* scales,
                  const void* err, const void* hn, void* out_v, void* out_i, void* skips,
                  int m, int n, int dim, int q_len, int bm, int bn, int prune, int splits,
                  int tiles_per_split, void* stream) {
  const ScanArgs a{q, x8, qn, hn, scales, err, out_v, out_i, skips,
                   n, dim, q_len, bn, 0, prune, tiles_per_split};
  return static_cast<int>(dispatch_scan<float, int8_t, kInt8Bound>(
      bm, a, m, splits, static_cast<cudaStream_t>(stream)));
}

// in_v / in_i (m, splits, k) sorted queues -> out_v / out_i
// (m, ceil(splits / group), k); k a power of two.
int knn_merge(const void* in_v, const void* in_i, void* out_v, void* out_i, int m,
              int splits, int group, int k, void* stream) {
  const size_t smem = (size_t)k * 16;
  cudaError_t err = cudaFuncSetAttribute(
      knn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m, (splits + group - 1) / group);
  knn_merge_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_v), static_cast<const int*>(in_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), splits, group, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
