// Fused exact kNN for sm_90a: a scan kernel that scores dataset tiles and
// folds them into per-block sorted top-k queues in shared memory (knn_scan,
// the counterpart of knn_pallas: f32 or bf16 rows, l2 / ip scores), and a
// merge kernel that reduces per-block queues (knn_merge, also for the int8
// scan of knn_int8.cu and topk_scan of topk.cu). The (M, N) score matrix
// never leaves the block. See repro_torch/kernels/knn/kernel.py for the
// design note.
//
// Plain C interface (loaded with ctypes): every pointer and the stream come
// in as void*, outputs and scratch are allocated by the caller, and each
// entry point returns cudaGetLastError() of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

#include "bitonic.cuh"
#include "tile.cuh"

namespace {

using rt::kChunk;
using rt::kDepth;
using rt::kStride;
using rt::kThreads;

// Shared memory of one scan block, in bytes (kernel.py mirrors this formula):
// tile values + indices, queue values + indices, the staged dataset slice
// (widened to f32) and the staged queries.
size_t scan_smem_bytes(int bm, int bn, int k) {
  return (size_t)bm * bn * 8 + (size_t)bm * k * 8 + (size_t)kChunk * kStride * 4 +
         (size_t)bm * kDepth * 4;
}

// Grid (m / BM, splits). Block (i, s) owns query rows [i·BM, (i+1)·BM) and
// the contiguous n-tiles [s·tiles_per_split, (s+1)·tiles_per_split). For each
// tile, in order: the (BM, bn) cross tile in f32 FMA (bf16 widened on load),
// the l2 / ip epilogue with +inf on rows whose norm is not finite, the strict
// prune test against the block's own queues, else a bitonic sort of each tile
// row and a queue update. Writes the block's sorted queues to
// out[(row·splits + s)·k + lane] and its skip count to skips[i·splits + s].
// Requires n_rows % bn == 0.
template <typename TQ, typename TX, int BM>
__global__ void __launch_bounds__(kThreads)
    knn_scan_kernel(const TQ* __restrict__ q, const TX* __restrict__ x,
                    const float* __restrict__ qn, const float* __restrict__ xn,
                    float* __restrict__ out_v, int* __restrict__ out_i,
                    int* __restrict__ skips, int n_rows, int dim, int k, int bn, int metric,
                    int prune, int tiles_per_split) {
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
  const int t_end = min(n_rows / bn, t_begin + tiles_per_split);

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
          rt::Vec<TX>::load(xchunk + (size_t)r * dim + d0 + c, v);
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
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        // l2: (qn - 2·cross) + xn, clamped at 0, rounded in that order
        const float s = metric == 0
                            ? fmaxf(__fadd_rn(__fsub_rn(qn[row0 + r], __fmul_rn(2.f, acc[r])), xnv), 0.f)
                            : -acc[r];
        tile_v[r * bn + col] = valid ? s : CUDART_INF_F;
        tile_i[r * bn + col] = n0 + col;
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

template <typename TQ, typename TX, int BM>
cudaError_t launch_scan(const void* q, const void* x, const void* qn, const void* xn,
                        void* out_v, void* out_i, void* skips, int m, int n_rows, int dim,
                        int k, int bn, int metric, int prune, int splits, int tiles_per_split,
                        cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(BM, bn, k);
  auto kernel = knn_scan_kernel<TQ, TX, BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(m / BM, splits), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TX*>(x), static_cast<const float*>(qn),
      static_cast<const float*>(xn), static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<int*>(skips), n_rows, dim, k, bn, metric, prune, tiles_per_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scan(int bm, const void* q, const void* x, const void* qn, const void* xn,
                          void* out_v, void* out_i, void* skips, int m, int n_rows, int dim,
                          int k, int bn, int metric, int prune, int splits,
                          int tiles_per_split, cudaStream_t stream) {
#define REPRO_SCAN_LAUNCH(BM)                                                                  \
  launch_scan<T, T, BM>(q, x, qn, xn, out_v, out_i, skips, m, n_rows, dim, k, bn, metric,     \
                        prune, splits, tiles_per_split, stream)
  cudaError_t err;
  switch (bm) {
    case 1:
      err = REPRO_SCAN_LAUNCH(1);
      break;
    case 2:
      err = REPRO_SCAN_LAUNCH(2);
      break;
    case 4:
      err = REPRO_SCAN_LAUNCH(4);
      break;
    case 8:
      err = REPRO_SCAN_LAUNCH(8);
      break;
    case 16:
      err = REPRO_SCAN_LAUNCH(16);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef REPRO_SCAN_LAUNCH
  return err;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_scan<__nv_bfloat16>(bm, q, x, qn, xn, out_v, out_i, skips, m, n, dim, k,
                                          bn, metric, prune, splits, tiles_per_split, st)
           : dispatch_scan<float>(bm, q, x, qn, xn, out_v, out_i, skips, m, n, dim, k, bn,
                                  metric, prune, splits, tiles_per_split, st);
  return static_cast<int>(err);
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
