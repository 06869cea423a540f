// Streaming top-k over a score matrix for sm_90a, the counterpart of
// repro/kernels/topk/kernel.py::topk_pallas (_topk_kernel): each block sorts
// (BM, bn) tiles of the scores read from device memory and folds them into
// sorted per-query queues in shared memory, with no pruning; knn_merge
// (knn.cu) reduces the per-block queues. See repro_torch/kernels/topk/kernel.py
// for the design note.
//
// Plain C interface (loaded with ctypes), as knn.cu.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

#include "bitonic.cuh"
#include "tile.cuh"

namespace {

using rt::kThreads;

// Shared memory of one block, in bytes (topk/kernel.py mirrors this formula):
// tile values + indices and queue values + indices.
size_t topk_smem_bytes(int bm, int bn, int k) {
  return (size_t)bm * bn * 8 + (size_t)bm * k * 8;
}

// Grid (ceil(m / BM), splits). Block (i, s) owns query rows [i·BM, (i+1)·BM)
// and the n-tiles [s·tiles_per_split, (s+1)·tiles_per_split). Each tile is
// loaded row by row (coalesced), lanes past n or rows past m as +inf, sorted
// per row, and merged into the row's queue. Writes the sorted queues of rows
// below m to out[(row·splits + s)·k + lane].
template <int BM>
__global__ void __launch_bounds__(kThreads)
    topk_scan_kernel(const float* __restrict__ scores, float* __restrict__ out_v,
                     int* __restrict__ out_i, int m, int n, int k, int bn,
                     int tiles_per_split) {
  extern __shared__ float smem[];
  float* tile_v = smem;
  int* tile_i = reinterpret_cast<int*>(tile_v + BM * bn);
  float* queue_v = reinterpret_cast<float*>(tile_i + BM * bn);
  int* queue_i = reinterpret_cast<int*>(queue_v + BM * k);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM, split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (n + bn - 1) / bn;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int lg_bn = __ffs(bn) - 1;

  for (int e = tid; e < BM * k; e += kThreads) {
    queue_v[e] = CUDART_INF_F;
    queue_i[e] = -1;
  }
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * bn;
    for (int e = tid; e < BM * bn; e += kThreads) {
      const int row = row0 + (e >> lg_bn), col = n0 + (e & (bn - 1));
      tile_v[e] = row < m && col < n ? scores[(size_t)row * n + col] : CUDART_INF_F;
      tile_i[e] = col;
    }
    __syncthreads();
    rt::bitonic_sort_rows(tile_v, tile_i, BM, bn, bn);
    rt::topk_update_rows(queue_v, queue_i, k, tile_v, tile_i, bn, BM, k);
  }
  __syncthreads();
  for (int e = tid; e < BM * k; e += kThreads) {
    const int r = e / k, l = e - r * k;
    if (row0 + r >= m) break;
    const size_t o = ((size_t)(row0 + r) * splits + split) * k + l;
    out_v[o] = queue_v[e];
    out_i[o] = queue_i[e];
  }
}

template <int BM>
cudaError_t launch_topk(const float* scores, float* out_v, int* out_i, int m, int n, int k,
                        int bn, int splits, int tiles_per_split, cudaStream_t stream) {
  const size_t smem = topk_smem_bytes(BM, bn, k);
  cudaError_t err = cudaFuncSetAttribute(topk_scan_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_scan_kernel<BM><<<dim3((m + BM - 1) / BM, splits), kThreads, smem, stream>>>(
      scores, out_v, out_i, m, n, k, bn, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scores (m, n) f32, row-major; out_v / out_i (m, splits, k) sorted queues of
// the k smallest (value, index) pairs of each split's range. Requires k a
// power of two <= bn, bn a power of two >= 256, bm in {1, 2, 4, 8, 16}.
// Neither m nor n need be a multiple of its block.
int topk_scan(const void* scores, void* out_v, void* out_i, int m, int n, int k, int bm,
              int bn, int splits, int tiles_per_split, void* stream) {
  const float* s = static_cast<const float*>(scores);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bm) {
    case 1:
      err = launch_topk<1>(s, ov, oi, m, n, k, bn, splits, tiles_per_split, st);
      break;
    case 2:
      err = launch_topk<2>(s, ov, oi, m, n, k, bn, splits, tiles_per_split, st);
      break;
    case 4:
      err = launch_topk<4>(s, ov, oi, m, n, k, bn, splits, tiles_per_split, st);
      break;
    case 8:
      err = launch_topk<8>(s, ov, oi, m, n, k, bn, splits, tiles_per_split, st);
      break;
    case 16:
      err = launch_topk<16>(s, ov, oi, m, n, k, bn, splits, tiles_per_split, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
