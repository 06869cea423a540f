// Streaming top-k over a score matrix for sm_90a, the counterpart of
// repro/kernels/topk/kernel.py::topk_pallas (_topk_kernel): each block
// streams one row's range of scores from device memory with coalesced loads
// (16 bytes a thread where the row allows), filters every batch in registers
// against its sorted queue through select.cuh, and keeps only the queue and
// a survivor buffer in shared memory; knn_merge (knn.cu) reduces the
// per-block queues. See repro_torch/kernels/topk/kernel.py for the design
// note.
//
// Plain C interface (loaded with ctypes), as knn.cu.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                  // scores a thread holds per batch
constexpr int kBatch = kThreads * kPer;   // columns a block filters per batch

// Shared memory of one block, in bytes (topk/kernel.py mirrors this formula):
// bookkeeping, the two queue buffers, and the survivor buffer (value,
// index).
size_t topk_smem_bytes(int k, int cap) {
  return (size_t)rt::kSelectBookBytes + (size_t)k * 16 + (size_t)cap * 8;
}

// This thread's kPer scores of the batch at column c0 of `row`, and their
// column ids. kVec: four float4 loads at c0 + 4·(t + 256·u) (n % 4 == 0);
// otherwise sixteen scalar loads at c0 + t + 256·p. Columns at or past
// c_end are not read.
template <bool kVec>
__device__ __forceinline__ void load_batch(const float* __restrict__ row, int c0, int c_end,
                                           float (&v)[1][kPer], int (&col)[kPer]) {
  const int t = threadIdx.x;
  if constexpr (kVec) {
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
      const int c = c0 + 4 * (t + kThreads * u);
      float4 f = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
      if (c < c_end) f = __ldg(reinterpret_cast<const float4*>(row + c));
      v[0][4 * u] = f.x;
      v[0][4 * u + 1] = f.y;
      v[0][4 * u + 2] = f.z;
      v[0][4 * u + 3] = f.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) col[4 * u + e] = c + e;
    }
  } else {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = c0 + t + kThreads * p;
      v[0][p] = c < c_end ? __ldg(row + c) : CUDART_INF_F;
      col[p] = c;
    }
  }
}

// Grid (m, splits). Block (row, s) owns columns [s·tps·bn, min(n,
// (s+1)·tps·bn)) of one row. Batches of kBatch columns are loaded one ahead
// of the one being filtered; each goes through select_into_queues against
// the row's queue (two buffers of k pairs in shared memory). Writes the
// sorted queue to out[(row·splits + s)·k + lane] and, when stats is not
// null, the selection counters to stats[(row·splits + s)·4 + c].
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    topk_scan_kernel(const float* __restrict__ scores, float* __restrict__ out_v,
                     int* __restrict__ out_i, unsigned* __restrict__ stats, int n, int k,
                     int bn, int tiles_per_split, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qv = reinterpret_cast<float*>(smem + rt::kSelectBookBytes);
  int* qi = reinterpret_cast<int*>(qv + 2 * k);
  const rt::Survivors s = rt::carve_survivors<1>(smem, qi + 2 * k, cap);
  const rt::Queues q{{qv, qv + k}, {qi, qi + k}, 0, k};

  const int row = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const long long span = (long long)tiles_per_split * bn;
  const int c_begin = (int)(split * span);
  const int c_end = (int)min((long long)n, (split + 1) * span);
  const float* src = scores + (size_t)row * n;

  float nxt[1][kPer], cur[1][kPer];
  int ncol[kPer], col[kPer];
  load_batch<kVec>(src, c_begin, c_end, nxt, ncol);
  for (int c0 = c_begin; c0 < c_end; c0 += kBatch) {
    uint64_t pending = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      cur[0][p] = nxt[0][p];
      col[p] = ncol[p];
      if (col[p] < c_end) pending |= 1ull << p;
    }
    if (c0 + kBatch < c_end) load_batch<kVec>(src, c0 + kBatch, c_end, nxt, ncol);
    rt::select_into_queues<1, kPer>(cur, col, pending, s, q);
  }
  const size_t o = ((size_t)row * splits + split) * k;
  rt::write_queues<1>(s, q, out_v + o, out_i + o, 0);
  if (stats != nullptr && threadIdx.x < 4)
    stats[((size_t)row * splits + split) * 4 + threadIdx.x] = s.stats[threadIdx.x];
}

template <bool kVec>
cudaError_t launch_topk(const float* scores, float* out_v, int* out_i, unsigned* stats, int m,
                        int n, int k, int bn, int splits, int tiles_per_split, int cap,
                        cudaStream_t stream) {
  const size_t smem = topk_smem_bytes(k, cap);
  cudaError_t err = cudaFuncSetAttribute(topk_scan_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_scan_kernel<kVec><<<dim3(m, splits), kThreads, smem, stream>>>(
      scores, out_v, out_i, stats, n, k, bn, tiles_per_split, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scores (m, n) f32, row-major; out_v / out_i (m, splits, k) sorted queues of
// the k smallest (value, index) pairs of each split's range; stats null or
// (m, splits, 4) u32. Requires k a power of two, bn a multiple of 256, cap a
// power of two; scores 16-byte aligned. Neither m nor n need be a multiple
// of a block.
int topk_scan(const void* scores, void* out_v, void* out_i, void* stats, int m, int n, int k,
              int bn, int splits, int tiles_per_split, int cap, void* stream) {
  const float* s = static_cast<const float*>(scores);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  unsigned* st = static_cast<unsigned*>(stats);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n % 4 == 0 ? launch_topk<true>(s, ov, oi, st, m, n, k, bn, splits, tiles_per_split, cap, cs)
                 : launch_topk<false>(s, ov, oi, st, m, n, k, bn, splits, tiles_per_split, cap,
                                      cs);
  return static_cast<int>(err);
}

}  // extern "C"
