// Tiled squared-L2 distance matrix for sm_90a, the counterpart of
// repro/kernels/l2dist/kernel.py::l2dist_pallas (_l2dist_kernel): each block
// computes a (BM, 256) tile of D[i, j] = max((-2·<q_i, x_j> + qn_i) + xn_j, 0)
// in f32 FMA (bf16 widened on load; no tensor cores, no TF32), staging
// 32-feature slices of its 256 dataset rows and BM queries in shared memory.
// See repro_torch/kernels/l2dist/kernel.py for the design note.
//
// Plain C interface (loaded with ctypes), as knn.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tile.cuh"

namespace {

using rt::kChunk;
using rt::kDepth;
using rt::kStride;
using rt::kThreads;

// Grid (ceil(n / 256), ceil(m / BM)): both axes parallel, as on the TPU.
// Thread t owns dataset row blockIdx.x·256 + t and accumulates its BM dot
// products over the whole dim; the epilogue rounds (acc·-2 + qn) + xn in the
// reference's order, then clamps at 0. Rows past m and columns past n are
// neither read nor written.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    l2dist_kernel(const T* __restrict__ q, const T* __restrict__ x, const float* __restrict__ qn,
                  const float* __restrict__ xn, float* __restrict__ out, int m, int n, int dim) {
  __shared__ float xs[kChunk * kStride];
  __shared__ float qs[BM * kDepth];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kChunk;
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  for (int d0 = 0; d0 < dim; d0 += kDepth) {
    rt::stage_rows<T>(x, dim, d0, col0, n, xs);
    rt::stage_queries<T>(q, dim, d0, row0, BM, m, qs);
    __syncthreads();
    const float* xr = xs + threadIdx.x * kStride;
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float xv = xr[kk];
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] = fmaf(qs[r * kDepth + kk], xv, acc[r]);
    }
    __syncthreads();
  }
  const int col = col0 + threadIdx.x;
  if (col >= n) return;
  const float xnv = xn[col];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (row0 + r < m) {
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(-2.f, acc[r]), qn[row0 + r]), xnv);
      out[(size_t)(row0 + r) * n + col] = fmaxf(s, 0.f);
    }
  }
}

template <typename T, int BM>
cudaError_t launch_l2dist(const void* q, const void* x, const void* qn, const void* xn,
                          void* out, int m, int n, int dim, cudaStream_t stream) {
  const dim3 grid((n + kChunk - 1) / kChunk, (m + BM - 1) / BM);
  l2dist_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<const float*>(qn),
      static_cast<const float*>(xn), static_cast<float*>(out), m, n, dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_l2dist(int bm, const void* q, const void* x, const void* qn,
                            const void* xn, void* out, int m, int n, int dim,
                            cudaStream_t stream) {
  switch (bm) {
    case 1:
      return launch_l2dist<T, 1>(q, x, qn, xn, out, m, n, dim, stream);
    case 2:
      return launch_l2dist<T, 2>(q, x, qn, xn, out, m, n, dim, stream);
    case 4:
      return launch_l2dist<T, 4>(q, x, qn, xn, out, m, n, dim, stream);
    case 8:
      return launch_l2dist<T, 8>(q, x, qn, xn, out, m, n, dim, stream);
    case 16:
      return launch_l2dist<T, 16>(q, x, qn, xn, out, m, n, dim, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (m, dim), x (n, dim): both f32 (bf16 = 0) or both bf16 (bf16 = 1);
// qn (m,), xn (n,) f32; out (m, n) f32. Requires dim % 32 == 0 and bm in
// {1, 2, 4, 8, 16}; m and n may be anything >= 1 (at most 65535·bm rows).
int l2dist(const void* q, const void* x, const void* qn, const void* xn, void* out, int m,
           int n, int dim, int bm, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_l2dist<__nv_bfloat16>(bm, q, x, qn, xn, out, m, n, dim, st)
           : dispatch_l2dist<float>(bm, q, x, qn, xn, out, m, n, dim, st);
  return static_cast<int>(err);
}

}  // extern "C"
