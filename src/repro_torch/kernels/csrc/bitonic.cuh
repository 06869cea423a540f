// Bitonic compare-exchange networks over rows of (value, index) pairs in
// shared memory — the device side of repro_torch/kernels/bitonic.py.
//
// Comparisons are lexicographic on (value, index), so exact score ties break
// to the smaller index; float `<` and `==` already treat -0.0 as +0.0. Every
// function is called by all threads of the block, works on `rows` rows of
// `L` lanes (L a power of two) at `stride` floats apart, and returns with the
// block synchronised.
#pragma once

#include <math_constants.h>

namespace rt {

__device__ __forceinline__ bool pair_less(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

// Lanes a < b of one row: afterwards lane a holds the smaller pair when
// `ascending`, the larger otherwise.
__device__ __forceinline__ void compare_exchange(float* v, int* ix, int a, int b,
                                                 bool ascending) {
  const float va = v[a], vb = v[b];
  const int ia = ix[a], ib = ix[b];
  const bool swap = ascending ? pair_less(vb, ib, va, ia) : pair_less(va, ia, vb, ib);
  if (swap) {
    v[a] = vb;
    v[b] = va;
    ix[a] = ib;
    ix[b] = ia;
  }
}

// Lower lane of the p-th pair of a stage at distance s (s a power of two):
// p with a zero bit inserted at bit position log2(s).
__device__ __forceinline__ int lower_lane(int p, int s) {
  return ((p & ~(s - 1)) << 1) | (p & (s - 1));
}

// Full ascending sort of each row: log2(L)·(log2(L)+1)/2 stages.
__device__ inline void bitonic_sort_rows(float* v, int* ix, int rows, int L, int stride) {
  const int half = L >> 1;
  if (half == 0) return;
  const int lg = __ffs(half) - 1;
  const int total = rows * half;
  for (int k = 2; k <= L; k <<= 1) {
    for (int s = k >> 1; s > 0; s >>= 1) {
      for (int p = threadIdx.x; p < total; p += blockDim.x) {
        const int r = p >> lg;
        const int a = lower_lane(p & (half - 1), s);
        compare_exchange(v + r * stride, ix + r * stride, a, a | s, (a & k) == 0);
      }
      __syncthreads();
    }
  }
}

// Sort each row, a bitonic sequence, ascending: log2(L) stages.
__device__ inline void bitonic_merge_rows(float* v, int* ix, int rows, int L, int stride) {
  const int half = L >> 1;
  if (half == 0) return;
  const int lg = __ffs(half) - 1;
  const int total = rows * half;
  for (int s = half; s > 0; s >>= 1) {
    for (int p = threadIdx.x; p < total; p += blockDim.x) {
      const int r = p >> lg;
      const int a = lower_lane(p & (half - 1), s);
      compare_exchange(v + r * stride, ix + r * stride, a, a | s, true);
    }
    __syncthreads();
  }
}

// Queue update: each sorted queue row (K lanes) becomes the K smallest pairs
// of itself and the first K lanes of the matching sorted candidate row. The
// reversed candidates against the queue, lane-wise minimum, form a bitonic
// sequence holding exactly those K pairs; one bitonic merge sorts it.
__device__ inline void topk_update_rows(float* qv, int* qi, int qstride, const float* cv,
                                 const int* ci, int cstride, int rows, int K) {
  const int lg = __ffs(K) - 1;
  for (int p = threadIdx.x; p < rows * K; p += blockDim.x) {
    const int r = p >> lg, l = p & (K - 1);
    const float rv = cv[r * cstride + K - 1 - l];
    const int ri = ci[r * cstride + K - 1 - l];
    float* v = qv + r * qstride + l;
    int* ix = qi + r * qstride + l;
    if (pair_less(rv, ri, *v, *ix)) {
      *v = rv;
      *ix = ri;
    }
  }
  __syncthreads();
  bitonic_merge_rows(qv, qi, rows, K, qstride);
  __syncthreads();
}

// Tile pruning: true on every thread iff, for each of `rows` rows, the row's
// minimum over L tile lanes is strictly greater than the queue row's last
// (worst) value. Strict: a candidate tying the worst value can still enter
// through the index tie-break, so a tile touching the threshold is kept.
__device__ inline bool tile_prunable(const float* tv, int L, const float* qv, int K, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  bool ok = true;
  for (int r = warp; r < rows; r += warps) {
    float m = CUDART_INF_F;
    for (int c = lane; c < L; c += 32) m = fminf(m, tv[r * L + c]);
    for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    ok = ok && (m > qv[r * K + K - 1]);
  }
  return __syncthreads_and(ok) != 0;
}

}  // namespace rt
