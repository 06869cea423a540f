// The lexicographic pair order and a bitonic sort over rows of (value,
// index) pairs in shared memory — the device side of
// repro_torch/kernels/bitonic.py's bitonic_sort; select.cuh sorts its
// survivors with it.
//
// Comparisons are lexicographic on (value, index), so exact score ties break
// to the smaller index; float `<` and `==` already treat -0.0 as +0.0.
// bitonic_sort_rows is called by all threads of the block, works on `rows`
// rows of `L` lanes (L a power of two) at `stride` floats apart, and returns
// with the block synchronised.
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

}  // namespace rt
