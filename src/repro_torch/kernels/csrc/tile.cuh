// Block geometry and row loads of the distance-matrix kernel (l2dist.cu):
// 256 threads score 256 dataset rows, one row per thread, over 32-feature
// slices staged in shared memory by coalesced 16-byte (bf16: 8-byte) loads
// and widened to f32 on the way in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace rt {

constexpr int kThreads = 256;        // threads per block
constexpr int kChunk = kThreads;     // dataset rows scored per pass: one per thread
constexpr int kDepth = 32;           // features staged in shared memory per pass
constexpr int kStride = kDepth + 1;  // padded row stride: conflict-free column reads

// One vector load of a row slice, widened to f32: kN elements per load.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage x[row0 : row0 + kChunk, d0 : d0 + kDepth] as f32 into xs (row stride
// kStride); rows at or past n_rows read as zeros. Called by all threads.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, int dim, int d0, int row0,
                                           int n_rows, float* xs) {
  constexpr int kN = Vec<T>::kN, kPer = kDepth / kN;
#pragma unroll
  for (int p = 0; p < kChunk * kPer / kThreads; ++p) {
    const int e = p * kThreads + threadIdx.x;
    const int r = e / kPer, c = (e % kPer) * kN;
    float v[kN];
    if (row0 + r < n_rows) {
      Vec<T>::load(x + (size_t)(row0 + r) * dim + d0 + c, v);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] = 0.f;
    }
    float* dst = xs + r * kStride + c;
#pragma unroll
    for (int j = 0; j < kN; ++j) dst[j] = v[j];
  }
}

// Stage q[row0 : row0 + rows, d0 : d0 + kDepth] as f32 into qs (row stride
// kDepth); rows at or past m read as zeros. Called by all threads.
template <typename T>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q, int dim, int d0, int row0,
                                              int rows, int m, float* qs) {
  for (int e = threadIdx.x; e < rows * kDepth; e += kThreads) {
    const int r = e / kDepth;
    qs[e] = row0 + r < m ? to_f32(q[(size_t)(row0 + r) * dim + d0 + e % kDepth]) : 0.f;
  }
}

}  // namespace rt
