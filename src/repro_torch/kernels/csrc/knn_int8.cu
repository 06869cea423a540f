// The certified int8 candidate scan for sm_90a, the counterpart of
// repro/kernels/knn/kernel_int8.py::knn_pallas_int8 (_knn_int8_kernel):
// int8 codes read at 1 B/element, widened exactly, scored against f32
// queries in f32 FMA, turned into certified lower bounds in registers and
// folded into q_len-wide sorted queues through select.cuh. knn_merge
// (knn.cu) reduces the per-block queues. See
// repro_torch/kernels/knn/kernel.py for the design note.
//
// Plain C interface (loaded with ctypes), as knn.cu.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "ring.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                     // dataset rows a thread scores
constexpr int kChunk = kThreads * kRows;     // rows a block scores per pass
constexpr int kDepth = 32;                   // features per stage of the ring
constexpr int kStageCodes = kChunk * kDepth; // bytes of codes per stage

// Shared memory of one block, in bytes (knn/kernel.py mirrors this formula):
// selection bookkeeping, two ring stages of codes and query slices, and the
// survivor buffer (value, index) of BM rows.
size_t int8_smem_bytes(int bm, int cap) {
  return (size_t)rt::kSelectBookBytes + 2 * ((size_t)kStageCodes + (size_t)bm * kDepth * 4) +
         (size_t)bm * cap * 8 + 128;
}

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait_all;

// Four int8 codes (one word) -> four exact floats in full-rate operations:
// the byte b + 128 becomes the low mantissa byte of 2^23, and subtracting
// 2^23 + 128 leaves b.
__device__ __forceinline__ void widen4(int w, float (&f)[4]) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// Grid (m / BM, splits). Block (i, s) owns query rows [i·BM, (i+1)·BM) and
// the dataset rows of n-tiles [s·tps, min(n_tiles, (s+1)·tps)). Thread t
// scores rows t + 256·j (j < 4) of each 1024-row chunk against all BM
// queries: a BM × 4 micro-tile in registers, each code widened once and
// used BM times, each query value read as a 16-byte broadcast and used 16
// times. Stages of 32 features (codes and the matching query slices) come
// through a two-stage cp.async ring, the next stage loading under the
// current one's FMAs. After a chunk's last stage the epilogue turns the
// sums into lower bounds in registers and select.cuh folds them into the
// BM queues, which live in device memory (out, and scratch as the second
// buffer); tile by tile (bn rows: several chunks, or part of one) the
// strict prune test against the tile-start worst values is counted as a
// skip. Writes the sorted queues to out[(row·splits + s)·q_len + lane], the
// skip count to skips[i·splits + s] and, when stats is not null, the
// selection counters to stats[(i·splits + s)·4 + c].
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
    knn_int8_scan_kernel(const float* __restrict__ q, const int8_t* __restrict__ x8,
                         const float* __restrict__ qn, const float* __restrict__ scales,
                         const float* __restrict__ err, const float* __restrict__ hn,
                         float* out_v, int* out_i, float* scratch_v, int* scratch_i,
                         int* __restrict__ skips, unsigned* __restrict__ stats, int n, int dim,
                         int q_len, int bn, int prune, int tiles_per_split, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + rt::kSelectBookBytes;
  float* ring_q = reinterpret_cast<float*>(ring + 2 * kStageCodes);
  float* qn_s = ring_q + 2 * BM * kDepth;
  float* tile_w = qn_s + 16;
  const rt::Survivors s = rt::carve_survivors<BM>(smem, tile_w + 16, cap);

  const int tid = threadIdx.x;
  const int m_tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int row0 = m_tile * BM;
  const int n_tiles = (n + bn - 1) / bn;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int r_begin = t_begin * bn, r_end = t_end * bn;
  const int dsteps = dim / kDepth;
  const int chunks = (r_end - r_begin + kChunk - 1) / kChunk;
  const int stages = chunks * dsteps;
  // bn < kChunk: a chunk holds several tiles, scored together and
  // selected tile by tile
  const int groups = bn < kChunk ? kChunk / bn : 1;
  const int group_lanes = kRows / groups;

  const size_t qoff = ((size_t)row0 * splits + split) * q_len;
  const rt::Queues queues{{out_v + qoff, scratch_v + qoff}, {out_i + qoff, scratch_i + qoff},
                          (long long)splits * q_len, q_len};
  if (tid < BM) qn_s[tid] = qn[row0 + tid];

  auto load_stage = [&](int g, int slot) {
    const int base = r_begin + (g / dsteps) * kChunk, d0 = (g % dsteps) * kDepth;
    unsigned char* dst = ring + slot * kStageCodes;
#pragma unroll
    for (int p = 0; p < kChunk * 2 / kThreads; ++p) {
      const int e = p * kThreads + tid, r = e >> 1, half = e & 1;
      const int row = base + r;
      const int8_t* src = x8 + (size_t)(row < n ? row : 0) * dim + d0 + half * 16;
      cp_async16(dst + r * kDepth + ((half ^ ((r >> 2) & 1)) << 4), src, row < n ? 16 : 0);
    }
    float* qdst = ring_q + slot * BM * kDepth;
    for (int e = tid; e < BM * kDepth / 4; e += kThreads) {
      const int r = e / (kDepth / 4), c = (e % (kDepth / 4)) * 4;
      cp_async16(qdst + r * kDepth + c, q + (size_t)(row0 + r) * dim + d0 + c, 16);
    }
    cp_async_commit();
  };

  float acc[BM][kRows];
  int skipped = 0;
  bool live = false;
  const int swz = (tid >> 2) & 1;  // row t + 256·j has bit 2 of t
  load_stage(0, 0);
  for (int g = 0; g < stages; ++g) {
    cp_async_wait_all();
    __syncthreads();
    if (g + 1 < stages) load_stage(g + 1, (g + 1) & 1);
    const int ds = g % dsteps;
    if (ds == 0) {
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[r][j] = 0.f;
    }
    const unsigned char* codes = ring + (g & 1) * kStageCodes;
    const float* qs = ring_q + (g & 1) * BM * kDepth;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int4 raw[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        raw[j] = *reinterpret_cast<const int4*>(codes + (tid + kThreads * j) * kDepth +
                                                ((h ^ swz) << 4));
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float xf[kRows][4];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int word = w == 0 ? raw[j].x : w == 1 ? raw[j].y : w == 2 ? raw[j].z : raw[j].w;
          widen4(word, xf[j]);
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * kDepth + h * 16 + w * 4);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            acc[r][j] = fmaf(qv.x, xf[j][0], acc[r][j]);
            acc[r][j] = fmaf(qv.y, xf[j][1], acc[r][j]);
            acc[r][j] = fmaf(qv.z, xf[j][2], acc[r][j]);
            acc[r][j] = fmaf(qv.w, xf[j][3], acc[r][j]);
          }
        }
      }
    }
    if (ds != dsteps - 1) continue;

    // epilogue, in kernel_int8.py's rounding order: cross = acc·scale,
    // d_hat = max((qn - 2·cross) + hn, 0), lower = max(sqrt(d_hat) - err, 0)²,
    // +inf on rows whose quantised norm is not finite
    const int base = r_begin + (g / dsteps) * kChunk;
    int ix[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = base + tid + kThreads * j;
      ix[j] = row;
      const bool in = row < r_end;
      const float sc = in ? __ldg(scales + row) : 1.f, er = in ? __ldg(err + row) : 0.f;
      const float hv = in ? __ldg(hn + row) : CUDART_INF_F;
      const bool valid = isfinite(hv);
      const float h = valid ? hv : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float cross = __fmul_rn(acc[r][j], sc);
        const float d_hat =
            fmaxf(__fadd_rn(__fsub_rn(qn_s[r], __fmul_rn(2.f, cross)), h), 0.f);
        const float t = fmaxf(__fsub_rn(__fsqrt_rn(d_hat), er), 0.f);
        acc[r][j] = valid ? __fmul_rn(t, t) : CUDART_INF_F;
      }
    }
    for (int grp = 0; grp < groups; ++grp) {
      const int g0 = base + grp * (kChunk / groups);
      if (g0 >= r_end) break;
      if (g0 % bn == 0) {  // a tile starts: the prune test reads this worst
        if (tid < BM) tile_w[tid] = s.worst_v[tid];
        __syncthreads();
      }
      uint64_t pending = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j / group_lanes != grp) continue;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          pending |= 1ull << (r * kRows + j);
          live |= !(acc[r][j] > tile_w[r]);
        }
      }
      rt::select_into_queues<BM, kRows>(acc, ix, pending, s, queues);
      if ((g0 + kChunk / groups) % bn == 0) {  // the tile ends
        const bool any = __syncthreads_or(live);
        if (prune && !any) ++skipped;
        live = false;
      }
    }
  }

  rt::write_queues<BM>(s, queues, out_v + qoff, out_i + qoff, (long long)splits * q_len);
  if (tid == 0) skips[m_tile * splits + split] = skipped;
  if (stats != nullptr && tid < 4)
    stats[((size_t)m_tile * splits + split) * 4 + tid] = s.stats[tid];
}

template <int BM>
cudaError_t launch_int8(const void* q, const void* x8, const void* qn, const void* scales,
                        const void* err, const void* hn, void* out_v, void* out_i,
                        void* scratch_v, void* scratch_i, void* skips, void* stats, int m,
                        int n, int dim, int q_len, int bn, int prune, int splits,
                        int tiles_per_split, int cap, cudaStream_t stream) {
  const size_t smem = int8_smem_bytes(BM, cap);
  auto kernel = knn_int8_scan_kernel<BM>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(m / BM, splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(x8),
      static_cast<const float*>(qn), static_cast<const float*>(scales),
      static_cast<const float*>(err), static_cast<const float*>(hn), static_cast<float*>(out_v),
      static_cast<int*>(out_i), static_cast<float*>(scratch_v), static_cast<int*>(scratch_i),
      static_cast<int*>(skips), static_cast<unsigned*>(stats), n, dim, q_len, bn, prune,
      tiles_per_split, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (m, dim) f32, x8 (n, dim) int8 codes; qn (m,); scales, err, hn
// (ceil(n / bn)·bn,) f32, hn +inf on invalid rows (padding included);
// out_v / out_i and scratch_v / scratch_i (m, splits, q_len); skips
// (m / bm, splits) i32; stats null or (m / bm, splits, 4) u32. out holds the
// sorted lower bounds and indices. Requires m % bm == 0, dim % 32 == 0, bn a
// power of two >= 256, q_len a power of two <= bn, bm in {1, 2, 4, 8, 16},
// cap a power of two. n need not be a multiple of bn.
int knn_int8_scan(const void* q, const void* x8, const void* qn, const void* scales,
                  const void* err, const void* hn, void* out_v, void* out_i, void* scratch_v,
                  void* scratch_i, void* skips, void* stats, int m, int n, int dim, int q_len,
                  int bm, int bn, int prune, int splits, int tiles_per_split, int cap,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_INT8_LAUNCH(BM)                                                                 \
  launch_int8<BM>(q, x8, qn, scales, err, hn, out_v, out_i, scratch_v, scratch_i, skips,     \
                  stats, m, n, dim, q_len, bn, prune, splits, tiles_per_split, cap, st)
  cudaError_t e;
  switch (bm) {
    case 1:
      e = REPRO_INT8_LAUNCH(1);
      break;
    case 2:
      e = REPRO_INT8_LAUNCH(2);
      break;
    case 4:
      e = REPRO_INT8_LAUNCH(4);
      break;
    case 8:
      e = REPRO_INT8_LAUNCH(8);
      break;
    case 16:
      e = REPRO_INT8_LAUNCH(16);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
#undef REPRO_INT8_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"
