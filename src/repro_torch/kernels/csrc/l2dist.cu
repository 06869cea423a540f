// Squared-L2 distance matrix for sm_90a, the counterpart of
// repro/kernels/l2dist/kernel.py::l2dist_pallas (_l2dist_kernel):
// D[i, j] = max((-2·<q_i, x_j> + qn_i) + xn_j, 0), the dot product
// accumulated in f32 FMA (bf16 widened on load; no tensor cores, no TF32),
// the epilogue rounded in that order. Two kernels behind one entry point,
// picked by the wrapper (repro_torch/kernels/l2dist/kernel.py, which holds
// the design note and mirrors l2dist_smem_bytes and split_of):
//
//   l2dist_stream_kernel — small batches (bound by the bytes of x): one wave
//     of blocks, each streaming its own range of dataset rows once through a
//     cp.async ring against a register micro-tile of up to 16 queries, and
//     writing its scores straight from registers;
//   l2dist_tiled_kernel — large batches (bound by FMAs): 128 × 128 output
//     tiles, both operands brought in 128-byte row slices through a cp.async
//     ring, an 8 × 8 outer product per thread.
//
// Plain C interface (loaded with ctypes), as knn.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;          // ring stages of either kernel
constexpr int kStageBytes = 32768;  // stream: dataset rows of one stage
constexpr int kQueryBytes = 256;    // stream: room per f32 query row in a stage, per sharer
constexpr int kTileM = 128;         // tiled: queries of a block
constexpr int kTileN = 128;         // tiled: dataset rows of a block
constexpr int kTQ = 8;              // tiled: queries a thread holds
constexpr int kTR = 8;              // tiled: dataset rows a thread holds
constexpr int kLine = 128;          // tiled: bytes of a row in a stage
constexpr int kGroupM = 8;          // tiled: m-tiles that walk the n-tiles together

// Shared memory of one block, in bytes (kernel.py mirrors this formula):
// kStages stages of `stage_bytes` of dataset rows and `bm` query rows of
// `query_bytes`, and 64 bytes of query norms. The stream kernel takes
// (kStageBytes, BM, kQueryBytes·split_of(BM)), the tiled one
// (kTileN·kLine, kTileM, kLine).
size_t l2dist_smem_bytes(int stage_bytes, int bm, int query_bytes) {
  return (size_t)kStages * ((size_t)stage_bytes + (size_t)bm * query_bytes) + 64;
}

// Threads of the stream kernel that share a dataset row (kernel.py mirrors
// it): four at BM <= 2, where the kernel only streams, so that a stage
// reads 512 contiguous bytes of a row; else one.
__host__ __device__ constexpr int split_of(int bm) { return bm <= 2 ? 4 : 1; }

// The l2 epilogue in the reference's rounding order.
__device__ __forceinline__ float l2_from_dot(float acc, float qn, float xn) {
  return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(-2.f, acc), qn), xn), 0.f);
}

// Four elements of 16 loaded bytes as floats, exactly: the w-th group of
// four (f32: the only one; bf16: a bf16 is the high half of the f32 of the
// same value). As in knn.cu.
template <typename T>
struct Widen;

template <>
struct Widen<float> {
  static constexpr int kGroups = 1;
  __device__ __forceinline__ static void four(const uint4& r, int, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Widen<__nv_bfloat16> {
  static constexpr int kGroups = 2;
  __device__ __forceinline__ static void four(const uint4& r, int w, float (&f)[4]) {
    const unsigned a = w ? r.z : r.x, b = w ? r.w : r.y;
    f[0] = __uint_as_float(a << 16);
    f[1] = __uint_as_float(a & 0xffff0000u);
    f[2] = __uint_as_float(b << 16);
    f[3] = __uint_as_float(b & 0xffff0000u);
  }
};

// Four consecutive elements at p (16 bytes of f32, 8 of bf16, aligned) from
// shared memory, as floats.
__device__ __forceinline__ void load_four(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_four(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Grid (blocks, ceil(m / BM)), kThreads threads. Block (b, i) scores query
// rows [i·BM, (i+1)·BM) against dataset rows [b·span, (b+1)·span), which it
// reads once, in chunks of kChunk rows: kSplit threads share each of the
// chunk's row slots, and thread t holds slot t / kSplit of every j
// (j < kRows: 2 for BM >= 8, else 4) against all BM queries, a BM × kRows
// micro-tile in registers, each row element read once from shared memory
// and used for every query, each query value (staged as f32) read as a
// 16-byte broadcast. Stages of 32 KB come through a kStages-deep cp.async
// ring in the order (feature block, j), as knn.cu's knn_scan stages them:
// for BM >= 8, 64 bytes of the rows of both j (each query value feeds 8
// FMAs), L2 asked to fetch each row's whole 128-byte line; for BM = 4, 128
// bytes of the rows of one j; for BM <= 2 (kSplit = 4), 512 contiguous bytes
// of 64 rows, each thread taking every fourth 16-byte piece of its row, so
// device memory serves runs of 512 bytes (the four partial sums are added by
// shuffles at the end of a chunk). A row's 16-byte pieces sit rotated, so
// the pieces a quarter warp reads fall in distinct banks. The query slice
// of a stage is fetched into registers one iteration ahead and stored
// widened to f32 behind the FMAs. After a chunk's last stage the epilogue
// writes the scores from registers: for BM >= 4, for each query and j, a
// warp stores 32 consecutive columns, one 128-byte line. Rows past the
// block's range or n read as zeros (no device bytes) and are not written;
// so are query rows past m.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, 2)
    l2dist_stream_kernel(const T* __restrict__ q, const T* __restrict__ x,
                         const float* __restrict__ qn, const float* __restrict__ xn,
                         float* __restrict__ out, int m, int n, int dim, int span) {
  constexpr int kRows = BM >= 8 ? 2 : 4;
  constexpr int kSplit = split_of(BM);           // threads sharing a row slot
  constexpr int kSlots = kThreads / kSplit;      // row slots of each j
  constexpr int kChunk = kSlots * kRows;
  constexpr int kPer = BM >= 8 ? 2 : 1;          // j a stage holds
  constexpr int kRowBytes = kStageBytes / (kSlots * kPer);
  constexpr int kPieces = kRowBytes / 16;
  constexpr int kPieceElems = 16 / sizeof(T);
  constexpr int kDepth = kRowBytes / sizeof(T);  // features per stage
  constexpr int kLineRows = 128 / kRowBytes;     // rows sharing 128 bytes (kRowBytes < 128)
  constexpr int kJSteps = kRows / kPer;          // stages per feature block
  constexpr int kQPer = (BM * kDepth + kThreads - 1) / kThreads;  // query values a thread stages
  constexpr int kQRoom = kQueryBytes * kSplit;   // bytes per f32 query row in a stage
  static_assert(kDepth * 4 <= kQRoom, "query slice exceeds its room");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* ring_q = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* qn_s = ring_q + kStages * BM * (kQRoom / 4);
  // the rotation of stage row r's 16-byte pieces: distinct banks for the
  // rows (and sharers) of a quarter warp
  auto rot = [](int r) {
    if constexpr (kRowBytes < 128) return r / kLineRows % kPieces;
    else return r % (8 / kSplit) * kSplit;
  };

  const int tid = threadIdx.x, tr = tid / kSplit, sub = tid % kSplit;
  const int row0 = blockIdx.y * BM;
  const int r_begin = min(n, blockIdx.x * span), r_end = min(n, r_begin + span);
  const int dsteps = (dim + kDepth - 1) / kDepth;
  const int chunks = (r_end - r_begin + kChunk - 1) / kChunk;
  const int stages = chunks * dsteps * kJSteps;
  if (tid < BM) qn_s[tid] = row0 + tid < m ? qn[row0 + tid] : 0.f;

  // stage g: chunk g / (dsteps·kJSteps), feature block (g / kJSteps) %
  // dsteps, the rows s + kSlots·j of j in [kPer·(g % kJSteps), +kPer), row
  // s + kSlots·j at stage row (j % kPer)·kSlots + s; pieces past dim and
  // rows past the range read as zeros
  auto load_rows = [&](int g, int slot) {
    const int js = g % kJSteps, b = (g / kJSteps) % dsteps, c = g / (kJSteps * dsteps);
    const int base = r_begin + c * kChunk + js * kPer * kSlots, d0 = b * kDepth;
    unsigned char* dst = ring + slot * kStageBytes;
#pragma unroll
    for (int p = 0; p < kStageBytes / 16 / kThreads; ++p) {
      const int e = p * kThreads + tid, r = e / kPieces, piece = e % kPieces;
      const int row = base + r, col = d0 + piece * kPieceElems;
      const bool in = row < r_end && col < dim;
      void* to = dst + r * kRowBytes + ((piece ^ rot(r)) << 4);
      const T* from = x + (in ? (size_t)row * dim + col : 0);
      if constexpr (kRowBytes < 128) rt::cp_async16_line(to, from, in ? 16 : 0);
      else rt::cp_async16(to, from, in ? 16 : 0);
    }
    rt::cp_async_commit();
  };
  // the query slice of stage g: this thread's kQPer values, as loaded
  T qv[kQPer];
  bool qin[kQPer];
  auto fetch_queries = [&](int g) {
    const int d0 = (g / kJSteps) % dsteps * kDepth;
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int e = u * kThreads + tid, r = e / kDepth, col = d0 + e % kDepth;
      qin[u] = e < BM * kDepth && row0 + r < m && col < dim;
      qv[u] = q[qin[u] ? (size_t)(row0 + r) * dim + col : 0];
    }
  };
  auto store_queries = [&](int slot) {
    float* qs = ring_q + slot * BM * (kQRoom / 4);
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int e = u * kThreads + tid;
      if (e < BM * kDepth) qs[e] = qin[u] ? to_f32(qv[u]) : 0.f;
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) {
      load_rows(s, s);
      fetch_queries(s);
      store_queries(s);
    } else {
      rt::cp_async_commit();
    }
  }
  float acc[BM][kRows];
  int slot = 0;
  for (int g = 0; g < stages;) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[r][j] = 0.f;
    const int base = r_begin + (g / (kJSteps * dsteps)) * kChunk;
    for (int b = 0; b < dsteps; ++b) {
#pragma unroll
      for (int js = 0; js < kJSteps; ++js, ++g) {
        rt::cp_async_wait<kStages - 2>();
        __syncthreads();
        const int ahead = g + kStages - 1;
        const int ahead_slot = slot == 0 ? kStages - 1 : slot - 1;
        if (ahead < stages) {
          load_rows(ahead, ahead_slot);
          fetch_queries(ahead);
        } else {
          rt::cp_async_commit();
        }
        const unsigned char* rows = ring + slot * kStageBytes;
        const float* qs = ring_q + slot * BM * (kQRoom / 4);
#pragma unroll
        for (int pp = 0; pp < kPieces / kSplit; ++pp) {
          const int piece = pp * kSplit + sub;
          uint4 raw[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int r = u * kSlots + tr;
            raw[u] = *reinterpret_cast<const uint4*>(rows + r * kRowBytes +
                                                     ((piece ^ rot(r)) << 4));
          }
#pragma unroll
          for (int w = 0; w < Widen<T>::kGroups; ++w) {
            float xf[kPer][4];
#pragma unroll
            for (int u = 0; u < kPer; ++u) Widen<T>::four(raw[u], w, xf[u]);
#pragma unroll
            for (int r = 0; r < BM; ++r) {
              const float4 qf = *reinterpret_cast<const float4*>(
                  qs + r * kDepth + (piece * Widen<T>::kGroups + w) * 4);
#pragma unroll
              for (int u = 0; u < kPer; ++u) {
                float& a = acc[r][js * kPer + u];
                a = fmaf(qf.x, xf[u][0], a);
                a = fmaf(qf.y, xf[u][1], a);
                a = fmaf(qf.z, xf[u][2], a);
                a = fmaf(qf.w, xf[u][3], a);
              }
            }
          }
        }
        if (ahead < stages) store_queries(ahead_slot);
        slot = slot == kStages - 1 ? 0 : slot + 1;
      }
    }

#pragma unroll
    for (int off = 1; off < kSplit; off <<= 1)
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int col = base + tr + kSlots * j;
      if (j % kSplit != sub || col >= r_end) continue;
      const float xv = __ldg(xn + col);
#pragma unroll
      for (int r = 0; r < BM; ++r)
        if (row0 + r < m) out[(size_t)(row0 + r) * n + col] = l2_from_dot(acc[r][j], qn_s[r], xv);
    }
  }
}

// Grid (ceil(m / kTileM)·ceil(n / kTileN)), kThreads threads, one block an
// SM (its 8 × 8 outer product wants the registers). Block b computes the
// kTileM × kTileN output tile (mt, nt); consecutive blocks walk the n-tiles
// in groups of kGroupM m-tiles, so a tile of x is read from device memory
// about once per group and served from L2 to the rest of the group. Each
// stage of the kStages-deep cp.async ring holds kLine bytes (32 f32 or 64
// bf16 features) of the tile's query rows and dataset rows, d-contiguous as
// they lie in memory, a row's 16-byte pieces rotated by the row's low three
// bits. Thread (ty, tx) = (t / 16, t % 16) holds the 8 × 8 outer product of
// queries ty + 16·i and rows tx + 16·j: for every 4 features it reads 4
// consecutive values of each of its 8 rows and 8 queries (one 16-byte load
// each in f32; a quarter warp's 8 rows fall in distinct banks, its queries
// are one broadcast) and does 256 FMAs, summing over d in order. The
// epilogue writes the tile from registers; query rows past m and dataset
// rows past n read as zeros and are not written.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    l2dist_tiled_kernel(const T* __restrict__ q, const T* __restrict__ x,
                        const float* __restrict__ qn, const float* __restrict__ xn,
                        float* __restrict__ out, int m, int n, int dim) {
  constexpr int kElems = kLine / sizeof(T);       // features per stage
  constexpr int kPieces = kLine / 16;             // 16-byte pieces of a row per stage
  constexpr int kPieceElems = 16 / sizeof(T);
  constexpr int kSlot = (kTileM + kTileN) * kLine;  // bytes of one stage
  constexpr int kTX = kTileN / kTR, kTY = kThreads / kTX;
  // groups of 4 features unrolled: all 8 of a stage in f32, 2 of its 16 in
  // bf16 (whole stages unrolled ran faster in f32, slower in bf16)
  constexpr int kUnroll = sizeof(T) == 4 ? kElems / 4 : 2;
  static_assert(kTY * kTQ == kTileM, "thread tiles must cover the block tile");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int m_tiles = (m + kTileM - 1) / kTileM, n_tiles = (n + kTileN - 1) / kTileN;
  const long long per_group = (long long)kGroupM * n_tiles;
  const int group = (int)(blockIdx.x / per_group), first = group * kGroupM;
  const int in_group = (int)(blockIdx.x - group * per_group);
  const int group_rows = min(m_tiles - first, kGroupM);
  const int q0 = (first + in_group % group_rows) * kTileM;
  const int x0 = (in_group / group_rows) * kTileN;
  const int steps = (dim + kElems - 1) / kElems;

  // stage g: features [g·kElems, +kElems) of the tile's query rows (first
  // kTileM rows of the slot) and dataset rows (the next kTileN); past m, n
  // or dim: zeros
  auto load_stage = [&](int g, int slot) {
    unsigned char* dst = smem + slot * kSlot;
    const int d0 = g * kElems;
#pragma unroll
    for (int p = 0; p < (kTileM + kTileN) * kPieces / kThreads; ++p) {
      const int e = p * kThreads + tid, r = e / kPieces, piece = e % kPieces;
      const int col = d0 + piece * kPieceElems;
      const bool is_q = r < kTileM;  // the same for the whole of iteration p
      const int row = is_q ? q0 + r : x0 + r - kTileM;
      const bool in = row < (is_q ? m : n) && col < dim;
      const T* from = (is_q ? q : x) + (in ? (size_t)row * dim + col : 0);
      rt::cp_async16(dst + r * kLine + ((piece ^ (r & 7)) << 4), from, in ? 16 : 0);
    }
    rt::cp_async_commit();
  };

  float acc[kTQ][kTR];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTR; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    else rt::cp_async_commit();
  }
  // a thread's query rows ty + kTY·i and dataset rows tx + kTX·j share
  // their low three bits: one rotation each
  const int qrot = ty & 7, xrot = tx & 7;
  int slot = 0;
  for (int g = 0; g < steps; ++g) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (g + kStages - 1 < steps) load_stage(g + kStages - 1, slot == 0 ? kStages - 1 : slot - 1);
    else rt::cp_async_commit();
    const unsigned char* qs = smem + slot * kSlot;
    const unsigned char* xs = qs + kTileM * kLine;
#pragma unroll kUnroll
    for (int f = 0; f < kElems; f += 4) {
      const int piece = f / kPieceElems, off = (f % kPieceElems) * sizeof(T);
      float xf[kTR][4];
#pragma unroll
      for (int j = 0; j < kTR; ++j)
        load_four(reinterpret_cast<const T*>(xs + (tx + kTX * j) * kLine +
                                             ((piece ^ xrot) << 4) + off),
                  xf[j]);
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        float qf[4];
        load_four(reinterpret_cast<const T*>(qs + (ty + kTY * i) * kLine +
                                             ((piece ^ qrot) << 4) + off),
                  qf);
#pragma unroll
        for (int j = 0; j < kTR; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j] = fmaf(qf[c], xf[j][c], acc[i][j]);
      }
    }
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }

  float xv[kTR];
#pragma unroll
  for (int j = 0; j < kTR; ++j) {
    const int col = x0 + tx + kTX * j;
    xv[j] = col < n ? __ldg(xn + col) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= m) continue;
    const float qv = __ldg(qn + row);
    float* dst = out + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < kTR; ++j) {
      const int col = x0 + tx + kTX * j;
      if (col < n) dst[col] = l2_from_dot(acc[i][j], qv, xv[j]);
    }
  }
}

template <typename T, int BM>
cudaError_t launch_stream(const void* q, const void* x, const void* qn, const void* xn,
                          void* out, int m, int n, int dim, int blocks, int span,
                          cudaStream_t stream) {
  const size_t smem = l2dist_smem_bytes(kStageBytes, BM, kQueryBytes * split_of(BM));
  auto kernel = l2dist_stream_kernel<T, BM>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, (m + BM - 1) / BM), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<const float*>(qn),
      static_cast<const float*>(xn), static_cast<float*>(out), m, n, dim, span);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(const void* q, const void* x, const void* qn, const void* xn,
                         void* out, int m, int n, int dim, int blocks, cudaStream_t stream) {
  const long long tiles =
      (long long)((m + kTileM - 1) / kTileM) * ((n + kTileN - 1) / kTileN);
  if (blocks != tiles) return cudaErrorInvalidValue;
  const size_t smem = l2dist_smem_bytes(kTileN * kLine, kTileM, kLine);
  auto kernel = l2dist_tiled_kernel<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<const float*>(qn),
      static_cast<const float*>(xn), static_cast<float*>(out), m, n, dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int tiled, int bm, const void* q, const void* x, const void* qn,
                     const void* xn, void* out, int m, int n, int dim, int blocks, int span,
                     cudaStream_t stream) {
  if (tiled) return launch_tiled<T>(q, x, qn, xn, out, m, n, dim, blocks, stream);
  switch (bm) {
    case 1:
      return launch_stream<T, 1>(q, x, qn, xn, out, m, n, dim, blocks, span, stream);
    case 2:
      return launch_stream<T, 2>(q, x, qn, xn, out, m, n, dim, blocks, span, stream);
    case 4:
      return launch_stream<T, 4>(q, x, qn, xn, out, m, n, dim, blocks, span, stream);
    case 8:
      return launch_stream<T, 8>(q, x, qn, xn, out, m, n, dim, blocks, span, stream);
    case 16:
      return launch_stream<T, 16>(q, x, qn, xn, out, m, n, dim, blocks, span, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (m, dim), x (n, dim): both f32 (bf16 = 0) or both bf16 (bf16 = 1),
// 16-byte aligned; qn (m,), xn (n,) f32; out (m, n) f32. Requires
// dim % 32 == 0, m, n >= 1. tiled = 0: the stream kernel on a grid
// (blocks, ceil(m / bm)), bm in {1, 2, 4, 8, 16}, each block scoring `span`
// dataset rows (a multiple of 32, blocks·span >= n); tiled = 1: the tiled
// kernel, blocks = ceil(m / 128)·ceil(n / 128) (bm and span unused).
int l2dist(const void* q, const void* x, const void* qn, const void* xn, void* out, int m,
           int n, int dim, int tiled, int bm, int blocks, int span, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(tiled, bm, q, x, qn, xn, out, m, n, dim, blocks, span, st)
           : dispatch<float>(tiled, bm, q, x, qn, xn, out, m, n, dim, blocks, span, st);
  return static_cast<int>(err);
}

}  // extern "C"
