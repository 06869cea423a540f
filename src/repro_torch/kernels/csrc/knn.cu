// Fused exact kNN for sm_90a: a scan kernel that scores dataset rows against
// a block of queries in registers and folds them into per-block sorted top-k
// queues through the survivor filter of select.cuh (knn_scan, the
// counterpart of repro/kernels/knn/kernel.py::knn_pallas: f32 or bf16 rows,
// l2 / ip scores), and a one-launch merge of per-block queues (knn_merge,
// also for knn_int8_scan of knn_int8.cu and topk_scan of topk.cu). The
// (M, N) score matrix never leaves the block. An optional per-query bound
// (ops.knn's pilot: an upper bound on the k-th pair) starts every block's
// filter at it, so a scan whose blocks see few rows a query still admits
// few lanes. See repro_torch/kernels/knn/kernel.py for the design note.
//
// Plain C interface (loaded with ctypes): every pointer and the stream come
// in as void*, outputs and scratch are allocated by the caller, and each
// entry point returns cudaGetLastError() of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "ring.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 32768;             // rows of one ring stage
constexpr int kQueryBytes = 256;               // room per query row in a stage
constexpr int kMergeThreads = 1024;            // threads of a merge block
constexpr int kPool = 8192;                    // pairs a merge round gathers

// Shared memory of one scan block, in bytes (kernel.py mirrors this formula):
// selection bookkeeping, two ring stages of rows and f32 query slices, the
// rows' qn and tile-start worst values, and the survivor buffer (value,
// index) of BM rows.
size_t scan_smem_bytes(int bm, int cap) {
  return (size_t)rt::kSelectBookBytes + 2 * ((size_t)kStageBytes + (size_t)bm * kQueryBytes) +
         (size_t)bm * cap * 8 + 128;
}

// Shared memory of one merge block, in bytes (kernel.py mirrors this formula):
// the pool of gathered pairs, two buffers of k kept pairs, the radix
// histogram and the candidate offsets of kMergeThreads queues.
size_t merge_smem_bytes(int k) {
  return (size_t)kPool * 8 + (size_t)k * 16 + (size_t)(256 + kMergeThreads) * 4 + 128;
}

// Four elements of 16 loaded bytes as floats, exactly: the w-th group of
// four (f32: the only one; bf16: a bf16 is the high half of the f32 of the
// same value).
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

// Grid (m / BM, splits). Block (i, s) owns query rows [i·BM, (i+1)·BM) and
// the dataset rows of n-tiles [s·tps, min(n_tiles, (s+1)·tps)). Thread t
// scores rows t + 256·j (j < kRows: 2 for BM >= 8, else 4) of each chunk of
// 256·kRows rows against all BM queries: a BM × kRows micro-tile in
// registers, each row element loaded once from shared memory and used BM
// times, each query value (staged as f32) read as a 16-byte broadcast and
// used for the kPer rows of the stage. Stages of 32 KB come through a
// two-stage cp.async ring, the next loading under the current one's FMAs,
// in the order (feature block, j): for BM >= 8, 64 bytes (16 f32 or 32 bf16
// features) of the rows of both j, so each query value feeds 8 FMAs, with
// L2 asked to fetch each row's whole 128-byte line (the next feature block
// reads its other half); else 128 bytes of the rows of one j, whole lines
// (the memory-bound scans at small m). A row's 16-byte pieces sit rotated,
// so the eight rows a quarter warp reads fall in distinct banks. After a
// chunk's last stage the l2 / ip epilogue runs in registers and select.cuh
// folds the scores into the BM queues, which live in device memory (out,
// and scratch as the second buffer); tile by tile (bn rows: several
// chunks, or part of one) the strict prune test against the tile-start
// worst values is counted as a skip. A bound (bound_v not null) caps each
// query's filter from the start (see below). Row r of x lies at
// x + r·x_pitch and its norm at xn + r·xn_step (a strided sample of the
// rows is read in place). Writes the sorted queues to
// out[(row·splits + s)·k + lane], the skip count to skips[i·splits + s]
// and, when stats is not null, the selection counters to
// stats[(i·splits + s)·4 + c].
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, 2)
    knn_scan_kernel(const float* __restrict__ q, const T* __restrict__ x,
                    const float* __restrict__ qn, const float* __restrict__ xn, float* out_v,
                    int* out_i, float* scratch_v, int* scratch_i, int* __restrict__ skips,
                    unsigned* __restrict__ stats, const float* __restrict__ bound_v,
                    const int* __restrict__ bound_i, int n, int dim, int x_pitch, int xn_step,
                    int k, int bn, int metric, int prune, int tiles_per_split, int cap) {
  constexpr int kRows = BM >= 8 ? 2 : 4;
  constexpr int kChunk = kThreads * kRows;
  constexpr int kPer = BM >= 8 ? 2 : 1;            // rows a thread holds per stage
  constexpr int kRowBytes = kStageBytes / (kThreads * kPer);
  constexpr int kPieces = kRowBytes / 16;
  constexpr int kPieceElems = 16 / sizeof(T);
  constexpr int kDepth = kRowBytes / sizeof(T);  // features per stage
  constexpr int kLine = 128 / kRowBytes;         // rows sharing 128 bytes
  constexpr int kJSteps = kRows / kPer;          // stages per feature block
  static_assert(kDepth * 4 <= kQueryBytes, "query slice exceeds its room");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + rt::kSelectBookBytes;
  float* ring_q = reinterpret_cast<float*>(ring + 2 * kStageBytes);
  float* qn_s = ring_q + 2 * BM * (kQueryBytes / 4);
  float* tile_w = qn_s + 16;
  const rt::Survivors s = rt::carve_survivors<BM>(smem, tile_w + 16, cap);

  const int tid = threadIdx.x;
  const int m_tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int row0 = m_tile * BM;
  const int n_tiles = n / bn;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int r_begin = t_begin * bn, r_end = t_end * bn;
  const int dsteps = (dim + kDepth - 1) / kDepth;
  const int chunks = (r_end - r_begin + kChunk - 1) / kChunk;
  const int stages = chunks * dsteps * kJSteps;
  // bn < kChunk: a chunk holds several tiles, scored together and
  // selected tile by tile
  const int groups = bn < kChunk ? kChunk / bn : 1;
  const int group_lanes = kRows / groups;

  const size_t qoff = ((size_t)row0 * splits + split) * k;
  const rt::Queues queues{{out_v + qoff, scratch_v + qoff}, {out_i + qoff, scratch_i + qoff},
                          (long long)splits * k, k};
  if (tid < BM) qn_s[tid] = qn[row0 + tid];
  // a finite bound starts the filter at it: a lane enters only at or below
  // (bound_v, bound_i), i.e. strictly below (bound_v, bound_i + 1), until
  // the queue is full, and then below its worst, which is at or below the
  // bound; the tile-start values of the prune test follow
  if (bound_v != nullptr && tid < BM && bound_v[row0 + tid] < CUDART_INF_F) {
    s.worst_v[tid] = bound_v[row0 + tid];
    s.worst_i[tid] = bound_i[row0 + tid] + 1;
  }

  // stage g: chunk g / (dsteps·kJSteps), feature block (g / kJSteps) %
  // dsteps, the rows t + 256·j of j in [kPer·(g % kJSteps), +kPer), row
  // t + 256·j in slot (j % kPer)·256 + t; pieces past dim and rows past n
  // read as zeros
  auto load_stage = [&](int g, int slot) {
    const int js = g % kJSteps, b = (g / kJSteps) % dsteps, c = g / (kJSteps * dsteps);
    const int base = r_begin + c * kChunk + js * kPer * kThreads, d0 = b * kDepth;
    unsigned char* dst = ring + slot * kStageBytes;
#pragma unroll
    for (int p = 0; p < kStageBytes / 16 / kThreads; ++p) {
      const int e = p * kThreads + tid, r = e / kPieces, piece = e % kPieces;
      const int row = base + r, col = d0 + piece * kPieceElems;
      const bool in = row < n && col < dim;
      void* to = dst + r * kRowBytes + ((piece ^ (r / kLine % kPieces)) << 4);
      const T* from = x + (in ? (size_t)row * x_pitch + col : 0);
      if constexpr (kRowBytes < 128) rt::cp_async16_line(to, from, in ? 16 : 0);
      else rt::cp_async16(to, from, in ? 16 : 0);
    }
    float* qdst = ring_q + slot * BM * (kQueryBytes / 4);
    for (int e = tid; e < BM * kDepth / 4; e += kThreads) {
      const int r = e / (kDepth / 4), col = d0 + (e % (kDepth / 4)) * 4;
      rt::cp_async16(qdst + r * kDepth + (col - d0),
                     q + (col < dim ? (size_t)(row0 + r) * dim + col : 0), col < dim ? 16 : 0);
    }
    rt::cp_async_commit();
  };

  float acc[BM][kRows];
  int skipped = 0;
  bool live = false;
  load_stage(0, 0);
  for (int g = 0; g < stages;) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[r][j] = 0.f;
    const int base = r_begin + (g / (kJSteps * dsteps)) * kChunk;
    for (int b = 0; b < dsteps; ++b) {
#pragma unroll
      for (int js = 0; js < kJSteps; ++js, ++g) {
        rt::cp_async_wait_all();
        __syncthreads();
        if (g + 1 < stages) load_stage(g + 1, (g + 1) & 1);
        const unsigned char* rows = ring + (g & 1) * kStageBytes;
        const float* qs = ring_q + (g & 1) * BM * (kQueryBytes / 4);
#pragma unroll
        for (int piece = 0; piece < kPieces; ++piece) {
          uint4 raw[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int r = u * kThreads + tid;
            raw[u] = *reinterpret_cast<const uint4*>(rows + r * kRowBytes +
                                                     ((piece ^ (r / kLine % kPieces)) << 4));
          }
#pragma unroll
          for (int w = 0; w < Widen<T>::kGroups; ++w) {
            float xf[kPer][4];
#pragma unroll
            for (int u = 0; u < kPer; ++u) Widen<T>::four(raw[u], w, xf[u]);
#pragma unroll
            for (int r = 0; r < BM; ++r) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  qs + r * kDepth + (piece * Widen<T>::kGroups + w) * 4);
#pragma unroll
              for (int u = 0; u < kPer; ++u) {
                float& a = acc[r][js * kPer + u];
                a = fmaf(qv.x, xf[u][0], a);
                a = fmaf(qv.y, xf[u][1], a);
                a = fmaf(qv.z, xf[u][2], a);
                a = fmaf(qv.w, xf[u][3], a);
              }
            }
          }
        }
      }
    }

    // epilogue, in kernel.py's rounding order: l2 = max((qn - 2·cross) + xn,
    // 0), ip = -cross, +inf on rows whose norm is not finite
    int ix[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = base + tid + kThreads * j;
      ix[j] = row;
      const float xv = row < r_end ? __ldg(xn + (size_t)row * xn_step) : CUDART_INF_F;
      const bool valid = isfinite(xv);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float sc =
            metric == 0
                ? fmaxf(__fadd_rn(__fsub_rn(qn_s[r], __fmul_rn(2.f, acc[r][j])), xv), 0.f)
                : -acc[r][j];
        acc[r][j] = valid ? sc : CUDART_INF_F;
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

  rt::write_queues<BM>(s, queues, out_v + qoff, out_i + qoff, (long long)splits * k);
  if (tid == 0) skips[m_tile * splits + split] = skipped;
  if (stats != nullptr && tid < 4)
    stats[((size_t)m_tile * splits + split) * 4 + tid] = s.stats[tid];
}

// Exclusive prefix sum of one value per thread into offsets[0..blockDim),
// the total into offsets[blockDim]. Called by all threads; ends
// synchronised.
__device__ inline void block_offsets(int c, int* offsets) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  offsets[threadIdx.x] = before + incl - c;
  if (threadIdx.x == blockDim.x - 1) offsets[blockDim.x] = before + incl;
  __syncthreads();
}

// A 64-bit key whose unsigned order is the (value, index) order of
// rt::pair_less: the value's bits made monotone (-0.0 counted as +0.0),
// then the index with its sign bit flipped.
__device__ __forceinline__ unsigned long long pair_key(float v, int i) {
  unsigned b = __float_as_uint(v + 0.f);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned>(i ^ 0x80000000);
}

// One round of the merge's selection: of the na kept pairs (av, ai) and the
// np gathered pairs (pv, pi), the min(keep, na + np) smallest go to (bv, bi),
// in no particular order. A radix select over pair_key, 8 bits a pass from
// the top, finds the prefix of the keep-th smallest key; pairs below it are
// taken, and of those equal to it (identical pairs, or all of the last
// bucket) as many as still missing. book: 256 histogram counters and 8 more
// ints. Called by all threads; returns the count, synchronised.
__device__ int select_round(const float* av, const int* ai, int na, const float* pv,
                            const int* pi, int np, int keep, float* bv, int* bi, int* book) {
  int* hist = book;
  int* misc = book + 256;
  const int total = na + np, tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const unsigned below_lanes = (1u << lane) - 1u;
  auto key_at = [&](int e) {
    return e < na ? pair_key(av[e], ai[e]) : pair_key(pv[e - na], pi[e - na]);
  };
  unsigned long long prefix = 0, mask = 0;
  int need = total;  // all are taken when they fit
  if (total > keep) {
    need = keep;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += nt) hist[b] = 0;
      __syncthreads();
      for (int base = 0; base < total; base += nt) {
        const int e = base + tid;
        unsigned bin = 256;
        if (e < total) {
          const unsigned long long key = key_at(e);
          if ((key & mask) == prefix) bin = static_cast<unsigned>(key >> shift) & 255u;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
      __syncthreads();
      if (tid < 32) {  // the bucket holding the need-th: one lane finds it
        int c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += c[j] = hist[lane * 8 + j];
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        int run = incl - sum;
        if (run < need && need <= incl) {
          for (int j = 0; j < 8; ++j) {
            if (run + c[j] >= need) {
              misc[0] = lane * 8 + j;
              misc[1] = run;
              misc[2] = c[j];
              break;
            }
            run += c[j];
          }
        }
      }
      __syncthreads();
      const int digit = misc[0], in_bucket = misc[2];
      need -= misc[1];
      prefix |= static_cast<unsigned long long>(digit) << shift;
      mask |= 0xffull << shift;
      __syncthreads();
      if (in_bucket == need) break;  // the whole bucket is taken
    }
  }
  if (tid == 0) misc[3] = misc[4] = 0;  // pairs taken, ties seen
  __syncthreads();
  for (int base = 0; base < total; base += nt) {
    const int e = base + tid;
    bool take = false, tie = false;
    if (e < total) {
      const unsigned long long key = key_at(e) & mask;
      take = key < prefix;
      tie = key == prefix;
    }
    const unsigned ties = __ballot_sync(0xffffffffu, tie);
    const int tie_lead = ties ? __ffs(ties) - 1 : 0;
    int tie0 = 0;
    if (ties && lane == tie_lead) tie0 = atomicAdd(&misc[4], __popc(ties));
    tie0 = __shfl_sync(0xffffffffu, tie0, tie_lead);
    if (tie) take = tie0 + __popc(ties & below_lanes) < need;
    const unsigned takes = __ballot_sync(0xffffffffu, take);
    const int take_lead = takes ? __ffs(takes) - 1 : 0;
    int slot0 = 0;
    if (takes && lane == take_lead) slot0 = atomicAdd(&misc[3], __popc(takes));
    slot0 = __shfl_sync(0xffffffffu, slot0, take_lead);
    if (take) {
      const int slot = slot0 + __popc(takes & below_lanes);
      bv[slot] = e < na ? av[e] : pv[e - na];
      bi[slot] = e < na ? ai[e] : pi[e - na];
    }
  }
  __syncthreads();
  const int taken = misc[3];
  __syncthreads();
  return taken;
}

// Grid (m), kMergeThreads threads. Block `row` reduces the `splits` sorted
// queues of k pairs of one query row to the k smallest pairs of their
// union, sorted, reading only what can reach them:
//   1. a threshold tau: queue s's pair at place (j+1)·stride - 1 has at
//      least (j+1)·stride pairs of its queue at or below it, so the
//      (k / stride)-th smallest of these samples, over all queues, has at
//      least k pairs at or below it, and fewer than k + splits·stride pairs
//      strictly below it;
//   2. per queue, one binary search for its pairs strictly below tau (its
//      candidate prefix);
//   3. the k smallest candidates, sorted, then copies of tau up to k.
// Steps 1 and 3 gather their pairs (samples, candidates) in rounds of
// kPool into shared memory, beside the pairs kept so far, and keep the
// smallest by a radix select (select_round); the kept pairs are sorted once
// at the end (bitonic_sort_rows).
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const float* __restrict__ in_v, const int* __restrict__ in_i,
                     float* __restrict__ out_v, int* __restrict__ out_i, int splits, int k,
                     int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pool_v = reinterpret_cast<float*>(smem);
  int* pool_i = reinterpret_cast<int*>(pool_v + kPool);
  float* kv[2] = {reinterpret_cast<float*>(pool_i + kPool), nullptr};
  int* ki[2] = {reinterpret_cast<int*>(kv[0] + k), nullptr};
  kv[1] = reinterpret_cast<float*>(ki[0] + k);
  ki[1] = reinterpret_cast<int*>(kv[1] + k);
  int* book = ki[1] + k;                 // 256 + 8 ints
  int* offsets = book + 256 + 8;         // kMergeThreads + 1 ints

  const int row = blockIdx.x, tid = threadIdx.x;
  const float* src_v = in_v + (size_t)row * splits * k;
  const int* src_i = in_i + (size_t)row * splits * k;
  int cur = 0, kept = 0;

  // 1. tau from the samples
  const int ks = k / stride, lg_ks = __ffs(ks) - 1;
  const int samples = splits * ks;
  for (int off = 0; off < samples; off += kPool) {
    const int n = min(kPool, samples - off);
    for (int e = tid; e < n; e += kMergeThreads) {
      const int t = off + e;
      const size_t p = (size_t)(t >> lg_ks) * k + ((t & (ks - 1)) + 1) * stride - 1;
      pool_v[e] = __ldg(src_v + p);
      pool_i[e] = __ldg(src_i + p);
    }
    __syncthreads();
    kept = select_round(kv[cur], ki[cur], kept, pool_v, pool_i, n, ks, kv[cur ^ 1],
                        ki[cur ^ 1], book);
    cur ^= 1;
  }
  rt::bitonic_sort_rows(kv[cur], ki[cur], 1, ks, k);  // kept == ks
  const float tau_v = kv[cur][ks - 1];
  const int tau_i = ki[cur][ks - 1];
  __syncthreads();

  // 2 and 3. the candidates below tau, kMergeThreads queues at a time
  kept = 0;
  for (int s0 = 0; s0 < splits; s0 += kMergeThreads) {
    const int nq = min(kMergeThreads, splits - s0);
    int c = 0;
    if (tid < nq) {
      const float* v = src_v + (size_t)(s0 + tid) * k;
      const int* ix = src_i + (size_t)(s0 + tid) * k;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (rt::pair_less(__ldg(v + mid), __ldg(ix + mid), tau_v, tau_i)) lo = mid + 1;
        else hi = mid;
      }
      c = lo;
    }
    block_offsets(c, offsets);
    const int total = offsets[kMergeThreads];
    for (int off = 0; off < total; off += kPool) {
      const int n = min(kPool, total - off);
      for (int e = tid; e < n; e += kMergeThreads) {
        const int f = off + e;
        int lo = 0, hi = nq - 1;  // the last queue whose offset is <= f
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (offsets[mid] <= f) lo = mid;
          else hi = mid - 1;
        }
        const size_t p = (size_t)(s0 + lo) * k + (f - offsets[lo]);
        pool_v[e] = __ldg(src_v + p);
        pool_i[e] = __ldg(src_i + p);
      }
      __syncthreads();
      kept = select_round(kv[cur], ki[cur], kept, pool_v, pool_i, n, k, kv[cur ^ 1],
                          ki[cur ^ 1], book);
      cur ^= 1;
    }
  }

  // the kept candidates sorted, padded to a power of two, then tau
  const int L = kept > 1 ? 1 << (32 - __clz(kept - 1)) : 1;
  for (int l = kept + tid; l < L; l += kMergeThreads) {
    kv[cur][l] = CUDART_INF_F;
    ki[cur][l] = 0x7fffffff;
  }
  __syncthreads();
  rt::bitonic_sort_rows(kv[cur], ki[cur], 1, L, k);
  for (int l = tid; l < k; l += kMergeThreads) {
    out_v[(size_t)row * k + l] = l < kept ? kv[cur][l] : tau_v;
    out_i[(size_t)row * k + l] = l < kept ? ki[cur][l] : tau_i;
  }
}

template <typename T, int BM>
cudaError_t launch_scan(const void* q, const void* x, const void* qn, const void* xn,
                        void* out_v, void* out_i, void* scratch_v, void* scratch_i, void* skips,
                        void* stats, const void* bound_v, const void* bound_i, int m, int n,
                        int dim, int x_pitch, int xn_step, int k, int bn, int metric, int prune,
                        int splits, int tiles_per_split, int cap, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(BM, cap);
  auto kernel = knn_scan_kernel<T, BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(m / BM, splits), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(x), static_cast<const float*>(qn),
      static_cast<const float*>(xn), static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<float*>(scratch_v), static_cast<int*>(scratch_i), static_cast<int*>(skips),
      static_cast<unsigned*>(stats), static_cast<const float*>(bound_v),
      static_cast<const int*>(bound_i), n, dim, x_pitch, xn_step, k, bn, metric, prune,
      tiles_per_split, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scan(int bm, const void* q, const void* x, const void* qn, const void* xn,
                          void* out_v, void* out_i, void* scratch_v, void* scratch_i,
                          void* skips, void* stats, const void* bound_v, const void* bound_i,
                          int m, int n, int dim, int x_pitch, int xn_step, int k, int bn,
                          int metric, int prune, int splits, int tiles_per_split, int cap,
                          cudaStream_t stream) {
#define REPRO_SCAN_LAUNCH(BM)                                                                 \
  launch_scan<T, BM>(q, x, qn, xn, out_v, out_i, scratch_v, scratch_i, skips, stats, bound_v, \
                     bound_i, m, n, dim, x_pitch, xn_step, k, bn, metric, prune, splits,      \
                     tiles_per_split, cap, stream)
  switch (bm) {
    case 1:
      return REPRO_SCAN_LAUNCH(1);
    case 2:
      return REPRO_SCAN_LAUNCH(2);
    case 4:
      return REPRO_SCAN_LAUNCH(4);
    case 8:
      return REPRO_SCAN_LAUNCH(8);
    case 16:
      return REPRO_SCAN_LAUNCH(16);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SCAN_LAUNCH
}

}  // namespace

extern "C" {

// q (m, dim) f32 (the queries widened when x is bf16), x (n, dim) f32
// (bf16 = 0) or bf16 (bf16 = 1), row r at x + r·x_pitch (x_pitch >= dim, a
// multiple of 16 bytes); qn (m,), xn (n,) f32, row r's at xn + r·xn_step;
// out_v / out_i and scratch_v / scratch_i
// (m, splits, k); skips (m / bm, splits) i32; stats null or
// (m / bm, splits, 4) u32; bound_v / bound_i null or (m,) f32 / i32, each
// query's bound: only pairs at or below it enter its queues (a +inf value
// bounds nothing). metric 0 = l2, 1 = ip. Requires m % bm == 0,
// n % bn == 0, dim % 32 == 0, bn a power of two >= 256, k a power of two
// <= bn, bm in {1, 2, 4, 8, 16}, cap a power of two; q and x 16-byte
// aligned.
int knn_scan(const void* q, const void* x, const void* qn, const void* xn, void* out_v,
             void* out_i, void* scratch_v, void* scratch_i, void* skips, void* stats,
             const void* bound_v, const void* bound_i, int m, int n, int dim, int x_pitch,
             int xn_step, int k, int bm, int bn, int metric, int prune, int splits,
             int tiles_per_split, int cap, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_scan<__nv_bfloat16>(bm, q, x, qn, xn, out_v, out_i, scratch_v, scratch_i,
                                          skips, stats, bound_v, bound_i, m, n, dim, x_pitch,
                                          xn_step, k, bn, metric, prune, splits,
                                          tiles_per_split, cap, st)
           : dispatch_scan<float>(bm, q, x, qn, xn, out_v, out_i, scratch_v, scratch_i, skips,
                                  stats, bound_v, bound_i, m, n, dim, x_pitch, xn_step, k, bn,
                                  metric, prune, splits, tiles_per_split, cap, st);
  return static_cast<int>(err);
}

// in_v / in_i (m, splits, k) sorted queues -> out_v / out_i (m, k).
// Requires k a power of two <= 8192, stride a power of two <= k,
// splits·k < 2^31.
int knn_merge(const void* in_v, const void* in_i, void* out_v, void* out_i, int m, int splits,
              int k, int stride, void* stream) {
  const size_t smem = merge_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_merge_kernel<<<m, kMergeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_v), static_cast<const int*>(in_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), splits, k, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
