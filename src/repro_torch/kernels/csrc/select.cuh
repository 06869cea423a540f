// Survivor selection: fold a batch of candidate (value, index) pairs, held
// in registers, into R sorted queues of K pairs without sorting the batch.
// Shared by knn_scan (knn.cu), knn_int8_scan (knn_int8.cu) and topk_scan
// (topk.cu).
//
// Per pass, every thread of the block:
//   1. keeps the lanes with pair_less(v, i, worst_v, worst_i) against its
//      row's queue (worst = the queue's last pair; an empty slot is
//      (+inf, -1), so +inf lanes never enter and a lane tying the worst
//      value with a smaller index does), and appends them to the row's
//      survivor buffer in shared memory (warp ballot + prefix count, one
//      atomic per warp and row);
//   2. the survivors are sorted: a few per row (at most kCountMax, and at
//      most 4 per thread in all) by counting each one's rank among them, in
//      one step; more, padded to the next power of two, with
//      bitonic_sort_rows;
//   3. the sorted survivors are merged into the queue by rank (merge
//      path): each thread writes a run of consecutive places of the new
//      queue; one binary search along its first place's diagonal finds
//      how many queue pairs and survivors come before the run, and the run
//      is then merged one comparison per place. What lands past K falls
//      off. The queue is read once, in order, and the new queue goes to
//      the other of two buffers.
// A batch with more survivors in a row than the buffer holds (the first
// batches, or scores in adversarial order) takes several passes: lanes not
// yet appended stay pending, are filtered again against the tightened
// queue, and are never dropped unless the queue beats them. The queue
// after the batch is the K smallest pairs of (queue ∪ batch), whatever the
// passes, so the result is that of a full sort per batch.
//
// The queues need no initialisation: only the first `fill` pairs of a row
// are real, the rest read as (+inf, -1), and write_queues fills them in.
// They may live in shared or device memory; in device memory they are read
// through the coherent path only (never __ldg), since the block rewrites
// them.
#pragma once

#include <math_constants.h>
#include <stdint.h>

#include "bitonic.cuh"

namespace rt {

constexpr int kPadIndex = 0x7fffffff;  // pads the survivor sort: after every real pair
constexpr int kCountMax = 256;         // most survivors a row sorts by counting ranks

// R rows of K sorted pairs in two buffers; row r of buffer b starts at
// v[b] + r·stride.
struct Queues {
  float* v[2];
  int* i[2];
  long long stride;
  int K;
};

// Bookkeeping and the survivor buffer, all in shared memory. Counters of
// the work done (survivors, passes, sort comparisons, queue pairs moved)
// go to stats[0..3].
struct Survivors {
  float* v;         // R × cap survivor values
  int* i;           // R × cap survivor indices
  int* count;       // R: lanes appended this pass (may exceed cap)
  int* fill;        // R: real pairs in the queue
  int* cur;         // R: the buffer holding the queue
  float* worst_v;   // R: the queue's last pair
  int* worst_i;
  unsigned* stats;  // 4 counters
  int cap;          // buffer lanes per row, a power of two
};

// Bytes of bookkeeping carve_survivors takes for up to 16 rows (the
// wrappers' shared-memory formulas count this constant).
constexpr int kSelectBookBytes = 1024;

// Lay the bookkeeping out at `book` (kSelectBookBytes) and the buffer of
// R rows at `buf` (R·cap·8 bytes); zero the counters. Called by all
// threads; ends synchronised.
template <int R>
__device__ inline Survivors carve_survivors(void* book, void* buf, int cap) {
  static_assert(R <= 16, "bookkeeping is sized for 16 rows");
  Survivors s;
  int* b = static_cast<int*>(book);
  s.count = b;
  s.fill = b + 16;
  s.cur = b + 32;
  s.worst_v = reinterpret_cast<float*>(b + 48);
  s.worst_i = b + 64;
  s.stats = reinterpret_cast<unsigned*>(b + 80);
  s.v = static_cast<float*>(buf);
  s.i = reinterpret_cast<int*>(s.v + R * cap);
  s.cap = cap;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    s.count[r] = 0;
    s.fill[r] = 0;
    s.cur[r] = 0;
    s.worst_v[r] = CUDART_INF_F;
    s.worst_i[r] = -1;
  }
  if (threadIdx.x < 4) s.stats[threadIdx.x] = 0;
  __syncthreads();
  return s;
}

// Step 1 for this thread's candidates: bit r·P + j of `pending` marks lane
// (r, j) as still to place. Lanes the queue beats leave `pending`; lanes
// appended leave it; lanes that find the buffer full stay.
template <int R, int P>
__device__ __forceinline__ void append_survivors(const float (&v)[R][P], const int (&ix)[P],
                                                 uint64_t& pending, const Survivors& s) {
  static_assert(R * P <= 64, "one pending bit per lane");
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float wv = s.worst_v[r];
    const int wi = s.worst_i[r];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const uint64_t bit = 1ull << (r * P + j);
      const bool want = (pending & bit) && pair_less(v[r][j], ix[j], wv, wi);
      if (!want) pending &= ~bit;
      const unsigned mask = __ballot_sync(0xffffffffu, want);
      if (mask == 0) continue;
      const int leader = __ffs(mask) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&s.count[r], __popc(mask));
      base = __shfl_sync(0xffffffffu, base, leader);
      const int slot = base + __popc(mask & below);
      if (want && slot < s.cap) {
        s.v[r * s.cap + slot] = v[r][j];
        s.i[r * s.cap + slot] = ix[j];
        pending &= ~bit;
      }
    }
  }
}

// Steps 2 and 3 for every row of the block. Called by all threads after
// append_survivors; returns synchronised.
template <int R>
__device__ inline void merge_survivors(const Survivors& s, const Queues& q) {
  __syncthreads();
  const int tid = threadIdx.x, nt = blockDim.x;
  int cmax = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) cmax = max(cmax, min(s.count[r], s.cap));
  if (cmax == 0) return;  // block-uniform: every thread read the same counts
  const int L = 1 << (32 - __clz(cmax - 1)), lg = __ffs(L) - 1;

  const bool counted = L <= kCountMax && R * L <= 4 * nt;
  unsigned comparisons = counted ? 0u : (unsigned)R * (L >> 1) * (lg * (lg + 1) / 2);
  if (counted) {
    // rank = survivors of the row below this one; every rank is found
    // before any survivor moves to its place
    float v[4];
    int ix[4], rank[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = tid + u * nt, r = min(e >> lg, R - 1), t = e & (L - 1);
      const int c = e < R * L ? min(s.count[r], s.cap) : 0;
      rank[u] = -1;
      if (t < c) {
        const float* sv = s.v + r * s.cap;
        const int* si = s.i + r * s.cap;
        v[u] = sv[t];
        ix[u] = si[t];
        int below = 0;
        for (int w = 0; w < c; ++w) below += pair_less(sv[w], si[w], v[u], ix[u]);
        rank[u] = below;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (rank[u] < 0) continue;
      const int r = (tid + u * nt) >> lg;
      s.v[r * s.cap + rank[u]] = v[u];
      s.i[r * s.cap + rank[u]] = ix[u];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned c = min(s.count[r], s.cap);
      comparisons += c * c;
    }
  } else {
    for (int e = tid; e < R * L; e += nt) {
      const int r = e >> lg, l = e & (L - 1);
      if (l >= min(s.count[r], s.cap)) {
        s.v[r * s.cap + l] = CUDART_INF_F;
        s.i[r * s.cap + l] = kPadIndex;
      }
    }
    __syncthreads();
    bitonic_sort_rows(s.v, s.i, R, L, s.cap);
  }
  if (tid == 0) {  // counts and fills stay as they are until the last phase
    unsigned kept = 0, moved = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = min(s.count[r], s.cap);
      kept += c;
      moved += c ? s.fill[r] + c : 0;
    }
    s.stats[0] += kept;
    s.stats[1] += 1;
    s.stats[2] += comparisons;
    s.stats[3] += moved;
  }

  // Merge path. A row's new queue is its first min(K, fill + c) places;
  // thread work item w writes places [o0, o0 + E) of one row, where E
  // spreads the R·K places over the block (4 to 8 a thread, at most K:
  // short runs keep a warp's reads and writes within a few lines).
  const int K = q.K;
  const int E = min(K, min(8, max(4, R * K / nt))), items = K / E;
  for (int w = tid; w < R * items; w += nt) {
    const int r = w / items, o0 = (w - r * items) * E;
    const int c = min(s.count[r], s.cap), fill = s.fill[r];
    const int n_out = min(K, fill + c);
    if (c == 0 || o0 >= n_out) continue;
    const float* qv = q.v[s.cur[r]] + r * q.stride;
    const int* qi = q.i[s.cur[r]] + r * q.stride;
    float* dv = q.v[s.cur[r] ^ 1] + r * q.stride;
    int* di = q.i[s.cur[r] ^ 1] + r * q.stride;
    const float* sv = s.v + r * s.cap;
    const int* si = s.i + r * s.cap;
    // a = queue pairs among the first o0 places: queue pair m is among them
    // iff it is below survivor o0 - m - 1
    int lo = max(0, o0 - c), hi = min(o0, fill);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pair_less(qv[mid], qi[mid], sv[o0 - mid - 1], si[o0 - mid - 1])) lo = mid + 1;
      else hi = mid;
    }
    int a = lo, b = o0 - lo;
    float av = a < fill ? qv[a] : CUDART_INF_F, bv = b < c ? sv[b] : CUDART_INF_F;
    int ai = a < fill ? qi[a] : kPadIndex, bi = b < c ? si[b] : kPadIndex;
    for (int o = o0; o < min(o0 + E, n_out); ++o) {
      if (pair_less(av, ai, bv, bi)) {
        dv[o] = av;
        di[o] = ai;
        ++a;
        av = a < fill ? qv[a] : CUDART_INF_F;
        ai = a < fill ? qi[a] : kPadIndex;
      } else {
        dv[o] = bv;
        di[o] = bi;
        ++b;
        bv = b < c ? sv[b] : CUDART_INF_F;
        bi = b < c ? si[b] : kPadIndex;
      }
    }
  }
  __syncthreads();

  for (int r = tid; r < R; r += nt) {
    const int c = min(s.count[r], s.cap);
    s.count[r] = 0;
    if (c == 0) continue;
    const int dst = s.cur[r] ^ 1, fill = min(K, s.fill[r] + c);
    s.cur[r] = dst;
    s.fill[r] = fill;
    if (fill == K) {
      s.worst_v[r] = q.v[dst][r * q.stride + K - 1];
      s.worst_i[r] = q.i[dst][r * q.stride + K - 1];
    }
  }
  __syncthreads();
}

// Fold this thread's candidates into the queues, in as many passes as the
// buffer needs. Called by all threads; returns synchronised.
template <int R, int P>
__device__ __forceinline__ void select_into_queues(const float (&v)[R][P], const int (&ix)[P],
                                          uint64_t pending, const Survivors& s,
                                          const Queues& q) {
  for (;;) {
    append_survivors<R, P>(v, ix, pending, s);
    merge_survivors<R>(s, q);
    if (!__syncthreads_or(pending != 0)) return;
  }
}

// Write each row's queue to out (row r at out_v + r·out_stride): its real
// pairs from the buffer holding it (skipped when that buffer is out), then
// (+inf, -1) for the empty slots. Called by all threads; returns
// synchronised.
template <int R>
__device__ inline void write_queues(const Survivors& s, const Queues& q, float* out_v,
                                    int* out_i, long long out_stride) {
  for (int r = 0; r < R; ++r) {
    const int fill = s.fill[r];
    const float* sv = q.v[s.cur[r]] + r * q.stride;
    const int* si = q.i[s.cur[r]] + r * q.stride;
    float* dv = out_v + r * out_stride;
    int* di = out_i + r * out_stride;
    const bool copy = sv != dv;
    for (int l = threadIdx.x; l < q.K; l += blockDim.x) {
      if (l >= fill) {
        dv[l] = CUDART_INF_F;
        di[l] = -1;
      } else if (copy) {
        dv[l] = sv[l];
        di[l] = si[l];
      }
    }
  }
  __syncthreads();
}

}  // namespace rt
