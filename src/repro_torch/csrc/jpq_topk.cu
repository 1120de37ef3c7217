// PQTopK: fused RecJPQ scoring + exact top-k over the whole catalogue,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel jpq_topk_tiles (src/repro/kernels/jpq_topk/
// jpq_topk.py, pallas_call at :329, body _kernel at :135).  Computes
//     scores[q, i] = sum_{j=0..m-1} P[q, j, codes[i, j]]     (fp32, in order)
// and returns the top k per query by (value desc, id asc), without the
// [B, N] score matrix ever reaching device memory.
//
// What bounds it.  The inputs are small (codes N*m bytes, LUT B*m*b*4
// bytes: 8 MB + 4 MB at N = 10^6, B = 512, m = 8, b = 256), so the card's
// memory rate is not the limit; the B*N*m table lookups are.  They are
// gathers from a per-query table, so they run from shared memory, 32
// 4-byte words an SM and clock (about 0.49 ms at the sizes above), not on
// tensor cores (the TPU kernel's one-hot matmul would round P in TF32).
// Gathers by item (a lane an item, a random code each) collide in the
// banks: 32 random codes over 256 about 3.15-way.
//
// Design: lanes are queries, as in jpq_scores.cu's forward.
//   - A block holds the LUT of G queries in shared memory, laid out
//     [m][b][G], so one (j, c) row of the G queries is G / 4 float4s.  A
//     warp is 4 item groups of 8 lanes; lane ch of a group sums the float4
//     of queries 4ch..4ch+3 for FIT = 4 consecutive items, in split order
//     from the j = 0 term (the reference gather-sum, bit for bit).  A
//     quarter warp reads one row as consecutive 16-byte words: no bank
//     conflict, 4 queries a load, so the floor is one shared-memory
//     wavefront an (item, split, group of G).  32 warps a block (64
//     registers a thread) hide the loads' latency better than 8 or 16
//     warps with FIT = 8.  For uint8 codes at m = 8 on an 8-byte aligned
//     row, an item's codes are one 8-byte broadcast load; any other m or
//     code type takes the general path (code by code).
//   - Selection.  Each lane keeps its 4 queries' current k-th values
//     (theta) in registers; a score below its theta is dropped with one
//     float compare, so no key, id or ballot is made for it.  Where some
//     lane of a warp passes, the warp makes the 64-bit keys of
//     jpq_common.cuh, tests them against the k-th listed key, and
//     reserves slots in each query's candidate buffer (shared memory, C
//     keys a query) with one atomicAdd a query: the lanes of a query
//     count their keys and scan them across the 4 item groups first.  A
//     reservation that does not fit fails for that query: its slots below
//     C get the key ~0, which never ranks in, and the warp scores the
//     step again after the next merge for the failed queries alone.  So
//     no candidate is dropped whatever the scores do (scores that rise
//     along the sweep make every item a candidate), and each (item,
//     query) enters once.
//   - Steps.  Between two barriers each warp scores up to `quota` warp
//     steps of its own contiguous items; the quota starts at one (the
//     first step scores 64 items, so a cold list merges them by counting
//     at k <= 64) and doubles: a theta that lags the list lets more
//     scores into the slower path, so merges are not put off further.  A block-wide merge then folds each
//     query's candidates into its sorted running list by rank (every
//     element finds its rank in list + candidates and lands there in the
//     other list buffer; candidates are sorted first only when a query
//     has more than 64), and theta is read again.
//   - Grid (item range, query group of G), one block an SM.  The host
//     plans the ranges (cuda.range_plan) so that the blocks fill their
//     last wave; G is the most queries, a multiple of 4, whose LUT,
//     lists and candidate buffers fit (jpq_topk_group: 24 at k = 10,
//     m b = 2,048).  Each range writes its sorted top-k as keys; a
//     second launch merges the ranges x k keys of each query the same way
//     and writes the sorted result.
// Keys are unique per (value, id), so the result is exact and bit-equal
// to the reference.
#include "jpq_common.cuh"
#include "smem.cuh"

namespace jpq {
namespace topk {

using smem::lds4;

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 1024;            // threads a block (both kernels)
constexpr int NW = NT / 32;         // warps a block
constexpr int GMAX = 28;            // most queries a block: 7 float4s a row
constexpr int FIT = 4;              // consecutive items a lane
constexpr int WSTEP = 4 * FIT;      // items a warp step: 4 groups of 8 lanes
constexpr int BSTEP = NW * WSTEP;   // items a block step; ranges are planned in these
constexpr int SMALL_C = 64;         // merge by counting up to this many candidates
constexpr int FIRST_WARPS = SMALL_C / WSTEP;  // warps that score the first step
constexpr int CMIN = 128;           // least candidate slots a query
constexpr int CMAX = 512;           // most candidate slots a query
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use (227 KB)
// the merge kernel's candidate buffer holds NT keys, and a merge sorts
// within a power of two of its capacity
static_assert((NT & (NT - 1)) == 0, "NT is a power of two");

// Dynamic shared memory of a range block: the LUT [m b][G] floats, the
// lists 2 x [G, k] keys, the candidates [G, C] keys, the counts [G].
__host__ __device__ inline size_t smem_bytes(int G, int k, int m, int b,
                                             int C) {
  return static_cast<size_t>(G) * m * b * 4 +
         static_cast<size_t>(2) * G * k * 8 + static_cast<size_t>(G) * C * 8 +
         static_cast<size_t>(G) * 4;
}

// Candidate slots a query at G queries a block: the most, a power of two
// in [CMIN, CMAX], that fit; 0 if CMIN do not.
inline int cand_slots(int G, int k, int m, int b) {
  for (int C = CMAX; C >= CMIN; C >>= 1)
    if (smem_bytes(G, k, m, b, C) <= SMEM_MAX) return C;
  return 0;
}

// Queries a range block: the most, a multiple of 4 and at most GMAX,
// whose shared memory fits; 0 if 4 do not.
inline int group(int k, int m, int b) {
  for (int G = GMAX; G >= 4; G -= 4)
    if (cand_slots(G, k, m, b) > 0) return G;
  return 0;
}

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x = a.x + v.x;
  a.y = a.y + v.y;
  a.z = a.z + v.z;
  a.w = a.w + v.w;
}

__device__ __forceinline__ float part(const float4& a, int r) {
  return r == 0 ? a.x : r == 1 ? a.y : r == 2 ? a.z : a.w;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

// Keys of x[0..n) below v (lower) or at most v (upper); x ascending.
__device__ __forceinline__ int lower_bound(const uint64_t* x, int n,
                                           uint64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int upper_bound(const uint64_t* x, int n,
                                           uint64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Ascending sort of nseg segments of P keys each (P a power of two);
// segment q starts at x + q * stride.  Ends with a barrier.
__device__ void seg_sort(uint64_t* x, int nseg, int P, int stride) {
  const int n = nseg * P;
  for (int size = 2; size <= P; size <<= 1) {
    for (int half = size >> 1; half > 0; half >>= 1) {
      for (int i = threadIdx.x; i < n; i += NT) {
        const int q = i / P, li = i - q * P;
        const int lj = li ^ half;
        if (lj > li) {
          const bool up = (li & size) == 0;
          uint64_t* seg = x + static_cast<size_t>(q) * stride;
          const uint64_t a = seg[li], b = seg[lj];
          if ((a > b) == up) {
            seg[li] = b;
            seg[lj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Fold each query's candidates (cands[q C + 0..min(cnt[q], C))) into its
// sorted list (lists + cur G k): the k smallest of list + candidates,
// sorted, into the other list buffer, which becomes live (cur flips).
// Block-uniform; cmax = max_q min(cnt[q], C) > 0; ends with a barrier,
// after which cnt[0..G) is reset (the caller's next barrier publishes
// it).  C is a power of two.
__device__ void merge(uint64_t* lists, uint64_t* cands, int nq, int G, int k,
                      int C, int cmax, int* cnt, int& cur) {
  const uint64_t* L = lists + cur * G * k;
  uint64_t* Ln = lists + (1 - cur) * G * k;
  const bool sorted = cmax > SMALL_C;
  if (sorted) {
    const int P = pow2_at_least(cmax);  // <= C
    for (int i = threadIdx.x; i < nq * P; i += NT) {
      const int q = i / P, e = i - q * P;
      if (e >= min(cnt[q], C)) cands[q * C + e] = ~0ull;
    }
    __syncthreads();
    seg_sort(cands, nq, P, C);
  }
  const int w = k + cmax;
  for (int x = threadIdx.x; x < nq * w; x += NT) {
    const int q = x / w, e = x - q * w;
    const int c = min(cnt[q], C);
    if (e >= k + c) continue;
    const uint64_t* Cq = cands + q * C;
    const uint64_t* Lq = L + q * k;
    uint64_t v;
    int r;
    if (e < k) {
      v = Lq[e];
      if (sorted) {
        r = e + lower_bound(Cq, c, v);
      } else {
        r = e;
        for (int a = 0; a < c; ++a) r += Cq[a] < v;
      }
    } else {
      const int a = e - k;
      v = Cq[a];
      r = upper_bound(Lq, k, v);
      if (sorted) {
        r += a;
      } else {
        for (int i = 0; i < c; ++i) r += Cq[i] < v || (Cq[i] == v && i < a);
      }
    }
    if (r < k) Ln[q * k + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < G) cnt[threadIdx.x] = 0;
  cur = 1 - cur;
}

// The FIT scores of a lane's items i0..i0+FIT-1 for its 4 queries, each
// the fp32 sum in split order j = 0..m-1.  Items at or past `end` score
// code 0 and are never selected.  base: the shared address of the lane's
// float4 at (j, c) = (0, 0); row: bytes a (j, c) row; split: bytes a
// split.  MC = 8: uint8 codes, 8 a row, 8-byte aligned (one load an
// item); MC = 0: any m and code type.
template <typename CodeT, int MC>
__device__ __forceinline__ void score(float4 (&acc)[FIT],
                                      const CodeT* __restrict__ codes, int m,
                                      int i0, int end, unsigned base,
                                      unsigned row, unsigned split) {
  if constexpr (MC == 8) {
    uint2 w[FIT];
#pragma unroll
    for (int s = 0; s < FIT; ++s)
      w[s] = i0 + s < end
                 ? __ldg(reinterpret_cast<const uint2*>(codes) + i0 + s)
                 : make_uint2(0u, 0u);
#pragma unroll
    for (int s = 0; s < FIT; ++s) acc[s] = lds4(base + (w[s].x & 0xFFu) * row);
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const unsigned bj = base + j * split;
#pragma unroll
      for (int s = 0; s < FIT; ++s) {
        const unsigned c =
            __byte_perm(j < 4 ? w[s].x : w[s].y, 0u, 0x4440u | (j & 3));
        add4(acc[s], lds4(bj + c * row));
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < FIT; ++s) {
      const unsigned c =
          i0 + s < end ? static_cast<unsigned>(codes[static_cast<size_t>(i0 + s) * m])
                       : 0u;
      acc[s] = lds4(base + c * row);
    }
    for (int j = 1; j < m; ++j) {
      const unsigned bj = base + j * split;
#pragma unroll
      for (int s = 0; s < FIT; ++s) {
        const unsigned c =
            i0 + s < end
                ? static_cast<unsigned>(codes[static_cast<size_t>(i0 + s) * m + j])
                : 0u;
        add4(acc[s], lds4(bj + c * row));
      }
    }
  }
}

// The warp's candidates of one warp step, for the queries in qsel (bit q
// of the block's group): each (item, query) of a lane whose key beats the
// query's k-th listed key (L sorted).  The lanes of a query (lane ch of
// the 4 item groups) count their keys and scan the counts; the last group
// reserves them with one atomicAdd a query.  A query whose reservation
// overruns C fails: its reserved slots below C get ~0.  Warp-uniform;
// returns the failed queries (warp-uniform) and sets `reserved` when the
// warp reserved any slot.
__device__ __forceinline__ unsigned append_step(
    const float4 (&acc)[FIT], const float4 th, int i0, int end, int ch,
    int grp, int nr, unsigned qsel, const uint64_t* L, int k,
    uint64_t* cands, int C, int* cnt, bool& reserved) {
  const unsigned rsel = (qsel >> (4 * ch)) & ((1u << nr) - 1u);
  unsigned pass = 0;  // bit 4 s + r: item i0 + s enters query 4 ch + r
#pragma unroll
  for (int s = 0; s < FIT; ++s) {
    // a branch an item, taken only by lanes whose score may enter; a
    // score above theta's value enters without its key
    const float4 a = acc[s];
    const unsigned may = ((!(a.x < th.x)) | (!(a.y < th.y) << 1) |
                          (!(a.z < th.z) << 2) | (!(a.w < th.w) << 3)) &
                         rsel & (i0 + s < end ? 0xFu : 0u);
    if (may) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = part(a, r);
        if (((may >> r) & 1u) &&
            (v > part(th, r) ||
             make_key(v, i0 + s) < L[(4 * ch + r) * k + k - 1]))
          pass |= 1u << (4 * s + r);
      }
    }
  }
  if (!__any_sync(FULL, pass != 0)) return 0;
  // per-query counts of this lane, a byte each (at most 32 a warp)
  unsigned mine = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    mine |= static_cast<unsigned>(__popc(pass & (0x11111111u << r))) << (8 * r);
  unsigned incl = mine;
  unsigned y = __shfl_up_sync(FULL, incl, 8);
  if (grp >= 1) incl += y;
  y = __shfl_up_sync(FULL, incl, 16);
  if (grp >= 2) incl += y;
  const unsigned tot = __shfl_sync(FULL, incl, 24 + ch);
  int old[4] = {0, 0, 0, 0};
  if (grp == 3) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = static_cast<int>((tot >> (8 * r)) & 0xFFu);
      if (n > 0) old[r] = atomicAdd(&cnt[4 * ch + r], n);
    }
  }
  unsigned failed = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    old[r] = __shfl_sync(FULL, old[r], 24 + ch);
    const int n = static_cast<int>((tot >> (8 * r)) & 0xFFu);
    if (n > 0 && old[r] + n > C) failed |= 1u << r;
  }
  reserved = true;
  unsigned off = incl - mine;  // this lane's first slot past old, a byte a query
#pragma unroll
  for (int s = 0; s < FIT; ++s) {
    if ((pass >> (4 * s)) & 0xFu) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if ((pass >> (4 * s + r)) & 1u) {
          const int slot = old[r] + static_cast<int>((off >> (8 * r)) & 0xFFu);
          off += 1u << (8 * r);
          uint64_t* dst = cands + (4 * ch + r) * C + slot;
          if (!((failed >> r) & 1u))
            *dst = make_key(part(acc[s], r), i0 + s);
          else if (slot < C)
            *dst = ~0ull;
        }
      }
    }
  }
  return __reduce_or_sync(FULL, failed << (4 * ch));
}

// Pass 1, grid (item range, query group): the exact top-k of each query
// over the block's range, sorted, as keys into cand_out [B, ranges, k].
template <typename CodeT, int MC>
__global__ void __launch_bounds__(NT, 1)
    range_kernel(const float* __restrict__ P, const CodeT* __restrict__ codes,
                 int B, int m, int b, int N, int k, int G, int C, int range,
                 uint64_t* __restrict__ cand_out) {
  extern __shared__ float4 lut4[];  // [m b][G / 4], then lists, cands, cnt
  const int mb = m * b;
  const int G4 = G / 4;
  uint64_t* lists = reinterpret_cast<uint64_t*>(lut4 + static_cast<size_t>(mb) * G4);
  uint64_t* cands = lists + 2 * G * k;
  int* cnt = reinterpret_cast<int*>(cands + static_cast<size_t>(G) * C);
  const int q0 = blockIdx.y * G;
  const int nq = min(G, B - q0);
  for (int jc = threadIdx.x; jc < mb; jc += NT) {
    for (int c4 = 0; c4 < G4; ++c4) {
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = 4 * c4 + r;
        v[r] = q < nq ? P[static_cast<size_t>(q0 + q) * mb + jc] : 0.f;
      }
      lut4[jc * G4 + c4] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // sentinel: worse than any real item (-inf at the largest id)
  const uint64_t sentinel = make_key(-INFINITY, 0x7FFFFFFF);
  for (int i = threadIdx.x; i < G * k; i += NT) lists[i] = sentinel;
  if (threadIdx.x < G) cnt[threadIdx.x] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 3, ch = lane & 7;
  const int nr = max(0, min(4, nq - 4 * ch));  // this lane's live queries
  const unsigned row = static_cast<unsigned>(G) * 4u;  // bytes a (j, c) row
  const unsigned split = static_cast<unsigned>(b) * row;
  // idle lanes read chunk 0 (inside the LUT) and select nothing
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(lut4)) +
                        (nr > 0 ? ch : 0) * 16u;
  // the warp's own contiguous items [w0, w1) of the block's range
  const long long r0 = static_cast<long long>(blockIdx.x) * range;
  const long long r1 = min(static_cast<long long>(N), r0 + range);
  const long long per_warp = (range + BSTEP - 1LL) / BSTEP * WSTEP;
  const int w0 = static_cast<int>(min(r1, r0 + warp * per_warp));
  const int w1 = static_cast<int>(min(r1, w0 + per_warp));

  int cur = 0;
  float4 th;
  auto read_theta = [&]() {
    const uint64_t* L = lists + cur * G * k;
    float t[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      t[r] = r < nr ? key_value(L[(4 * ch + r) * k + k - 1]) : INFINITY;
    th = make_float4(t[0], t[1], t[2], t[3]);
  };
  read_theta();
  const unsigned all = G >= 32 ? FULL : (1u << G) - 1u;
  unsigned qsel = all;  // the queries the warp step at pos still owes
  int pos = w0;
  for (int t = 0;; ++t) {
    int quota = t == 0 ? (warp < FIRST_WARPS ? 1 : 0) : 1 << min(t - 1, 30);
    const uint64_t* L = lists + cur * G * k;
    bool reserved = false;
    for (; quota > 0 && pos < w1; --quota) {
      const int i0 = pos + grp * FIT;
      float4 acc[FIT];
      score<CodeT, MC>(acc, codes, m, i0, w1, base, row, split);
      // a float test first: a score below theta's value cannot enter
      bool pre = false;
#pragma unroll
      for (int s = 0; s < FIT; ++s) {
        pre |= !(acc[s].x < th.x);
        pre |= !(acc[s].y < th.y);
        pre |= !(acc[s].z < th.z);
        pre |= !(acc[s].w < th.w);
      }
      pre = pre && nr > 0 && i0 < w1;
      if (__any_sync(FULL, pre)) {
        const unsigned failed = append_step(acc, th, i0, w1, ch, grp, nr, qsel,
                                            L, k, cands, C, cnt, reserved);
        if (failed) {  // score this step again after the merge
          qsel = failed;
          break;
        }
      }
      qsel = all;
      pos += WSTEP;
    }
    if (__syncthreads_or(reserved)) {
      int cmax = 0;
      for (int q = 0; q < nq; ++q) cmax = max(cmax, min(cnt[q], C));
      merge(lists, cands, nq, G, k, C, cmax, cnt, cur);
      read_theta();
    }
    if (__syncthreads_and(pos >= w1)) break;
  }
  const uint64_t* L = lists + cur * G * k;  // sorted: write it out
  const size_t R = gridDim.x;
  for (int i = threadIdx.x; i < nq * k; i += NT) {
    const int q = i / k;
    cand_out[(static_cast<size_t>(q0 + q) * R + blockIdx.x) * k + (i - q * k)] =
        L[i];
  }
}

// Pass 2, a block a query: the k smallest of its `total` range keys (runs
// of k, each sorted), streamed NT at a time against the running list's
// k-th key and merged as above; writes the list as values and ids.
__global__ void __launch_bounds__(NT)
    merge_kernel(const uint64_t* __restrict__ cand_g, int total, int k,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ uint64_t sm[];  // lists 2 x [k], candidates [NT]
  __shared__ int cnt;
  uint64_t* lists = sm;
  uint64_t* cands = sm + 2 * k;
  const size_t row = blockIdx.x;
  const uint64_t* src = cand_g + row * total;
  for (int i = threadIdx.x; i < k; i += NT) lists[i] = ~0ull;
  if (threadIdx.x == 0) cnt = 0;
  __syncthreads();
  int cur = 0;
  for (int s0 = 0; s0 < total; s0 += NT) {
    const uint64_t th = lists[cur * k + k - 1];
    const int i = s0 + threadIdx.x;
    if (i < total) {
      const uint64_t key = src[i];
      if (key < th) cands[atomicAdd(&cnt, 1)] = key;
    }
    __syncthreads();
    const int c = cnt;
    if (c > 0) merge(lists, cands, 1, 1, k, NT, c, &cnt, cur);
    __syncthreads();
  }
  const uint64_t* L = lists + cur * k;
  for (int i = threadIdx.x; i < k; i += NT) {
    out_v[row * k + i] = key_value(L[i]);
    out_i[row * k + i] = key_id(L[i]);
  }
}

template <typename CodeT, int MC>
int launch_t(const float* P, const void* codes, int B, int m, int b, int N,
             int k, int G, int C, int range, dim3 grid, uint64_t* cand,
             float* out_v, int* out_i, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, k, m, b, C);
  cudaError_t err = cudaFuncSetAttribute(
      range_kernel<CodeT, MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  range_kernel<CodeT, MC><<<grid, NT, smem, stream>>>(
      P, static_cast<const CodeT*>(codes), B, m, b, N, k, G, C, range, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<B, NT, (static_cast<size_t>(2) * k + NT) * 8, stream>>>(
      cand, static_cast<int>(grid.x) * k, k, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace topk
}  // namespace jpq

extern "C" {

// The top-k with G queries a block (jpq_topk_group's) and item ranges of
// `range` items (cuda.range_plan's, or the caller's chunk); cand is
// scratch of [B, ceil(N / range), k] keys.  Writes the grid it launched,
// (item ranges, query groups, warps a block), to grid[0..2].  Returns 0, a
// CUDA error code (> 0), or -1 for arguments the kernels do not take (the
// Python wrapper checks them first and names the limit).
int jpq_topk_launch(const void* lut, const void* codes, int code_bytes, int B,
                    int m, int b, int N, int k, int G, int range, void* cand,
                    void* out_v, void* out_i, int* grid, void* stream) {
  namespace t = jpq::topk;
  if (B < 1 || m < 1 || b < 1 || N < 1 || k < 1 || k > jpq::KMAX || k > N ||
      range < 1 || (code_bytes != 1 && code_bytes != 4) || G < 4 ||
      G > t::GMAX || G % 4 != 0 || (B + G - 1) / G > 65535 ||
      static_cast<long long>((N - 1) / range + 1) * k > 0x7FFFFFFFLL)
    return -1;
  const int C = t::cand_slots(G, k, m, b);
  if (C == 0) return -1;
  const dim3 gr((N - 1) / range + 1, (B + G - 1) / G);
  grid[0] = static_cast<int>(gr.x);
  grid[1] = static_cast<int>(gr.y);
  grid[2] = t::NW;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lut);
  auto c = static_cast<uint64_t*>(cand);
  auto v = static_cast<float*>(out_v);
  auto i = static_cast<int*>(out_i);
  if (code_bytes == 4)
    return t::launch_t<int32_t, 0>(l, codes, B, m, b, N, k, G, C, range, gr, c,
                                   v, i, st);
  if (m == 8 && reinterpret_cast<uintptr_t>(codes) % 8 == 0)
    return t::launch_t<uint8_t, 8>(l, codes, B, m, b, N, k, G, C, range, gr, c,
                                   v, i, st);
  return t::launch_t<uint8_t, 0>(l, codes, B, m, b, N, k, G, C, range, gr, c,
                                 v, i, st);
}

// Queries a block at (k, m, b); 0 when the LUT, lists and candidate
// buffers of 4 do not fit a block's shared memory.
int jpq_topk_group(int k, int m, int b) {
  return k < 1 || m < 1 || b < 1 ? 0 : jpq::topk::group(k, m, b);
}

// Items a block step: a planned item range is a whole number of them.
int jpq_topk_step() { return jpq::topk::BSTEP; }

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
