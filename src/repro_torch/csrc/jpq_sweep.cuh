// The running-top-k sweep of a group of SG = 4 queries by a block of
// SNT = 1,024 threads (jpq_topk_pruned.cu): the block scores item ranges,
// keeps SG running lists sorted in shared memory and merges the rare
// items that beat a list's k-th key.  (jpq_topk.cu has a sweep of its
// own, with lanes that are queries.)
//
// What it does about the costs of a sweep whose lanes are items (a
// 256-thread sweep of 4-byte gathers, which the port's first kernels
// used):
//   - 32 warps an SM, not 8, to hide the shared-memory gathers;
//   - the LUT of the SG queries is laid out [m][b][SG], so an item's
//     (j, c) entry of all SG queries is one 16-byte load (a quarter of
//     the load instructions; random codes still collide in the banks of
//     a quarter warp, about 2.2-way, against 3.15-way for 32 lanes of
//     4-byte loads);
//   - uint8 codes at m = 8 load as one 8 bytes an item;
//   - a score is compared with theta's value (a float kept in registers
//     beside the key) first; the 64-bit key, the item's id and the ballot
//     that appends it are made only in a warp where some lane passes;
//   - lists stay sorted, so theta is the list's last key, and a merge is
//     one barrier: every element of list + candidates finds its rank
//     (its list position or a binary search in the list, plus a count of
//     the smaller candidates) and lands there, in the other list buffer,
//     if it is below k; the candidate counts come in two sets used by
//     turns, so a merge resets its set without a barrier of its own.
//     Only when a query has more than SMALL_C candidates are they sorted
//     first (bitonic), and the count becomes a binary search too;
//   - merge steps start small (the power of two >= k, at least SMALL_C
//     rows) and double up to `sub`, so the first steps against a cold
//     list, where every row is a candidate, sort nothing at k <= SMALL_C;
//   - each thread loads the codes of its next row while scoring this
//     one, across merge steps.
// Ranking is the 64-bit key of jpq_common.cuh: (value desc, id asc).
#pragma once

#include "jpq_common.cuh"
#include "smem.cuh"

namespace jpq {
namespace sw {

using smem::lds4;

constexpr unsigned FULL = 0xffffffffu;
constexpr int SNT = 1024;        // threads per block
constexpr int SG = 4;            // queries per block: one float4 a LUT entry
constexpr int SMALL_C = 64;      // merge by counting up to this many candidates
constexpr int RING = 32;         // tile bounds computed together, a warp each

// Candidates appended since the last merge, per query; two sets used by
// turns, so that a merge resets its set with no barrier of its own.
struct State {
  int cnt[2][SG];
};

// Dynamic shared memory: LUT [m b] float4, lists 2 x [SG, k] keys,
// candidates [SG, sub] keys.
__host__ __device__ inline size_t smem_bytes(int k, int m, int b, int sub) {
  return static_cast<size_t>(m) * b * 16 + static_cast<size_t>(2) * SG * k * 8 +
         static_cast<size_t>(SG) * sub * 8;
}

// lut4[j b + c] = (P[q0 + q, j, c])_q, zero for q >= nq.
__device__ void load_lut4(const float* __restrict__ lut_g, int q0, int nq,
                          int mb, float4* lut4) {
  for (int x = threadIdx.x; x < mb; x += SNT) {
    float v[SG];
#pragma unroll
    for (int q = 0; q < SG; ++q)
      v[q] = q < nq ? lut_g[static_cast<size_t>(q0 + q) * mb + x] : 0.f;
    lut4[x] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float comp(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

// The codes of one sweep row, loaded ahead of its scoring, and the SG
// scores of the row, each the fp32 sum in split order j = 0..m-1
// (bit-equal to the reference gather-sum).  lut: the shared address of
// lut4.  MC = 8: uint8 codes, 8 a row, 8-byte aligned (one load); MC =
// 0: any m and code type (loaded while scoring).
template <typename CodeT, int MC>
struct Row {
  const CodeT* row;
  __device__ __forceinline__ void load(const CodeT* codes, int m, int p) {
    row = codes + static_cast<size_t>(p) * m;
  }
  __device__ __forceinline__ float4 score(unsigned lut, int m, int b) const {
    const unsigned split = static_cast<unsigned>(b) * 16u;
    float4 a = lds4(lut + static_cast<unsigned>(row[0]) * 16u);
    for (int j = 1; j < m; ++j) {
      const float4 v = lds4(lut + j * split + static_cast<unsigned>(row[j]) * 16u);
      a.x = a.x + v.x;
      a.y = a.y + v.y;
      a.z = a.z + v.z;
      a.w = a.w + v.w;
    }
    return a;
  }
};

template <typename CodeT>
struct Row<CodeT, 8> {
  uint2 w;
  __device__ __forceinline__ void load(const CodeT* codes, int, int p) {
    w = __ldg(reinterpret_cast<const uint2*>(codes) + p);
  }
  __device__ __forceinline__ float4 score(unsigned lut, int, int b) const {
    const unsigned split = static_cast<unsigned>(b) * 16u;
    float4 a = lds4(lut + (w.x & 0xFFu) * 16u);
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const unsigned c = __byte_perm(j < 4 ? w.x : w.y, 0u, 0x4440u | (j & 3));
      const float4 v = lds4(lut + j * split + c * 16u);
      a.x = a.x + v.x;
      a.y = a.y + v.y;
      a.z = a.z + v.z;
      a.w = a.w + v.w;
    }
    return a;
  }
};

// Ascending sort of nseg segments of P keys each (P a power of two);
// segment q starts at x + q * stride.  Ends with a barrier.
__device__ void seg_sort(uint64_t* x, int nseg, int P, int stride) {
  const int n = nseg * P;
  for (int size = 2; size <= P; size <<= 1) {
    for (int half = size >> 1; half > 0; half >>= 1) {
      for (int i = threadIdx.x; i < n; i += SNT) {
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

__device__ __forceinline__ int pow2_at_least(int n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

// Keys of x[0..n) below v (lower) or at most v (upper); x ascending.
__device__ __forceinline__ int lower_bound(const uint64_t* x, int n, uint64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int upper_bound(const uint64_t* x, int n, uint64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Sort each of the nq lists [k] in place (through cands as scratch).
// Block-uniform; ends with a barrier.
__device__ void sort_lists(uint64_t* lists, uint64_t* cands, int nq, int k,
                           int sub) {
  const int P = pow2_at_least(k);  // <= sub
  for (int i = threadIdx.x; i < nq * P; i += SNT) {
    const int q = i / P, e = i - q * P;
    cands[q * P + e] = e < k ? lists[q * k + e] : ~0ull;
  }
  __syncthreads();
  seg_sort(cands, nq, P, P);
  for (int i = threadIdx.x; i < nq * k; i += SNT) {
    const int q = i / k;
    lists[i] = cands[q * P + (i - q * k)];
  }
  __syncthreads();
}

// Fold the candidates of every query (cands[q sub + 0..cnt[q])) into its
// sorted list (lists + cur SG k): the k smallest of list + candidates,
// sorted, into the other list buffer, which becomes live (cur flips).
// Block-uniform; cmax = max cnt[q] > 0, read by every thread after a
// barrier; ends with a barrier, after which cnt is reset.
__device__ void merge_all(uint64_t* lists, uint64_t* cands, int nq, int k,
                          int sub, int cmax, int* cnt, int& cur) {
  const uint64_t* L = lists + cur * SG * k;
  uint64_t* Ln = lists + (1 - cur) * SG * k;
  const bool sorted = cmax > SMALL_C;
  if (sorted) {
    const int P = pow2_at_least(cmax);  // <= sub
    for (int i = threadIdx.x; i < nq * P; i += SNT) {
      const int q = i / P, e = i - q * P;
      if (e >= cnt[q]) cands[q * sub + e] = ~0ull;
    }
    __syncthreads();
    seg_sort(cands, nq, P, sub);
  }
  const int w = k + cmax;
  for (int x = threadIdx.x; x < nq * w; x += SNT) {
    const int q = x / w, e = x - q * w;
    const int c = cnt[q];
    if (e >= k + c) continue;
    const uint64_t* C = cands + q * sub;
    const uint64_t* Lq = L + q * k;
    uint64_t v;
    int r;
    if (e < k) {
      v = Lq[e];
      if (sorted) {
        r = e + lower_bound(C, c, v);
      } else {
        r = e;
        for (int a = 0; a < c; ++a) r += C[a] < v;
      }
    } else {
      const int a = e - k;
      v = C[a];
      r = upper_bound(Lq, k, v);
      if (sorted) {
        r += a;
      } else {
        for (int i = 0; i < c; ++i) r += C[i] < v || (C[i] == v && i < a);
      }
    }
    if (r < k) Ln[q * k + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < SG) cnt[threadIdx.x] = 0;
  cur = 1 - cur;
}

// What every thread keeps in registers of the lists' k-th keys: their
// values (the keys themselves are read from the lists on the rare path).
struct Theta {
  float val[SG];  // key_value(theta), +inf past nq (no score passes)
};

// th from the live lists (sorted: the k-th key is the last).
__device__ __forceinline__ void read_theta(const uint64_t* L, int nq, int k,
                                           Theta& th) {
#pragma unroll
  for (int q = 0; q < SG; ++q)
    th.val[q] = q < nq ? key_value(L[q * k + k - 1]) : INFINITY;
}

// The state of a sweep that lives in registers (every thread the same):
// the live list buffer, the counter set in use, and the rows of the next
// merge step.  Steps start at the power of two >= k, at least SMALL_C,
// and double up to `sub`: against a cold list every row is a candidate,
// so at k <= SMALL_C no merge ever sorts.
struct Sweep {
  Theta th;
  int cur = 0, par = 0, len;
  __device__ Sweep(int k, int sub) : len(min(sub, max(SMALL_C, pow2_at_least(k)))) {}
};

// Score sweep rows [p0, p1) for the nq queries and fold them into the
// running lists, merging after every sw.len rows; the id of row p is
// ids[p] (ids may be null: id p).  Block-uniform; on return the lists
// hold the exact top-k of everything swept so far and sw.th mirrors
// them.  Each thread loads the codes of its next row before scoring
// this one, across merge steps.
template <typename CodeT, int MC>
__device__ void sweep_rows(unsigned lut, int m, int b, int nq,
                           const CodeT* __restrict__ codes,
                           const int* __restrict__ ids, int p0, int p1,
                           int k, int sub, uint64_t* lists, uint64_t* cands,
                           State& s, Sweep& sw) {
  Row<CodeT, MC> next;
  if (p0 + static_cast<int>(threadIdx.x) < p1)
    next.load(codes, m, p0 + threadIdx.x);
  for (int s0 = p0, s1; s0 < p1; s0 = s1) {
    s1 = min(p1, s0 + sw.len);
    const uint64_t* L = lists + sw.cur * SG * k;
    int* cnt = s.cnt[sw.par];
    bool appended = false;
    for (int base = s0; base < s1; base += SNT) {
      const int p = base + threadIdx.x;
      const bool valid = p < s1;
      const Row<CodeT, MC> row = next;
      // this thread's next row: here, or in the next step
      const int pn = base + SNT < s1 ? p + SNT : s1 + threadIdx.x;
      if (pn < p1) next.load(codes, m, pn);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) a = row.score(lut, m, b);
      // a float test first: a score below theta's value cannot enter
      bool pre = false;
#pragma unroll
      for (int q = 0; q < SG; ++q) pre |= !(comp(a, q) < sw.th.val[q]);
      pre = pre && valid;
      if (__any_sync(FULL, pre)) {
        const int id = pre ? (ids ? ids[p] : p) : 0;
#pragma unroll
        for (int q = 0; q < SG; ++q) {
          const uint64_t key = make_key(comp(a, q), id);
          const bool pass = pre && q < nq && key < L[q * k + k - 1];
          appended |= pass;
          append(pass, key, cands + q * sub, &cnt[q]);
        }
      }
    }
    // the counts are read only when some thread appended, and then
    // nobody appends to this set again before merge_all resets it
    if (__syncthreads_or(appended)) {
      int cmax = 0;
#pragma unroll
      for (int q = 0; q < SG; ++q) cmax = max(cmax, cnt[q]);
      merge_all(lists, cands, nq, k, sub, cmax, cnt, sw.cur);
      sw.par ^= 1;
      read_theta(lists + sw.cur * SG * k, nq, k, sw.th);
    }
    sw.len = min(sub, 2 * sw.len);
  }
}

}  // namespace sw
}  // namespace jpq
