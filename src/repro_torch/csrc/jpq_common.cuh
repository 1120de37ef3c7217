// Shared device code of the PQTopK kernels (jpq_topk.cu,
// jpq_topk_pruned.cu): the total-order key, an exact block-wide
// k-smallest selection, a bitonic sort and the running-list sweep.
//
// Ranking.  Every candidate is one 64-bit key
//     key = ukey(value) << 32 | id
// where ukey maps a float to a uint32 whose ASCENDING order is the IEEE
// total order of the value DESCENDING (+0.0 above -0.0) — the ranking of
// the reference's lax.top_k.  Ascending key order is then (value desc,
// id asc), the order of a top-k over the materialised score matrix with
// ties to the smallest id.  Two equal keys are the same (value, id)
// entry, so any choice among them gives the same result.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace jpq {

constexpr int NT = 256;     // threads per block
constexpr int G = 4;        // queries per block: one code read feeds G LUTs
constexpr int SUB = 1024;   // items scored between two merges
constexpr int KMAX = 1024;  // largest k the kernels take

__device__ __forceinline__ uint32_t ukey(float v) {
  int b = __float_as_int(-v);
  int k = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return static_cast<uint32_t>(k) ^ 0x80000000u;
}

__device__ __forceinline__ float uval(uint32_t u) {
  int k = static_cast<int>(u ^ 0x80000000u);
  int b = k < 0 ? (k ^ 0x7FFFFFFF) : k;
  return -__int_as_float(b);
}

__device__ __forceinline__ uint64_t make_key(float v, int id) {
  return (static_cast<uint64_t>(ukey(v)) << 32) | static_cast<uint32_t>(id);
}

__device__ __forceinline__ float key_value(uint64_t key) {
  return uval(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ int key_id(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key & 0xFFFFFFFFull));
}

struct Scratch {
  unsigned hist[256];
  unsigned long long prefix, mask;
  int remaining, done, n_lt, n_eq;
  unsigned long long red[NT / 32];
  unsigned long long theta[G];  // worst key of each query's running list
  int cnt[G];                   // candidates appended since the last merge
};

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// Block-wide max of one value per thread.
__device__ unsigned long long block_max(unsigned long long v, Scratch& s) {
  for (int o = 16; o > 0; o >>= 1)
    v = umax64(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long r = s.red[0];
  for (int w = 1; w < NT / 32; ++w) r = umax64(r, s.red[w]);
  __syncthreads();
  return r;
}

// dst[0..kk) = the kk smallest of src[0..n), unordered; kk <= n.
// Radix select, 8 bits a pass from the top, stopping as soon as the
// chosen digit's bin is taken whole.  Histogram adds are aggregated per
// warp over lanes with the same digit (scores of one query share their
// top bits, so plain atomics would serialise on one bin).
__device__ void select_smallest(const uint64_t* src, int n, int kk,
                                uint64_t* dst, Scratch& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (n <= kk) {
    for (int i = tid; i < n; i += NT) dst[i] = src[i];
    __syncthreads();
    return;
  }
  if (tid == 0) {
    s.prefix = 0;
    s.mask = 0;
    s.remaining = kk;
    s.done = 0;
    s.n_lt = 0;
    s.n_eq = 0;
  }
  __syncthreads();
  for (int shift = 56; shift >= 0; shift -= 8) {
    const uint64_t prefix = s.prefix, mask = s.mask;
    for (int i = tid; i < 256; i += NT) s.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += NT) {
      const int i = base + tid;
      bool pred = false;
      unsigned digit = 0;
      if (i < n) {
        const uint64_t key = src[i];
        if ((key & mask) == prefix) {
          pred = true;
          digit = static_cast<unsigned>(key >> shift) & 255u;
        }
      }
      const unsigned active = __ballot_sync(0xffffffffu, pred);
      if (pred) {
        const unsigned peers = __match_any_sync(active, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(&s.hist[digit], __popc(peers));
      }
    }
    __syncthreads();
    if (tid < 32) {
      const unsigned rem = static_cast<unsigned>(s.remaining);
      unsigned local = 0;
      for (int d = 0; d < 8; ++d) local += s.hist[lane * 8 + d];
      unsigned incl = local;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned excl = incl - local;
      if (excl < rem && rem <= incl) {
        unsigned cum = excl;
        for (int d = 0; d < 8; ++d) {
          const unsigned h = s.hist[lane * 8 + d];
          if (cum + h >= rem) {
            const uint64_t dig = static_cast<uint64_t>(lane * 8 + d);
            s.prefix = prefix | (dig << shift);
            s.mask = mask | (0xFFull << shift);
            s.remaining = static_cast<int>(rem - cum);
            s.done = (h == rem - cum);
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
    if (s.done) break;
  }
  const uint64_t prefix = s.prefix, mask = s.mask;
  const int rem = s.remaining;
  const int n_lt = kk - rem;
  for (int i = tid; i < n; i += NT) {
    const uint64_t key = src[i];
    const uint64_t mk = key & mask;
    if (mk < prefix) {
      dst[atomicAdd(&s.n_lt, 1)] = key;
    } else if (mk == prefix) {
      const int t = atomicAdd(&s.n_eq, 1);
      if (t < rem) dst[n_lt + t] = key;
    }
  }
  __syncthreads();
}

// Ascending sort of x[0..P), P a power of two.
__device__ void bitonic_sort(uint64_t* x, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += NT) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const uint64_t a = x[i], b = x[j];
          if ((a > b) == up) {
            x[i] = b;
            x[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Sort one running list (k keys) through `tmp` (>= next pow2 of k
// slots) and write it out as values [k] and ids [k].
__device__ void write_sorted(const uint64_t* list, int k, uint64_t* tmp,
                             float* out_v, int* out_i) {
  int P = 1;
  while (P < k) P <<= 1;
  for (int i = threadIdx.x; i < P; i += NT) tmp[i] = i < k ? list[i] : ~0ull;
  __syncthreads();
  bitonic_sort(tmp, P);
  for (int i = threadIdx.x; i < k; i += NT) {
    out_v[i] = key_value(tmp[i]);
    out_i[i] = key_id(tmp[i]);
  }
  __syncthreads();
}

// Append `key` to a candidate buffer when `pass`; one atomic per warp.
// All 32 lanes must call it together.
__device__ __forceinline__ void append(bool pass, uint64_t key,
                                       uint64_t* buf, int* cnt) {
  const unsigned ballot = __ballot_sync(0xffffffffu, pass);
  if (ballot == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (pass) buf[base + __popc(ballot & ((1u << lane) - 1u))] = key;
}

// Merge the candidates appended to cand[k..k+cnt) into the running list
// (k keys): the k smallest of list ∪ candidates become the new list,
// and theta its worst key.  Block-uniform; cand[0..k) is overwritten.
__device__ void merge_list(uint64_t* list, uint64_t* cand, int k, int q,
                           Scratch& s) {
  const int c = s.cnt[q];
  if (c == 0) return;
  for (int i = threadIdx.x; i < k; i += NT) cand[i] = list[i];
  __syncthreads();
  select_smallest(cand, k + c, k, list, s);
  unsigned long long mx = 0;
  for (int i = threadIdx.x; i < k; i += NT) mx = umax64(mx, list[i]);
  mx = block_max(mx, s);
  if (threadIdx.x == 0) {
    s.theta[q] = mx;
    s.cnt[q] = 0;
  }
  __syncthreads();
}

// Score sweep positions [p0, p1) for the block's nq queries and fold
// them into the running lists.  lut: [G, m, b] in shared memory;
// codes [N, m] row p; the id of row p is ids[p] (ids may be null: id p).
// Each item's score is the fp32 sum in split order j = 0..m-1, bit-equal
// to the reference gather-sum.  Only items whose key beats the query's
// worst listed key can enter, so only those are kept for the merge.
template <typename CodeT>
__device__ void sweep_range(const float* lut, int m, int b, int nq,
                            const CodeT* __restrict__ codes,
                            const int* __restrict__ ids, int p0, int p1,
                            int k, uint64_t* lists, uint64_t* cands,
                            Scratch& s) {
  for (int s0 = p0; s0 < p1; s0 += SUB) {
    const int s1 = min(p1, s0 + SUB);
    for (int base = s0; base < s1; base += NT) {
      const int p = base + threadIdx.x;
      const bool valid = p < s1;
      float acc[G];
      int id = 0;
      if (valid) {
        const CodeT* row = codes + static_cast<size_t>(p) * m;
        int c = static_cast<int>(row[0]);
#pragma unroll
        for (int q = 0; q < G; ++q) acc[q] = lut[(q * m) * b + c];
        for (int j = 1; j < m; ++j) {
          c = static_cast<int>(row[j]);
#pragma unroll
          for (int q = 0; q < G; ++q) acc[q] = acc[q] + lut[(q * m + j) * b + c];
        }
        id = ids ? ids[p] : p;
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const bool live = valid && q < nq;
        const uint64_t key = live ? make_key(acc[q], id) : ~0ull;
        append(live && key < s.theta[q], key, cands + q * (k + SUB) + k,
               &s.cnt[q]);
      }
    }
    __syncthreads();
    for (int q = 0; q < nq; ++q)
      merge_list(lists + q * k, cands + q * (k + SUB), k, q, s);
  }
}

// Shared-memory layout of a sweep block: lists [G, k] keys, candidate
// buffers [G, k + SUB] keys, LUTs [G, m, b] floats, then `extra` floats.
__host__ __device__ inline size_t sweep_smem_bytes(int k, int m, int b,
                                                   int extra) {
  return static_cast<size_t>(G) * k * 8 +
         static_cast<size_t>(G) * (k + SUB) * 8 +
         static_cast<size_t>(G) * m * b * 4 + static_cast<size_t>(extra) * 4;
}

// Copy the block's nq LUT rows [m, b] into shared memory (zero rows past nq).
__device__ void load_luts(const float* __restrict__ lut_g, int q0, int nq,
                          int mb, float* lut) {
  for (int i = threadIdx.x; i < G * mb; i += NT) {
    const int q = i / mb;
    lut[i] = q < nq ? lut_g[static_cast<size_t>(q0 + q) * mb + (i - q * mb)]
                    : 0.f;
  }
}

}  // namespace jpq
