// PQTopK with score-bound dynamic pruning, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel jpq_topk_tiles_pruned (src/repro/kernels/
// jpq_topk/jpq_topk.py, pallas_call at :281, body _kernel_pruned at
// :167).  Same result as jpq_topk.cu, but tiles of block_n sweep rows are
// skipped when no query of the group can gain from them:
//     ub[q]  = sum_{j=0..m-1} max{P[q, j, c] : c present in the tile}
//     ok[q]  = ub[q] >  theta[q]   (sweep in id order: a tie loses on id)
//              ub[q] >= theta[q]   (permuted sweep: a tie may win on id)
//     need   = any_q (ok[q] && ub[q] >= floor[q])
// theta[q] is the k-th value of the query's running list, which is seeded
// from init_vals / init_ids; the per-row floor is applied before the any.
// Rows carry their original item ids, and the merge ranks by (value desc,
// id asc), so one code path serves permuted and unpermuted sweeps.
// Writes the skip map [n_groups, n_tiles] (1 = the group skipped it).
//
// What bounds it.  As jpq_topk.cu when few tiles are skipped: the
// B*N*m gathered fp32 adds of the swept tiles, from shared memory.  The
// bound test costs G*m*b max operations per tile, and the sweep of
// a group is sequential by construction (the bound needs the running
// k-th value), so parallelism comes from query groups alone: 128 groups
// of G = 4 at B = 512, one block an SM.
//
// Design.  The TPU's sequential item grid becomes a loop inside the
// block: one block of 1,024 threads per group of G = 4 queries walks all
// tiles in order, keeping G sorted running lists in shared memory, and a
// swept tile is scored by all 32 warps (jpq_sweep.cuh: float4 LUT
// entries of the 4 queries, a float test against theta before any key
// is built, merges of the few items that pass by rank).  The tile
// bounds do not depend on theta, so RING = 32 tiles' bounds are computed
// together, a warp a tile (a lane per 1/32 of the codes, all splits, the
// four queries' maxes in one float4, then a warp reduction); every
// thread then takes tile t's decision itself from those bounds and the
// theta it keeps in registers, so a skipped tile costs no barrier.
#include "jpq_sweep.cuh"

namespace jpq {

using sw::SG;
using sw::SNT;
using sw::RING;

template <typename CodeT, int MC>
__global__ void __launch_bounds__(SNT, 1) topk_pruned_kernel(
    const float* __restrict__ lut_g, const CodeT* __restrict__ codes,
    const int* __restrict__ ids, const float* __restrict__ present,
    const float* __restrict__ floor_g, const float* __restrict__ init_v,
    const int* __restrict__ init_i, int B, int m, int b, int N, int k,
    int block_n, int tie_break_ids, int sub, float* __restrict__ out_v,
    int* __restrict__ out_i, int* __restrict__ skip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ sw::State s;
  __shared__ float ub_ring[RING][SG];
  float4* lut4 = reinterpret_cast<float4*>(smem_raw);
  uint64_t* lists = reinterpret_cast<uint64_t*>(lut4 + m * b);  // 2 x [G, k]
  uint64_t* cands = lists + 2 * SG * k;                          // [G, sub]
  const unsigned lut = static_cast<unsigned>(__cvta_generic_to_shared(lut4));
  const int group = blockIdx.x;
  const int q0 = group * SG;
  const int nq = min(SG, B - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mb = m * b;
  sw::load_lut4(lut_g, q0, nq, mb, lut4);
  for (int i = threadIdx.x; i < nq * k; i += SNT) {
    const size_t g = static_cast<size_t>(q0) * k + i;
    lists[i] = make_key(init_v[g], init_i[g]);
  }
  if (threadIdx.x < 2 * SG) s.cnt[threadIdx.x / SG][threadIdx.x % SG] = 0;
  __syncthreads();
  sw::sort_lists(lists, cands, nq, k, sub);
  float fl[SG];
#pragma unroll
  for (int q = 0; q < SG; ++q) fl[q] = q < nq ? floor_g[q0 + q] : 0.f;
  sw::Sweep sweep(k, sub);
  sw::read_theta(lists, nq, k, sweep.th);
  const int n_tiles = (N + block_n - 1) / block_n;
  for (int t = 0; t < n_tiles; ++t) {
    if (t % RING == 0) {
      // bounds of tiles t..t+RING-1: per query, the sum in split order
      // (from +0.0) of the LUT's max over the codes present in the tile
      __syncthreads();  // every thread has read the previous ring
      const int tt = t + warp;
      if (warp < RING && tt < n_tiles) {
        float4 ub = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < m; ++j) {
          const float* pres = present + (static_cast<size_t>(tt) * m + j) * b;
          float4 mx = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
          // unrolled, with both loads ahead of the test, so a lane has
          // its 8 present flags (b = 256) in flight at once
#pragma unroll 8
          for (int c = lane; c < b; c += 32) {
            const bool on = __ldg(pres + c) > 0.f;
            const float4 v = lut4[j * b + c];
            if (on) {
              mx.x = fmaxf(mx.x, v.x);
              mx.y = fmaxf(mx.y, v.y);
              mx.z = fmaxf(mx.z, v.z);
              mx.w = fmaxf(mx.w, v.w);
            }
          }
          for (int o = 16; o > 0; o >>= 1) {
            mx.x = fmaxf(mx.x, __shfl_xor_sync(sw::FULL, mx.x, o));
            mx.y = fmaxf(mx.y, __shfl_xor_sync(sw::FULL, mx.y, o));
            mx.z = fmaxf(mx.z, __shfl_xor_sync(sw::FULL, mx.z, o));
            mx.w = fmaxf(mx.w, __shfl_xor_sync(sw::FULL, mx.w, o));
          }
          ub.x = ub.x + mx.x;
          ub.y = ub.y + mx.y;
          ub.z = ub.z + mx.z;
          ub.w = ub.w + mx.w;
        }
        if (lane < SG) ub_ring[warp][lane] = sw::comp(ub, lane);
      }
      __syncthreads();
    }
    bool need = false;
#pragma unroll
    for (int q = 0; q < SG; ++q) {
      if (q < nq) {
        const float ub = ub_ring[t % RING][q];
        const float th = sweep.th.val[q];
        const bool ok = tie_break_ids ? (ub >= th) : (ub > th);
        need |= ok && ub >= fl[q];
      }
    }
    if (threadIdx.x == 0)
      skip[static_cast<size_t>(group) * n_tiles + t] = need ? 0 : 1;
    if (need) {
      const int p0 = t * block_n;
      sw::sweep_rows<CodeT, MC>(lut, m, b, nq, codes, ids, p0,
                                min(N, p0 + block_n), k, sub, lists, cands,
                                s, sweep);
    }
  }
  __syncthreads();
  const uint64_t* L = lists + sweep.cur * SG * k;  // sorted: write it out
  for (int i = threadIdx.x; i < nq * k; i += SNT) {
    const size_t g = static_cast<size_t>(q0) * k + i;
    out_v[g] = key_value(L[i]);
    out_i[g] = key_id(L[i]);
  }
}

// Candidate rows a merge step: the most of 4,096, 2,048 and 1,024 whose
// buffers fit the block's shared memory (0: none fits).
inline int pruned_sub(int k, int m, int b) {
  for (int sub = 4096; sub >= 1024; sub >>= 1)
    if (sw::smem_bytes(k, m, b, sub) + sizeof(sw::State) +
            sizeof(float) * RING * SG <= 232448)
      return sub;
  return 0;
}

template <typename CodeT, int MC>
int launch_pruned_t(const float* lut, const void* codes, const int* ids,
                    const float* present, const float* floor_g,
                    const float* init_v, const int* init_i, int B, int m,
                    int b, int N, int k, int block_n, int tie_break_ids,
                    float* out_v, int* out_i, int* skip, cudaStream_t stream) {
  const int n_groups = (B + SG - 1) / SG;
  const int sub = pruned_sub(k, m, b);
  if (sub == 0) return -1;
  const size_t smem = sw::smem_bytes(k, m, b, sub);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pruned_kernel<CodeT, MC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_pruned_kernel<CodeT, MC><<<n_groups, SNT, smem, stream>>>(
      lut, static_cast<const CodeT*>(codes), ids, present, floor_g, init_v,
      init_i, B, m, b, N, k, block_n, tie_break_ids, sub, out_v, out_i, skip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace jpq

extern "C" {

// Returns 0, a CUDA error code (> 0), or -1 for arguments the kernel does
// not take (the Python wrapper checks them first and names the limit).
int jpq_topk_pruned_launch(const void* lut, const void* codes, int code_bytes,
                           const void* ids, const void* present,
                           const void* floor_g, const void* init_v,
                           const void* init_i, int B, int m, int b, int N,
                           int k, int block_n, int tie_break_ids, void* out_v,
                           void* out_i, void* skip, void* stream) {
  if (B < 1 || m < 1 || b < 1 || N < 1 || k < 1 || k > jpq::KMAX ||
      block_n < 1 || (code_bytes != 1 && code_bytes != 4))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lut);
  auto id = static_cast<const int*>(ids);
  auto pr = static_cast<const float*>(present);
  auto fl = static_cast<const float*>(floor_g);
  auto iv = static_cast<const float*>(init_v);
  auto ii = static_cast<const int*>(init_i);
  auto v = static_cast<float*>(out_v);
  auto i = static_cast<int*>(out_i);
  auto sk = static_cast<int*>(skip);
  if (code_bytes == 4)
    return jpq::launch_pruned_t<int32_t, 0>(l, codes, id, pr, fl, iv, ii, B, m,
                                            b, N, k, block_n, tie_break_ids, v,
                                            i, sk, st);
  if (m == 8 && reinterpret_cast<uintptr_t>(codes) % 8 == 0)
    return jpq::launch_pruned_t<uint8_t, 8>(l, codes, id, pr, fl, iv, ii, B, m,
                                            b, N, k, block_n, tie_break_ids, v,
                                            i, sk, st);
  return jpq::launch_pruned_t<uint8_t, 0>(l, codes, id, pr, fl, iv, ii, B, m, b,
                                          N, k, block_n, tie_break_ids, v, i,
                                          sk, st);
}

// Queries per block: the skip map has ceil(B / G) rows.
int jpq_topk_pruned_group_size() { return jpq::sw::SG; }

// Shared memory a block needs at the smallest merge step (1,024 rows).
size_t jpq_topk_pruned_smem_bytes(int k, int m, int b) {
  return jpq::sw::smem_bytes(k, m, b, 1024) + sizeof(jpq::sw::State) +
         sizeof(float) * jpq::sw::RING * jpq::sw::SG;
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
