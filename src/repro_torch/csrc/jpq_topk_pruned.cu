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
// k-th value), so parallelism comes from query groups alone.
//
// Design.  The TPU's sequential item grid becomes a loop inside the
// block: one block per group of G queries walks all tiles in order,
// keeping G running lists in shared memory.  A swept tile is scored in
// sub-steps; only items that beat the running k-th key are kept and
// merged by an exact radix select (jpq_common.cuh).
#include "jpq_common.cuh"

namespace jpq {

template <typename CodeT>
__global__ void __launch_bounds__(NT) topk_pruned_kernel(
    const float* __restrict__ lut_g, const CodeT* __restrict__ codes,
    const int* __restrict__ ids, const float* __restrict__ present,
    const float* __restrict__ floor_g, const float* __restrict__ init_v,
    const int* __restrict__ init_i, int B, int m, int b, int N, int k,
    int block_n, int tie_break_ids, float* __restrict__ out_v,
    int* __restrict__ out_i, int* __restrict__ skip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch s;
  __shared__ int need;
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* cands = lists + G * k;
  float* lut = reinterpret_cast<float*>(cands + G * (k + SUB));
  float* split_max = lut + G * m * b;  // [G, m]
  const int group = blockIdx.x;
  const int q0 = group * G;
  const int nq = min(G, B - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_luts(lut_g, q0, nq, m * b, lut);
  for (int i = threadIdx.x; i < nq * k; i += NT) {
    const size_t g = static_cast<size_t>(q0) * k + i;
    lists[i] = make_key(init_v[g], init_i[g]);
  }
  if (threadIdx.x < G) s.cnt[threadIdx.x] = 0;
  __syncthreads();
  for (int q = 0; q < nq; ++q) {
    unsigned long long mx = 0;
    for (int i = threadIdx.x; i < k; i += NT) mx = umax64(mx, lists[q * k + i]);
    mx = block_max(mx, s);
    if (threadIdx.x == 0) s.theta[q] = mx;
  }
  __syncthreads();
  const int n_tiles = (N + block_n - 1) / block_n;
  for (int t = 0; t < n_tiles; ++t) {
    // per (query, split): max of the LUT over the codes present in tile t
    for (int pair = warp; pair < nq * m; pair += NT / 32) {
      const int q = pair / m, j = pair - q * m;
      const float* pres = present + (static_cast<size_t>(t) * m + j) * b;
      const float* row = lut + (q * m + j) * b;
      float mx = -INFINITY;
      for (int c = lane; c < b; c += 32)
        if (pres[c] > 0.f) mx = fmaxf(mx, row[c]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) split_max[pair] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int any = 0;
      for (int q = 0; q < nq; ++q) {
        float ub = 0.f;
        for (int j = 0; j < m; ++j) ub = ub + split_max[q * m + j];
        const float theta = key_value(s.theta[q]);
        const bool ok = tie_break_ids ? (ub >= theta) : (ub > theta);
        if (ok && ub >= floor_g[q0 + q]) any = 1;
      }
      need = any;
      skip[static_cast<size_t>(group) * n_tiles + t] = any ? 0 : 1;
    }
    __syncthreads();
    if (need) {
      const int p0 = t * block_n;
      sweep_range<CodeT>(lut, m, b, nq, codes, ids, p0, min(N, p0 + block_n),
                         k, lists, cands, s);
    }
  }
  for (int q = 0; q < nq; ++q)
    write_sorted(lists + q * k, k, cands, out_v + static_cast<size_t>(q0 + q) * k,
                 out_i + static_cast<size_t>(q0 + q) * k);
}

template <typename CodeT>
int launch_pruned(const float* lut, const void* codes, const int* ids,
                  const float* present, const float* floor_g,
                  const float* init_v, const int* init_i, int B, int m, int b,
                  int N, int k, int block_n, int tie_break_ids, float* out_v,
                  int* out_i, int* skip, cudaStream_t stream) {
  const int n_groups = (B + G - 1) / G;
  const size_t smem = sweep_smem_bytes(k, m, b, G * m);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pruned_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_pruned_kernel<CodeT><<<n_groups, NT, smem, stream>>>(
      lut, static_cast<const CodeT*>(codes), ids, present, floor_g, init_v,
      init_i, B, m, b, N, k, block_n, tie_break_ids, out_v, out_i, skip);
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
  if (code_bytes == 1)
    return jpq::launch_pruned<uint8_t>(l, codes, id, pr, fl, iv, ii, B, m, b,
                                       N, k, block_n, tie_break_ids, v, i, sk,
                                       st);
  return jpq::launch_pruned<int32_t>(l, codes, id, pr, fl, iv, ii, B, m, b, N,
                                     k, block_n, tie_break_ids, v, i, sk, st);
}

// Queries per block: the skip map has ceil(B / G) rows.
int jpq_topk_pruned_group_size() { return jpq::G; }

size_t jpq_topk_pruned_smem_bytes(int k, int m, int b) {
  return jpq::sweep_smem_bytes(k, m, b, jpq::G * m) + sizeof(jpq::Scratch) +
         sizeof(int);
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
