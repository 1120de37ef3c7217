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
// gathers from a per-query table, so they run from shared memory at 32
// lanes per SM per clock (about 0.5 ms at the sizes above, four times
// the fp32 adds they feed), not on tensor cores (the TPU kernel's
// one-hot matmul would round P in TF32).  The selection of the top k is
// the other cost.
//
// Design.  The TPU sweeps item tiles in order and carries the running
// list in VMEM; blocks on a GPU run in no order, so the sweep is split in
// two launches, the reference's _jpq_topk_scan algorithm:
//   1. grid (item chunk, query group of G): the G LUT rows sit in shared
//      memory; each thread scores items (one code read feeds G queries)
//      and keeps only those that beat the query's running k-th key, which
//      are merged into the chunk-local running list by an exact radix
//      select.  Writes candidates [B, n_chunks, k] as 64-bit keys.
//   2. one block per query merges its n_chunks*k candidates the same way
//      and writes the list sorted.
// The last chunk is masked against the real N.  Keys are unique per
// (value, id), so the result is exact and bit-equal to the reference.
#include "jpq_common.cuh"

namespace jpq {

template <typename CodeT>
__global__ void __launch_bounds__(NT)
    topk_chunk_kernel(const float* __restrict__ lut_g,
                      const CodeT* __restrict__ codes, int B, int m, int b,
                      int N, int k, int chunk, uint64_t* __restrict__ cand_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch s;
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* cands = lists + G * k;
  float* lut = reinterpret_cast<float*>(cands + G * (k + SUB));
  const int chunk_id = blockIdx.x;
  const int q0 = blockIdx.y * G;
  const int nq = min(G, B - q0);
  load_luts(lut_g, q0, nq, m * b, lut);
  // sentinel: worse than any real item (-inf at the largest id)
  const uint64_t sentinel = make_key(-INFINITY, 0x7FFFFFFF);
  for (int i = threadIdx.x; i < G * k; i += NT) lists[i] = sentinel;
  if (threadIdx.x < G) {
    s.theta[threadIdx.x] = sentinel;
    s.cnt[threadIdx.x] = 0;
  }
  __syncthreads();
  const int p0 = chunk_id * chunk;
  const int p1 = min(N, p0 + chunk);
  sweep_range<CodeT>(lut, m, b, nq, codes, nullptr, p0, p1, k, lists, cands,
                     s);
  const int n_chunks = gridDim.x;
  for (int i = threadIdx.x; i < nq * k; i += NT) {
    const int q = i / k;
    cand_out[(static_cast<size_t>(q0 + q) * n_chunks + chunk_id) * k +
             (i - q * k)] = lists[i];
  }
}

__global__ void __launch_bounds__(NT)
    topk_merge_kernel(const uint64_t* __restrict__ cand_g, int total, int k,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch s;
  uint64_t* list = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* cand = list + k;
  const int row = blockIdx.x;
  const uint64_t* src = cand_g + static_cast<size_t>(row) * total;
  for (int i = threadIdx.x; i < k; i += NT) list[i] = ~0ull;
  if (threadIdx.x == 0) {
    s.theta[0] = ~0ull;
    s.cnt[0] = 0;
  }
  __syncthreads();
  for (int s0 = 0; s0 < total; s0 += SUB) {
    const int s1 = min(total, s0 + SUB);
    for (int base = s0; base < s1; base += NT) {
      const int i = base + threadIdx.x;
      const uint64_t key = i < s1 ? src[i] : ~0ull;
      append(i < s1 && key < s.theta[0], key, cand + k, &s.cnt[0]);
    }
    __syncthreads();
    merge_list(list, cand, k, 0, s);
  }
  write_sorted(list, k, cand, out_v + static_cast<size_t>(row) * k,
               out_i + static_cast<size_t>(row) * k);
}

template <typename CodeT>
int launch(const float* lut, const void* codes, int B, int m, int b, int N,
           int k, int chunk, uint64_t* cand, float* out_v, int* out_i,
           cudaStream_t stream) {
  const int n_chunks = (N + chunk - 1) / chunk;
  const int n_groups = (B + G - 1) / G;
  const size_t smem1 = sweep_smem_bytes(k, m, b, 0);
  cudaError_t err = cudaFuncSetAttribute(
      topk_chunk_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_chunk_kernel<CodeT><<<dim3(n_chunks, n_groups), NT, smem1, stream>>>(
      lut, static_cast<const CodeT*>(codes), B, m, b, N, k, chunk, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = static_cast<size_t>(k) * 8 + static_cast<size_t>(k + SUB) * 8;
  err = cudaFuncSetAttribute(topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<B, NT, smem2, stream>>>(cand, n_chunks * k, k, out_v,
                                              out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace jpq

extern "C" {

// Returns 0, a CUDA error code (> 0), or -1 for arguments the kernel does
// not take (the Python wrapper checks them first and names the limit).
int jpq_topk_launch(const void* lut, const void* codes, int code_bytes, int B,
                    int m, int b, int N, int k, int chunk, void* cand,
                    void* out_v, void* out_i, void* stream) {
  if (B < 1 || m < 1 || b < 1 || N < 1 || k < 1 || k > jpq::KMAX ||
      k > N || chunk < 1 || (code_bytes != 1 && code_bytes != 4))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lut);
  auto c = static_cast<uint64_t*>(cand);
  auto v = static_cast<float*>(out_v);
  auto i = static_cast<int*>(out_i);
  if (code_bytes == 1)
    return jpq::launch<uint8_t>(l, codes, B, m, b, N, k, chunk, c, v, i, st);
  return jpq::launch<int32_t>(l, codes, B, m, b, N, k, chunk, c, v, i, st);
}

size_t jpq_topk_smem_bytes(int k, int m, int b) {
  return jpq::sweep_smem_bytes(k, m, b, 0) + sizeof(jpq::Scratch);
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
