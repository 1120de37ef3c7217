// jpq_scores: RecJPQ full-catalogue scoring through the codes, forward
// and backward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel jpq_scores_lut (src/repro/kernels/jpq_scores/
// jpq_scores.py, pallas_call at :60, body _kernel at :37).  Forward:
//     S[t, i] = sum_{j=0..m-1} P[t, j, codes[i, j]]          (fp32, in order)
// from the LUT P [T, m, b] and codes [N, m].  The TPU kernel has no
// backward (jax.grad cannot differentiate the pallas_call); this file adds
//     dP[t, j, c] = sum_{i : codes[i, j] = c} dS[t, i]
// so the full_ce loss trains through the kernel.
//
// What bounds them.  The forward writes S, T*N fp32: 12.8 GB at T = 3,200
// and N = 1,000,002, 3.8 ms at 3.35 TB/s; its T*N*m LUT lookups from
// shared memory come second (3.05 ms at 32 lanes per SM per clock).  The
// backward reads dS, the same 12.8 GB.
//
// Forward design.  No one-hot matmul (a TPU MXU device; on tensor cores
// in TF32 it would round P): a block holds the LUT rows of G queries in
// shared memory and each thread gather-sums one item for all G, in split
// order j = 0..m-1, which is bit-equal to the reference gather-sum.
// Neighbouring threads score neighbouring items, so each warp writes 128
// contiguous bytes of each row.  The last chunk is masked against the
// real N; the caller's arrays are not padded.
//
// Backward design.  Deterministic: no float atomics, so two calls on the
// same inputs give bit-identical dP.  Pass 1, grid (item chunk, group of
// 8 rows): each warp owns one row t and a private histogram [m, b] in
// shared memory.  It walks the chunk 32 items at a time (coalesced reads
// of dS); for each split, lanes with the same code are grouped with
// __match_any_sync, the lowest lane of each group sums the group's values
// in lane order and adds the sum into the histogram.  Only that warp
// writes the histogram and the group leaders hold distinct codes, so the
// read-modify-write needs no atomic and its order is fixed.  The
// histogram goes out as partial[t, chunk, m, b].  Pass 2 sums the
// partials of each (t, j, c) in chunk order.
#include <cstdint>
#include <cuda_runtime.h>

namespace jpq_scores {

constexpr int NT = 256;          // threads per block
constexpr int G = 8;             // forward: queries per block
constexpr int ITEMS = 16;        // forward: items per thread
constexpr int FWD_CHUNK = NT * ITEMS;
constexpr int ROWS = NT / 32;    // backward: rows per block (one per warp)

template <typename CodeT>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const float* __restrict__ P, const CodeT* __restrict__ codes,
               int T, int m, int b, int N, float* __restrict__ S) {
  extern __shared__ float lut[];  // [G, m, b]
  const int t0 = blockIdx.y * G;
  const int nq = min(G, T - t0);
  const int mb = m * b;
  for (int x = threadIdx.x; x < G * mb; x += NT) {
    const int q = x / mb;
    lut[x] = q < nq ? P[static_cast<size_t>(t0 + q) * mb + (x - q * mb)] : 0.f;
  }
  __syncthreads();
  const int i0 = blockIdx.x * FWD_CHUNK;
  for (int it = 0; it < ITEMS; ++it) {
    const int i = i0 + it * NT + threadIdx.x;
    if (i >= N) break;
    const CodeT* row = codes + static_cast<size_t>(i) * m;
    float acc[G];
    int c = static_cast<int>(row[0]);
#pragma unroll
    for (int q = 0; q < G; ++q) acc[q] = lut[q * mb + c];
    for (int j = 1; j < m; ++j) {
      c = static_cast<int>(row[j]);
#pragma unroll
      for (int q = 0; q < G; ++q) acc[q] = acc[q] + lut[q * mb + j * b + c];
    }
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (q < nq) S[static_cast<size_t>(t0 + q) * N + i] = acc[q];
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(NT)
    bwd_partial_kernel(const float* __restrict__ dS,
                       const CodeT* __restrict__ codes, int T, int m, int b,
                       int N, int chunk, float* __restrict__ partial) {
  extern __shared__ float smem[];  // hist [ROWS, m, b], then vals [ROWS, 32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = m * b;
  float* hist = smem + warp * mb;
  float* vals = smem + ROWS * mb + warp * 32;
  for (int x = lane; x < mb; x += 32) hist[x] = 0.f;
  __syncwarp();
  const int t = blockIdx.y * ROWS + warp;
  const int n_chunks = gridDim.x;
  if (t >= T) return;  // the whole warp leaves together; no block barrier
  const int i0 = blockIdx.x * chunk;
  const int i1 = min(N, i0 + chunk);
  const float* drow = dS + static_cast<size_t>(t) * N;
  for (int base = i0; base < i1; base += 32) {
    const int i = base + lane;
    const bool valid = i < i1;
    const float v = valid ? drow[i] : 0.f;
    vals[lane] = v;
    __syncwarp();
    for (int j = 0; j < m; ++j) {
      // lanes past the end get keys no code can take, so they group alone
      const int c = valid ? static_cast<int>(codes[static_cast<size_t>(i) * m + j])
                          : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, c);
      if (valid && lane == __ffs(peers) - 1) {
        float s = v;
        unsigned rest = peers & (peers - 1);  // the other lanes, in order
        while (rest) {
          s = s + vals[__ffs(rest) - 1];
          rest &= rest - 1;
        }
        hist[j * b + c] = hist[j * b + c] + s;
      }
      __syncwarp();
    }
  }
  float* out = partial + (static_cast<size_t>(t) * n_chunks + blockIdx.x) * mb;
  for (int x = lane; x < mb; x += 32) out[x] = hist[x];
}

__global__ void __launch_bounds__(NT)
    bwd_reduce_kernel(const float* __restrict__ partial, int T, int mb,
                      int n_chunks, float* __restrict__ dP) {
  const size_t e = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  if (e >= static_cast<size_t>(T) * mb) return;
  const size_t t = e / mb, x = e - t * mb;
  const float* src = partial + t * n_chunks * mb + x;
  float s = src[0];
  for (int k = 1; k < n_chunks; ++k) s = s + src[static_cast<size_t>(k) * mb];
  dP[e] = s;
}

template <typename CodeT>
int fwd(const float* P, const void* codes, int T, int m, int b, int N,
        float* S, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(G) * m * b * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + FWD_CHUNK - 1) / FWD_CHUNK, (T + G - 1) / G);
  fwd_kernel<CodeT><<<grid, NT, smem, stream>>>(
      P, static_cast<const CodeT*>(codes), T, m, b, N, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT>
int bwd(const float* dS, const void* codes, int T, int m, int b, int N,
        int chunk, float* partial, float* dP, cudaStream_t stream) {
  const int n_chunks = (N + chunk - 1) / chunk;
  const size_t smem = (static_cast<size_t>(ROWS) * m * b + ROWS * 32) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_partial_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_partial_kernel<CodeT><<<dim3(n_chunks, (T + ROWS - 1) / ROWS), NT, smem,
                              stream>>>(
      dS, static_cast<const CodeT*>(codes), T, m, b, N, chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(T) * m * b;
  bwd_reduce_kernel<<<static_cast<unsigned>((total + NT - 1) / NT), NT, 0,
                      stream>>>(partial, T, m * b, n_chunks, dP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace jpq_scores

extern "C" {

// Each returns 0, a CUDA error code (> 0), or -1 for arguments the
// kernels do not take (the Python wrapper checks them first).
int jpq_scores_fwd_launch(const void* P, const void* codes, int code_bytes,
                          int T, int m, int b, int N, void* S, void* stream) {
  if (T < 1 || m < 1 || b < 1 || N < 1 || (code_bytes != 1 && code_bytes != 4) ||
      (T + jpq_scores::G - 1) / jpq_scores::G > 65535)
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(P);
  auto s = static_cast<float*>(S);
  if (code_bytes == 1)
    return jpq_scores::fwd<uint8_t>(p, codes, T, m, b, N, s, st);
  return jpq_scores::fwd<int32_t>(p, codes, T, m, b, N, s, st);
}

int jpq_scores_bwd_launch(const void* dS, const void* codes, int code_bytes,
                          int T, int m, int b, int N, int chunk, void* partial,
                          void* dP, void* stream) {
  if (T < 1 || m < 1 || b < 1 || N < 1 || chunk < 32 || chunk % 32 ||
      (code_bytes != 1 && code_bytes != 4) ||
      (T + jpq_scores::ROWS - 1) / jpq_scores::ROWS > 65535)
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const float*>(dS);
  auto pa = static_cast<float*>(partial);
  auto out = static_cast<float*>(dP);
  if (code_bytes == 1)
    return jpq_scores::bwd<uint8_t>(d, codes, T, m, b, N, chunk, pa, out, st);
  return jpq_scores::bwd<int32_t>(d, codes, T, m, b, N, chunk, pa, out, st);
}

size_t jpq_scores_fwd_smem_bytes(int m, int b) {
  return static_cast<size_t>(jpq_scores::G) * m * b * sizeof(float);
}

size_t jpq_scores_bwd_smem_bytes(int m, int b) {
  return (static_cast<size_t>(jpq_scores::ROWS) * m * b +
          jpq_scores::ROWS * 32) * sizeof(float);
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
