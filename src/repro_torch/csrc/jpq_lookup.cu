// jpq_lookup: RecJPQ input-side item embedding, forward and backward,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel jpq_lookup_tiles (src/repro/kernels/jpq_lookup/
// jpq_lookup.py, pallas_call at :62, body _kernel at :26).  Forward:
//     out[i, j, :] = centroids[j, codes[ids[i], j], :]
// from ids [T], codes [N, m] and centroids [m, b, dk].  The TPU kernel
// has no backward (jax.grad raises on it); this file adds
//     dcent[j, c, :] = sum_{i : codes[ids[i], j] = c} dout[i, j, :]
// so the input side trains through the kernel.
//
// What bounds them.  Little data: at T = 3,200, m = 8, dk = 64 the
// forward writes 6.6 MB and reads the 0.5 MB centroid tensor and T code
// rows; a few microseconds at 3.35 TB/s, so launch latency is the limit.
//
// Forward design.  A pure gather, one thread per output float: the
// threads of a warp copy 32 consecutive floats of one centroid row, so
// reads and writes are coalesced.  Bit-equal to the reference gather.
// The TPU kernel's one-hot [m, b] x centroids contraction is an MXU
// device and is not carried over.  An id outside [0, N) is clamped so
// that no thread reads outside codes; callers pass valid ids.
//
// Backward design.  Deterministic: no float atomics.  Each thread owns
// one output float dcent[j, c, k] and walks the positions i = 0..T-1 in
// order, adding dout[i, j, k] where position i's code in split j is c.
// The block stages the codes of a tile of positions in shared memory
// (one read of codes per tile for all its threads); every thread of a
// warp shares (j, c) unless the warp straddles two codes, so the test is
// nearly uniform.  Positions of padding (id 0) are summed like any other:
// their dout is zero where the model zeroes them.
#include <cstdint>
#include <cuda_runtime.h>

namespace jpq_lookup {

constexpr int NT = 256;
constexpr int TILE = 2048;   // backward: positions staged per pass

__device__ __forceinline__ long long clamp_id(long long id, int N) {
  return id < 0 ? 0 : (id >= N ? N - 1 : id);
}

template <typename CodeT, typename IdT>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const IdT* __restrict__ ids, const CodeT* __restrict__ codes,
               const float* __restrict__ cent, int T, int m, int b, int dk,
               int N, float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  const size_t row = static_cast<size_t>(m) * dk;
  if (e >= static_cast<size_t>(T) * row) return;
  const size_t i = e / row;
  const int r = static_cast<int>(e - i * row);
  const int j = r / dk, k = r - j * dk;
  const long long id = clamp_id(static_cast<long long>(ids[i]), N);
  const int c = static_cast<int>(codes[id * m + j]);
  out[e] = cent[(static_cast<size_t>(j) * b + c) * dk + k];
}

template <typename CodeT, typename IdT>
__global__ void __launch_bounds__(NT)
    bwd_kernel(const IdT* __restrict__ ids, const CodeT* __restrict__ codes,
               const float* __restrict__ dout, int T, int m, int b, int dk,
               int N, float* __restrict__ dcent) {
  __shared__ int tile_codes[TILE];
  const int j = blockIdx.y;
  const int g = blockIdx.x * NT + threadIdx.x;   // (c, k) inside split j
  const bool live = g < b * dk;
  const int c = live ? g / dk : -1;
  const int k = live ? g - c * dk : 0;
  float acc = 0.f;
  for (int i0 = 0; i0 < T; i0 += TILE) {
    const int n = min(TILE, T - i0);
    __syncthreads();
    for (int x = threadIdx.x; x < n; x += NT) {
      const long long id = clamp_id(static_cast<long long>(ids[i0 + x]), N);
      tile_codes[x] = static_cast<int>(codes[id * m + j]);
    }
    __syncthreads();
    if (live) {
      for (int x = 0; x < n; ++x)
        if (tile_codes[x] == c)
          acc = acc + dout[(static_cast<size_t>(i0 + x) * m + j) * dk + k];
    }
  }
  if (live) dcent[(static_cast<size_t>(j) * b + c) * dk + k] = acc;
}

template <typename CodeT, typename IdT>
int fwd(const void* ids, const void* codes, const float* cent, int T, int m,
        int b, int dk, int N, float* out, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(T) * m * dk;
  fwd_kernel<CodeT, IdT><<<static_cast<unsigned>((total + NT - 1) / NT), NT,
                           0, stream>>>(
      static_cast<const IdT*>(ids), static_cast<const CodeT*>(codes), cent, T,
      m, b, dk, N, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT, typename IdT>
int bwd(const void* ids, const void* codes, const float* dout, int T, int m,
        int b, int dk, int N, float* dcent, cudaStream_t stream) {
  const dim3 grid((b * dk + NT - 1) / NT, m);
  bwd_kernel<CodeT, IdT><<<grid, NT, 0, stream>>>(
      static_cast<const IdT*>(ids), static_cast<const CodeT*>(codes), dout, T,
      m, b, dk, N, dcent);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdT>
int fwd_ids(const void* ids, const void* codes, int code_bytes,
            const float* cent, int T, int m, int b, int dk, int N, float* out,
            cudaStream_t st) {
  if (code_bytes == 1)
    return fwd<uint8_t, IdT>(ids, codes, cent, T, m, b, dk, N, out, st);
  return fwd<int32_t, IdT>(ids, codes, cent, T, m, b, dk, N, out, st);
}

template <typename IdT>
int bwd_ids(const void* ids, const void* codes, int code_bytes,
            const float* dout, int T, int m, int b, int dk, int N,
            float* dcent, cudaStream_t st) {
  if (code_bytes == 1)
    return bwd<uint8_t, IdT>(ids, codes, dout, T, m, b, dk, N, dcent, st);
  return bwd<int32_t, IdT>(ids, codes, dout, T, m, b, dk, N, dcent, st);
}

bool bad_args(int id_bytes, int code_bytes, int T, int m, int b, int dk,
              int N) {
  return T < 1 || m < 1 || b < 1 || dk < 1 || N < 1 || m > 65535 ||
         (id_bytes != 4 && id_bytes != 8) ||
         (code_bytes != 1 && code_bytes != 4);
}

}  // namespace jpq_lookup

extern "C" {

// Each returns 0, a CUDA error code (> 0), or -1 for arguments the
// kernels do not take (the Python wrapper checks them first).
int jpq_lookup_fwd_launch(const void* ids, int id_bytes, const void* codes,
                          int code_bytes, const void* cent, int T, int m,
                          int b, int dk, int N, void* out, void* stream) {
  if (jpq_lookup::bad_args(id_bytes, code_bytes, T, m, b, dk, N)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(cent);
  auto o = static_cast<float*>(out);
  if (id_bytes == 4)
    return jpq_lookup::fwd_ids<int32_t>(ids, codes, code_bytes, c, T, m, b,
                                        dk, N, o, st);
  return jpq_lookup::fwd_ids<int64_t>(ids, codes, code_bytes, c, T, m, b, dk,
                                      N, o, st);
}

int jpq_lookup_bwd_launch(const void* ids, int id_bytes, const void* codes,
                          int code_bytes, const void* dout, int T, int m,
                          int b, int dk, int N, void* dcent, void* stream) {
  if (jpq_lookup::bad_args(id_bytes, code_bytes, T, m, b, dk, N)) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const float*>(dout);
  auto o = static_cast<float*>(dcent);
  if (id_bytes == 4)
    return jpq_lookup::bwd_ids<int32_t>(ids, codes, code_bytes, d, T, m, b,
                                        dk, N, o, st);
  return jpq_lookup::bwd_ids<int64_t>(ids, codes, code_bytes, d, T, m, b, dk,
                                      N, o, st);
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
