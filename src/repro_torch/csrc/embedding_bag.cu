// embedding_bag: fixed-fanout EmbeddingBag (gather + weighted sum over a
// bag's slots), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel embedding_bag_fixed (src/repro/kernels/
// embedding_bag/embedding_bag.py, pallas_call at :59, body _kernel at
// :29).  From table [V, d] f32, ids [n_bags, L] and weights [n_bags, L]
// (or none: unit weights) it computes
//     out[n, :] = sum_l w[n, l] * table[ids[n, l], :]
// accumulated in slot order l = 0..L-1, as the TPU kernel's grid does:
// slot 0 is the rounded product row * w (__fmul_rn, so a -0.0 product
// stays -0.0, as the TPU kernel's "o = row * w" keeps it), and every later
// slot one fused multiply-add fmaf(row, w, acc).  Both steps are written
// out, so the result does not depend on whether nvcc contracts a multiply
// and an add (--fmad).
//
// What bounds it.  Bytes: each of the n_bags * L gathered rows is read
// once (d * 4 bytes), plus the ids, weights and the [n_bags, d] output.
// At the two-tower serving shape (B = 512, L = 50, d = 256) that is 27 MB,
// 8 us at 3.35 TB/s; at the FM linear term (d = 1) a few hundred KB, so
// launch latency is the limit there.
//
// Design.  One thread per (bag, group of VEC columns): VEC = 4 (float4
// loads) when d % 4 == 0, else 1, so the threads of a bag read one table
// row as consecutive 16- or 4-byte words.  A bag
// of d = 256 takes 64 threads and a block of 256 threads four bags; at
// d = 1 a warp covers 32 bags.  The slots are walked U at a time: the U
// ids and rows are loaded first (U rows in flight per thread), then
// accumulated in slot order.  Nothing is shared between threads, so no
// shared memory or barrier.  The TPU kernel's scalar-prefetched row DMA
// per grid step becomes these independent gathers.
//
// Ids outside [0, V) are never read: the thread takes NaN for that row
// and adds one to *bad (one thread per bag and slot), which the launcher
// zeroes first; the wrapper reads it and raises.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace embedding_bag {

constexpr int NT = 256;   // threads per block
constexpr int U = 8;      // slots whose rows are in flight together

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T nan() { return NAN; }
  static __device__ __forceinline__ T mul(T r, float w) {
    return __fmul_rn(r, w);
  }
  static __device__ __forceinline__ T fma(T r, float w, T a) {
    return fmaf(r, w, a);
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T nan() {
    return make_float4(NAN, NAN, NAN, NAN);
  }
  static __device__ __forceinline__ T mul(T r, float w) {
    return make_float4(__fmul_rn(r.x, w), __fmul_rn(r.y, w),
                       __fmul_rn(r.z, w), __fmul_rn(r.w, w));
  }
  static __device__ __forceinline__ T fma(T r, float w, T a) {
    return make_float4(fmaf(r.x, w, a.x), fmaf(r.y, w, a.y),
                       fmaf(r.z, w, a.z), fmaf(r.w, w, a.w));
  }
};

template <typename IdT, int VEC>
__global__ void __launch_bounds__(NT)
    bag_kernel(const float* __restrict__ table, long long V, int d,
               const IdT* __restrict__ ids, const float* __restrict__ w,
               int n_bags, int L, float* __restrict__ out,
               int* __restrict__ bad) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  const int cols = d / VEC;
  const long long e = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (e >= static_cast<long long>(n_bags) * cols) return;
  const long long n = e / cols;
  const int c = static_cast<int>(e - n * cols);
  const IdT* bag_ids = ids + n * L;
  const float* bag_w = w == nullptr ? nullptr : w + n * L;
  const T* rows = reinterpret_cast<const T*>(table);
  T acc = V_::nan();
  for (int l0 = 0; l0 < L; l0 += U) {
    T r[U];
    float wt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u;
      if (l < L) {
        const long long id = static_cast<long long>(bag_ids[l]);
        wt[u] = bag_w == nullptr ? 1.0f : bag_w[l];
        if (id >= 0 && id < V) {
          r[u] = __ldg(rows + id * cols + c);
        } else {
          r[u] = V_::nan();
          if (c == 0) atomicAdd(bad, 1);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + u;
      if (l < L) acc = l == 0 ? V_::mul(r[u], wt[u]) : V_::fma(r[u], wt[u], acc);
    }
  }
  reinterpret_cast<T*>(out)[n * cols + c] = acc;
}

template <typename IdT, int VEC>
int launch_vec(const float* table, long long V, int d, const void* ids,
               const float* w, int n_bags, int L, float* out, int* bad,
               cudaStream_t st) {
  const long long threads = static_cast<long long>(n_bags) * (d / VEC);
  const unsigned blocks = static_cast<unsigned>((threads + NT - 1) / NT);
  bag_kernel<IdT, VEC><<<blocks, NT, 0, st>>>(
      table, V, d, static_cast<const IdT*>(ids), w, n_bags, L, out, bad);
  return static_cast<int>(cudaGetLastError());
}

// float4 loads where the row width and the two pointers allow them
bool vec4(const void* table, const void* out, int d) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return d % 4 == 0 && aligned(table) && aligned(out);
}

template <typename IdT>
int launch_ids(const float* table, long long V, int d, const void* ids,
               const float* w, int n_bags, int L, float* out, int* bad,
               cudaStream_t st) {
  if (vec4(table, out, d))
    return launch_vec<IdT, 4>(table, V, d, ids, w, n_bags, L, out, bad, st);
  return launch_vec<IdT, 1>(table, V, d, ids, w, n_bags, L, out, bad, st);
}

}  // namespace embedding_bag

extern "C" {

// Zeroes *bad, then launches the kernel on `stream`.  Returns 0, a CUDA
// error code (> 0), or -1 for arguments the kernel does not take (the
// Python wrapper checks them first).  `weights` may be null: unit
// weights.
int embedding_bag_launch(const void* table, long long V, int d,
                         const void* ids, int id_bytes, const void* weights,
                         int n_bags, int L, void* out, void* bad,
                         void* stream) {
  if (V < 1 || d < 1 || n_bags < 1 || L < 1 ||
      (id_bytes != 4 && id_bytes != 8))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<int*>(bad);
  const cudaError_t err = cudaMemsetAsync(b, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto t = static_cast<const float*>(table);
  auto w = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  if (id_bytes == 4)
    return embedding_bag::launch_ids<int32_t>(t, V, d, ids, w, n_bags, L, o,
                                              b, st);
  return embedding_bag::launch_ids<int64_t>(t, V, d, ids, w, n_bags, L, o, b,
                                            st);
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
