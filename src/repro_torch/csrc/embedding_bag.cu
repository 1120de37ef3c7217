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
// the latency of the dependent id -> row loads is the limit there, and
// at B = 512 the host's issue time is larger than either.
//
// Design.  A bag's loads are all issued at once across a warp, and every
// SM gets work at B = 512 (blocks of 4 warps):
//   - d >= 32 (slab_kernel): one warp per (bag, slab of 32 * VEC
//     columns), VEC = 4 (float4 rows) when d % 4 == 0 and the table and
//     output are 16-byte aligned, else 1.  The lanes load 32 of the
//     bag's ids and weights with one coalesced load each and shuffle
//     them out; each lane then keeps U = 8 rows in flight and runs the
//     slot-order chain of its columns.  At d = 256 a bag takes two warps.
//   - d < 32 (staged_kernel): one warp per bag.  Lane s loads the id and
//     weight of slot s; the warp then loads the 32 slots' rows, d floats
//     each, spread over all lanes (one round trip), into shared memory,
//     and lane c < d runs column c's chain over them in slot order.  FM's
//     d = 1 linear term is one warp a bag instead of one thread.
// The TPU kernel's scalar-prefetched row DMA per grid step becomes these
// independent gathers.
//
// Ids outside [0, V) are never read: their row is NaN and the warp that
// owns the bag's first slab writes the bag's count of them to bad[n]
// (written for every bag, so the launcher zeroes nothing: one device
// operation a call).  The wrapper sums bad and raises.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace embedding_bag {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 128;           // threads a block
constexpr int NW = NT / 32;       // warps a block
constexpr int U = 8;              // slab: rows a lane keeps in flight
constexpr int SMALL = 32;         // d below this takes staged_kernel

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

// Lane s's slot l0 + s of the bag: its id (-1 when outside [0, V), and
// then *nbad counts it) and weight.  Lanes past L get id -1, weight 0.
template <typename IdT>
__device__ __forceinline__ long long slot(const IdT* bag_ids,
                                          const float* bag_w, int l, int L,
                                          long long V, float* wt, int* nbad) {
  if (l >= L) {
    *wt = 0.f;
    return -1;
  }
  const long long id = static_cast<long long>(bag_ids[l]);
  *wt = bag_w == nullptr ? 1.0f : bag_w[l];
  if (id >= 0 && id < V) return id;
  ++*nbad;
  return -1;
}

template <typename IdT, int VEC>
__global__ void __launch_bounds__(NT)
    slab_kernel(const float* __restrict__ table, long long V, int d,
                const IdT* __restrict__ ids, const float* __restrict__ w,
                int n_bags, int L, float* __restrict__ out,
                int* __restrict__ bad) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  const int lane = threadIdx.x & 31;
  const int cols = d / VEC;                      // vectors a row
  const int slabs = (cols + 31) / 32;
  const long long gw = static_cast<long long>(blockIdx.x) * NW +
                       (threadIdx.x >> 5);
  if (gw >= static_cast<long long>(n_bags) * slabs) return;  // whole warp
  const long long n = gw / slabs;
  const int slab = static_cast<int>(gw - n * slabs);
  const int c = slab * 32 + lane;                // this lane's vector
  const bool active = c < cols;
  const IdT* bag_ids = ids + n * L;
  const float* bag_w = w == nullptr ? nullptr : w + n * L;
  const T* rows = reinterpret_cast<const T*>(table);
  T acc = V_::nan();
  int nbad = 0;
  for (int l0 = 0; l0 < L; l0 += 32) {
    float my_w;
    const long long my_id =
        slot(bag_ids, bag_w, l0 + lane, L, V, &my_w, &nbad);
    const int cnt = min(32, L - l0);
    for (int s0 = 0; s0 < cnt; s0 += U) {
      T r[U];
      float wt[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {              // the same on every lane
        const long long id = __shfl_sync(FULL, my_id, (s0 + u) & 31);
        wt[u] = __shfl_sync(FULL, my_w, (s0 + u) & 31);
        r[u] = V_::nan();
        if (s0 + u < cnt && active && id >= 0)
          r[u] = __ldg(rows + id * cols + c);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int l = l0 + s0 + u;
        if (s0 + u < cnt)
          acc = l == 0 ? V_::mul(r[u], wt[u]) : V_::fma(r[u], wt[u], acc);
      }
    }
  }
  if (active) reinterpret_cast<T*>(out)[n * cols + c] = acc;
  nbad = __reduce_add_sync(FULL, nbad);
  if (slab == 0 && lane == 0) bad[n] = nbad;
}

template <typename IdT>
__global__ void __launch_bounds__(NT)
    staged_kernel(const float* __restrict__ table, long long V, int d,
                  const IdT* __restrict__ ids, const float* __restrict__ w,
                  int n_bags, int L, float* __restrict__ out,
                  int* __restrict__ bad) {
  __shared__ float vals[NW][32 * SMALL];       // [slot, column]
  __shared__ float wts[NW][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * NW + wid;
  if (n >= n_bags) return;                     // whole warp
  const IdT* bag_ids = ids + n * L;
  const float* bag_w = w == nullptr ? nullptr : w + n * L;
  float* v = vals[wid];
  float acc = NAN;
  int nbad = 0;
  for (int l0 = 0; l0 < L; l0 += 32) {
    float my_w;
    const long long my_id =
        slot(bag_ids, bag_w, l0 + lane, L, V, &my_w, &nbad);
    wts[wid][lane] = my_w;
    const int cnt = min(32, L - l0);
    const int ne = cnt * d;                    // floats of the chunk's rows
#pragma unroll 4
    for (int e0 = 0; e0 < ne; e0 += 32) {      // the same on every lane
      const int e = e0 + lane;
      const int s = min(e / d, 31);
      const long long id = __shfl_sync(FULL, my_id, s);
      if (e < ne)
        v[e] = id >= 0 ? __ldg(table + id * d + (e - s * d)) : NAN;
    }
    __syncwarp();
    if (lane < d) {
      for (int s = 0; s < cnt; ++s) {
        const float r = v[s * d + lane], wt = wts[wid][s];
        acc = l0 + s == 0 ? __fmul_rn(r, wt) : fmaf(r, wt, acc);
      }
    }
    __syncwarp();
  }
  if (lane < d) out[n * d + lane] = acc;
  nbad = __reduce_add_sync(FULL, nbad);
  if (lane == 0) bad[n] = nbad;
}

// float4 loads where the row width and the two pointers allow them
bool vec4(const void* table, const void* out, int d) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return d % 4 == 0 && aligned(table) && aligned(out);
}

unsigned blocks(long long warps) {
  return static_cast<unsigned>((warps + NW - 1) / NW);
}

template <typename IdT>
int launch_ids(const float* table, long long V, int d, const void* ids,
               const float* w, int n_bags, int L, float* out, int* bad,
               cudaStream_t st) {
  const auto id = static_cast<const IdT*>(ids);
  if (d < SMALL) {
    staged_kernel<IdT><<<blocks(n_bags), NT, 0, st>>>(table, V, d, id, w,
                                                       n_bags, L, out, bad);
  } else if (vec4(table, out, d)) {
    const long long slabs = (d / 4 + 31) / 32;
    slab_kernel<IdT, 4><<<blocks(n_bags * slabs), NT, 0, st>>>(
        table, V, d, id, w, n_bags, L, out, bad);
  } else {
    const long long slabs = (d + 31) / 32;
    slab_kernel<IdT, 1><<<blocks(n_bags * slabs), NT, 0, st>>>(
        table, V, d, id, w, n_bags, L, out, bad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace embedding_bag

extern "C" {

// Launches the kernel on `stream`: out [n_bags, d] and bad [n_bags]
// int32, the count of each bag's ids outside [0, V).  Returns 0, a CUDA
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
  auto t = static_cast<const float*>(table);
  auto w = static_cast<const float*>(weights);
  auto o = static_cast<float*>(out);
  auto b = static_cast<int*>(bad);
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
