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
//
// Backward (embedding_bag_backward_launch; the TPU kernel has none: the
// reference differentiates XLA's gather).  From ids, weights and
// dout [n_bags, d] it computes
//     dtable[v, :] = sum over the flat positions p = n * L + l with
//                    ids[n, l] = v, in ascending p, of w[p] * dout[n, :]
// as one chain a (row, column): +0.0, then __fadd_rn of each term, the
// term the rounded product __fmul_rn(w[p], dout[n, c]) (dout[n, c]
// itself without weights).  The intrinsics keep nvcc from contracting
// the two into an FMA, so the result is bit-equal to the plain version
// on the CPU (index_add_ onto zeros) and identical run to run: no float
// atomics.  The wrapper orders the positions by id first
// (torch.sort(flat ids, stable=True): integer index preparation, no
// float of the gradient), so a row's positions are one run of the
// sorted list, still in ascending p; one memset zero-fills dtable (the
// rows no id names stay +0.0), then:
//   - d >= 32 (bwd_slab_kernel): one warp per (32 sorted positions, slab
//     of 32 * VEC columns).  A lane that holds a run's first position
//     marks it; the warp walks each marked run in turn, loading 32 of
//     its positions and weights at a time with coalesced loads,
//     shuffling them out and keeping U rows of dout in flight; lanes go
//     across the slab's columns (two-tower: d = 256, two slabs).
//   - d < 32 (bwd_run_kernel): one thread per sorted position; the
//     thread that holds a run's first position walks the run, column
//     by column, BU terms in flight (FM's linear term: d = 1, lanes go
//     across runs).
// Ids outside [0, V) sort to the ends: their runs are skipped and the
// first thread writes their presence to bad[0] (the wrapper raises).
// A run is one thread's (or warp's) serial chain, so a row that half of
// all positions name takes as long as the whole chain's dependent adds
// and loads: the first design's limit (ROADMAP, kernel work).
// Limits: V up to 3,090,000 (FM) and 1,000,448 (two-tower) rows and
// n_bags * L up to 65,536 * 50 = 3,276,800 positions on the main path;
// every position, row and element offset is a 64-bit integer (V * d
// and P may pass 2^31), L and d are ints.
// What bounds it: dout, the ids and weights read once and dtable
// written once (two-tower: 1.02 GB of dtable, 0.3 ms at 3.35 TB/s).
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

// ------------------------------------------------------------- backward

constexpr int BU = 16;            // run kernel: terms a thread keeps in flight

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Thread 0 of the grid: 1 in *bad if any id lies outside [0, V) (the
// sorted list's ends).
template <typename IdT>
__device__ __forceinline__ void flag_bad(const IdT* sids, long long P,
                                         long long V, int* bad) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *bad = (static_cast<long long>(sids[0]) < 0 ||
            static_cast<long long>(sids[P - 1]) >= V)
               ? 1
               : 0;
}

template <typename IdT, int VEC>
__global__ void __launch_bounds__(NT)
    bwd_slab_kernel(const IdT* __restrict__ sids,
                    const long long* __restrict__ perm,
                    const float* __restrict__ w,
                    const float* __restrict__ dout, long long P, int L,
                    int d, long long V, float* __restrict__ dtable,
                    int* __restrict__ bad) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  flag_bad(sids, P, V, bad);
  const int lane = threadIdx.x & 31;
  const int cols = d / VEC;
  const int slabs = (cols + 31) / 32;
  const long long gw = static_cast<long long>(blockIdx.x) * NW +
                       (threadIdx.x >> 5);
  const long long chunks = (P + 31) / 32;
  if (gw >= chunks * slabs) return;                   // whole warp
  const long long chunk = gw / slabs;
  const int slab = static_cast<int>(gw - chunk * slabs);
  const int c = slab * 32 + lane;                     // this lane's vector
  const bool active = c < cols;
  const T* grad = reinterpret_cast<const T*>(dout);
  // lane k: is sorted position chunk * 32 + k the first of an in-range run
  const long long i = chunk * 32 + lane;
  long long my_id = -1;
  bool start = false;
  if (i < P) {
    my_id = static_cast<long long>(sids[i]);
    start = my_id >= 0 && my_id < V &&
            (i == 0 || static_cast<long long>(sids[i - 1]) != my_id);
  }
  unsigned starts = __ballot_sync(FULL, start);
  while (starts) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1;
    const long long id = __shfl_sync(FULL, my_id, s);
    T acc = T{};                                      // +0.0
    for (long long j0 = chunk * 32 + s;; j0 += 32) {
      // lane k: position j0 + k, if it is still in the run
      const long long j = j0 + lane;
      const bool in = j < P && static_cast<long long>(sids[j]) == id;
      const long long p = in ? perm[j] : 0;
      const float wt = in && w != nullptr ? w[p] : 1.0f;
      const int cnt = __popc(__ballot_sync(FULL, in));  // a prefix
      for (int s0 = 0; s0 < cnt; s0 += U) {
        T r[U];
        float wu[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {                 // the same on every lane
          const long long pu = __shfl_sync(FULL, p, (s0 + u) & 31);
          wu[u] = __shfl_sync(FULL, wt, (s0 + u) & 31);
          r[u] = T{};
          if (s0 + u < cnt && active)
            r[u] = __ldg(grad + (pu / L) * cols + c);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (s0 + u < cnt)
            acc = vadd(acc, w != nullptr ? V_::mul(r[u], wu[u]) : r[u]);
      }
      if (cnt < 32) break;
    }
    if (active) reinterpret_cast<T*>(dtable)[id * cols + c] = acc;
  }
}

template <typename IdT>
__global__ void __launch_bounds__(NT)
    bwd_run_kernel(const IdT* __restrict__ sids,
                   const long long* __restrict__ perm,
                   const float* __restrict__ w,
                   const float* __restrict__ dout, long long P, int L, int d,
                   long long V, float* __restrict__ dtable,
                   int* __restrict__ bad) {
  flag_bad(sids, P, V, bad);
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= P) return;
  const long long id = static_cast<long long>(sids[i]);
  if (id < 0 || id >= V ||
      (i > 0 && static_cast<long long>(sids[i - 1]) == id))
    return;                                           // not a run's first
  for (int c = 0; c < d; ++c) {
    float acc = 0.0f;
    for (long long j0 = i;; j0 += BU) {
      float t[BU];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < BU; ++u) {
        const long long j = j0 + u;
        t[u] = 0.0f;
        if (j < P && static_cast<long long>(sids[j]) == id) {
          const long long p = perm[j];
          const float g = __ldg(dout + (p / L) * d + c);
          t[u] = w != nullptr ? __fmul_rn(w[p], g) : g;
          ++cnt;
        }
      }
#pragma unroll
      for (int u = 0; u < BU; ++u)
        if (u < cnt) acc = __fadd_rn(acc, t[u]);
      if (cnt < BU) break;
    }
    dtable[id * d + c] = acc;
  }
}

template <typename IdT>
int launch_bwd_ids(const void* sorted_ids, const long long* perm,
                   const float* w, const float* dout, long long P, int L,
                   int d, long long V, float* dtable, int* bad,
                   cudaStream_t st) {
  const auto sid = static_cast<const IdT*>(sorted_ids);
  if (d < SMALL) {
    bwd_run_kernel<IdT><<<static_cast<unsigned>((P + NT - 1) / NT), NT, 0,
                           st>>>(sid, perm, w, dout, P, L, d, V, dtable,
                                 bad);
  } else if (vec4(dout, dtable, d)) {
    const long long slabs = (d / 4 + 31) / 32;
    bwd_slab_kernel<IdT, 4><<<blocks((P + 31) / 32 * slabs), NT, 0, st>>>(
        sid, perm, w, dout, P, L, d, V, dtable, bad);
  } else {
    const long long slabs = (d + 31) / 32;
    bwd_slab_kernel<IdT, 1><<<blocks((P + 31) / 32 * slabs), NT, 0, st>>>(
        sid, perm, w, dout, P, L, d, V, dtable, bad);
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

// The backward on `stream`: dtable [V, d] f32, zero-filled here (one
// memset) and then each named row written once, from the flat ids sorted
// stably (`sorted_ids`, P of `id_bytes` each), their flat positions
// (`perm`, int64), the weights by flat position (or null: unit weights)
// and dout [n_bags, d]; bad [1] int32: 1 if any id lies outside [0, V).
// Returns 0, a CUDA error code (> 0), or -1 for arguments the kernel does
// not take.
int embedding_bag_backward_launch(const void* sorted_ids, int id_bytes,
                                  const void* perm, const void* weights,
                                  const void* dout, long long P, int L,
                                  int d, long long V, void* dtable,
                                  void* bad, void* stream) {
  if (V < 1 || d < 1 || P < 1 || L < 1 || (id_bytes != 4 && id_bytes != 8))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<const long long*>(perm);
  auto w = static_cast<const float*>(weights);
  auto g = static_cast<const float*>(dout);
  auto o = static_cast<float*>(dtable);
  auto b = static_cast<int*>(bad);
  const cudaError_t rc = cudaMemsetAsync(
      dtable, 0, static_cast<size_t>(V) * static_cast<size_t>(d) * 4, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (id_bytes == 4)
    return embedding_bag::launch_bwd_ids<int32_t>(sorted_ids, pm, w, g, P, L,
                                                  d, V, o, b, st);
  return embedding_bag::launch_bwd_ids<int64_t>(sorted_ids, pm, w, g, P, L,
                                                d, V, o, b, st);
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
