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
// Backward (the TPU kernel has none: the reference differentiates XLA's
// gather).  From ids, weights and dout [n_bags, d] it computes
//     dtable[v, :] = sum over the flat positions p = n * L + l with
//                    ids[n, l] = v, in ascending p, of w[p] * dout[n, :]
// as one chain a (row, column): +0.0, then __fadd_rn of each term, the
// term the rounded product __fmul_rn(w[p], dout[n, c]) (dout[n, c]
// itself without weights).  The intrinsics keep nvcc from contracting
// the two into an FMA, so the result is bit-equal to the plain version
// on the CPU (index_add_ onto zeros) and identical run to run: no float
// atomics, and every chain has one owner.  The same function with L = 1
// and unit weights is the gradient of a plain gather table[ids]
// (`wrap`: a negative id counts from the end, as indexing reads it).
//
// What bounds it.  Bytes: dout, the ids and weights read once, dtable
// written once (two-tower slice: 1.02 GB of dtable, 0.32 ms at 3.35
// TB/s).  And, since a chain is never split, the chain: the longest run
// of one id times the latency of a dependent fp32 add (4 cycles), 0.66
// ms for a 327,680-term pad run at 1.98 GHz.
//
// Design.
//   1. Index preparation (embedding_bag_sort_launch; integer work, no
//      float of the gradient): keys_kernel turns the ids into 32-bit keys
//      (an id outside [0, V) becomes the sentinel V) beside 32-bit flat
//      positions (64-bit when P >= 2^31); CUB's stable radix sort orders
//      the pairs over only the ceil(log2(V + 1)) bits a key has, so equal
//      ids keep ascending p; offsets_kernel writes the row offsets
//      offs[V + 1] (a thread a sorted position writes the rows between
//      its key and the one before; a warp shares a long gap), flags the
//      sentinel (an id outside [0, V)) and lists the rows whose run is
//      longer than `long_run` terms (an integer atomic fills the list;
//      each listed run still has one owner, so the order of the list does
//      not reach the result).
//   2. Short runs and empty rows (a warp a group of 32 rows; every row of
//      dtable is written exactly once, unnamed rows as +0.0, so nothing
//      is zero-filled first).  The group's short runs are one contiguous
//      list of terms; the lanes load 32 terms' positions and weights at
//      once and find each term's row with a five-step search over the
//      warp's run offsets.
//      - d >= 32 (rows_slab_kernel): lanes across the columns, VEC
//        floats a vector (4: float4 when d % 4 == 0 and dout and dtable
//        are 16-byte aligned) and up to two vectors a lane (d = 256: the
//        whole row), two chunks' positions and weights loaded at once,
//        RU vectors in flight, each row's chain stored when the next
//        row's terms begin.
//      - d < 32 (rows_small_kernel): a chunk's products staged in shared
//        memory, d floats a term; then lanes across the group's (row,
//        column) outputs, d a lane, so the chains run side by side and
//        the group's rows are stored as one contiguous block.
//      dtable's rows go out with streaming stores (__stcs), so the
//      gigabyte of them pushes less of dout out of L2.
//   3. Long runs (long_kernel, a persistent grid that takes (run, slab)
//      items from the list; a slab is the whole row at d < 32, else 16
//      columns): a CTA an item.  Five producer warps each own a 32 KB
//      slot of a shared-memory ring: a producer turns its stage's
//      positions (loaded a stage ahead) into dout rows and weights, then
//      gathers the terms' row pieces straight into the slot with cp.async
//      (16, 8 or 4 bytes a copy, as dout's alignment and the slab allow)
//      and, with weights, forms the products in place; one adder warp, a
//      lane a column, adds the slots' terms in ascending p, its loads of
//      the next 16 terms interleaved with the dependent adds (a stride
//      known at compile time for the widths the models use).  Named
//      barriers (bar.arrive / bar.sync, a full and an empty one a slot)
//      hand the slots over.  A run is split across CTAs by column slab,
//      never by position.  It runs on a second stream forked from the
//      caller's and joined back, beside the short-run kernel: the two
//      write disjoint rows, so a long chain overlaps the table's write.
// Limits: every position, row and element offset is a 64-bit integer in
// the arithmetic (V * d and P may pass 2^31); V < 2^31; L and d are ints.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include <algorithm>
#include <cub/device/device_radix_sort.cuh>
#include <mutex>

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

constexpr int BT = 256;           // index kernels: threads a block
constexpr int RU = 16;            // slab rows: dout vectors a lane keeps in flight
constexpr int LT = 192;           // long_kernel: threads a block
constexpr int LW = LT / 32 - 1;   // its producer warps, one ring slot each
constexpr int LE = 8192;          // products a slot holds
constexpr int LK = 512;           // terms a slot holds at most
constexpr int AU = 16;            // the adder's terms a register block
constexpr int LC = 16;            // columns a long item takes at d >= 32
constexpr int LI = LK / 32;       // positions a producer lane loads a stage

// the bits a key has: the sentinel V included
inline int key_bits(long long V) {
  int b = 1;
  while ((1LL << b) <= V) ++b;
  return b;
}

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// named barriers of long_kernel (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Keys and positions for the sort: key p = ids[p] (+ V when `wrap` and
// negative), or the sentinel V for an id outside [0, V); pos[p] = p.
// Thread 0 also clears the long-run list's counters.
template <typename IdT, typename PosT>
__global__ void __launch_bounds__(BT)
    keys_kernel(const IdT* __restrict__ ids, long long P, long long V,
                int wrap, unsigned* __restrict__ keys,
                PosT* __restrict__ pos, int* __restrict__ counters) {
  const long long i = static_cast<long long>(blockIdx.x) * BT + threadIdx.x;
  if (i == 0) {
    counters[0] = 0;
    counters[1] = 0;
    counters[2] = 0;
  }
  if (i >= P) return;
  long long id = static_cast<long long>(ids[i]);
  if (wrap && id < 0) id += V;
  keys[i] = static_cast<unsigned>(id >= 0 && id < V ? id : V);
  pos[i] = static_cast<PosT>(i);
}

// From the sorted keys: offs[r] = the first sorted position whose key is
// >= r, for r in [0, V] (offs[V]: the first sentinel, P when none).  The
// thread of sorted position i (i in [0, P]) writes the rows between the
// key before it and its own; a warp writes a gap longer than 32 rows
// together.  The thread that writes offs[V] sets *bad to 1 if a sentinel
// exists.  A run longer than long_run terms appends its row to `work`.
template <typename PosT>
__global__ void __launch_bounds__(BT)
    offsets_kernel(const unsigned* __restrict__ skeys, long long P,
                   long long V, int long_run, PosT* __restrict__ offs,
                   unsigned* __restrict__ work, int* __restrict__ counters,
                   int* __restrict__ bad) {
  const long long i = static_cast<long long>(blockIdx.x) * BT + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = -1;                  // rows lo..hi get offs = i
  if (i <= P) {
    const unsigned cur = i < P ? skeys[i] : static_cast<unsigned>(V);
    lo = i == 0 ? 0 : static_cast<long long>(skeys[i - 1]) + 1;
    hi = cur;
    if (hi == V && lo <= hi) *bad = i < P ? 1 : 0;
    if (i < P && cur < V && (i == 0 || skeys[i - 1] != cur) &&
        i + long_run < P && skeys[i + long_run] == cur)
      work[atomicAdd(counters, 1)] = cur;
  }
  const long long n = hi - lo + 1;
  if (n > 0 && n <= 32)
    for (long long r = lo; r <= hi; ++r) offs[r] = static_cast<PosT>(i);
  unsigned big = __ballot_sync(FULL, n > 32);
  while (big) {
    const int s = __ffs(big) - 1;
    big &= big - 1;
    const long long blo = __shfl_sync(FULL, lo, s);
    const long long bhi = __shfl_sync(FULL, hi, s);
    const long long bi = __shfl_sync(FULL, i, s);
    for (long long r = blo + lane; r <= bhi; r += 32)
      offs[r] = static_cast<PosT>(bi);
  }
}

// The dout row of flat position p (bags of L): a 32-bit division where
// the positions are 32-bit.
template <typename PosT>
__device__ __forceinline__ long long row_of_pos(long long p, int L) {
  if (L == 1) return p;
  if (sizeof(PosT) == 4)
    return static_cast<unsigned>(p) / static_cast<unsigned>(L);
  return p / L;
}

// A warp's group of 32 rows v0 + r: lane r's run (its first sorted
// position `lo`, its terms `cnt` if short, else 0), whether the row is
// empty or long, and the exclusive scan of cnt over the lanes: the
// group's short runs as one list of `total` terms, lane r's from excl.
template <typename PosT>
struct Group {
  long long lo = 0;
  int cnt = 0, excl = 0, total = 0;
  bool empty = false, lng = false;
  __device__ __forceinline__ Group(const PosT* offs, long long v0, int nr,
                                   int long_run, int lane) {
    if (lane < nr) {
      lo = static_cast<long long>(offs[v0 + lane]);
      const long long n = static_cast<long long>(offs[v0 + lane + 1]) - lo;
      empty = n == 0;
      lng = n > long_run;
      cnt = lng ? 0 : static_cast<int>(n);
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    excl = incl - cnt;
    total = __shfl_sync(FULL, incl, 31);
  }
  // the group row (lane) of list term t: the last r with excl_r <= t
  __device__ __forceinline__ int row_of(int t) const {
    int r = 0;
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1)
      if (__shfl_sync(FULL, excl, r + s) <= t) r += s;
    return r;
  }
};

// List term t's flat position (or 0 past the list), its dout row and
// weight; r: its group row.
template <typename PosT>
__device__ __forceinline__ long long list_term(const Group<PosT>& g,
                                               const PosT* perm,
                                               const float* w, int L, int t,
                                               int r, float* wt) {
  const long long rlo = __shfl_sync(FULL, g.lo, r);
  const int rex = __shfl_sync(FULL, g.excl, r);
  *wt = 1.0f;
  if (t >= g.total) return 0;
  const long long p = static_cast<long long>(perm[rlo + (t - rex)]);
  if (w != nullptr) *wt = w[p];
  return row_of_pos<PosT>(p, L);
}

template <typename PosT, int VEC, int NV>
__global__ void __launch_bounds__(NT)
    rows_slab_kernel(const PosT* __restrict__ perm,
                     const PosT* __restrict__ offs,
                     const float* __restrict__ w,
                     const float* __restrict__ dout, int L, int d,
                     long long V, int long_run, float* __restrict__ dtable) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  constexpr int R = RU / NV;                          // rows in flight
  const int lane = threadIdx.x & 31;
  const int cols = d / VEC;
  const int slabs = (cols + 32 * NV - 1) / (32 * NV);
  const long long gw = static_cast<long long>(blockIdx.x) * NW +
                       (threadIdx.x >> 5);
  if (gw >= (V + 31) / 32 * slabs) return;            // whole warp
  const long long grp = gw / slabs;
  const int slab = static_cast<int>(gw - grp * slabs);
  const long long v0 = grp * 32;
  const int nr = static_cast<int>(min(32LL, V - v0));
  const int c = slab * 32 * NV + lane;                // lane's vectors: c + 32 i
  const T* grad = reinterpret_cast<const T*>(dout);
  T* out = reinterpret_cast<T*>(dtable);
  const Group<PosT> g(offs, v0, nr, long_run, lane);
  unsigned em = __ballot_sync(FULL, g.empty);
  while (em) {                                        // unnamed rows: +0.0
    const int r = __ffs(em) - 1;
    em &= em - 1;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (c + 32 * i < cols) __stcs(out + (v0 + r) * cols + c + 32 * i, T{});
  }
  T acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T{};
  int cur = -1;                                       // acc's group row
  // one chunk of m list terms: lane u's term has group row r, dout row
  // `row` and weight wt
  const auto chunk = [&](int r, long long row, float wt, int m) {
    for (int u0 = 0; u0 < m; u0 += R) {
      T gv[R][NV];
#pragma unroll
      for (int u = 0; u < R; ++u) {                   // the same on every lane
        const long long ru = __shfl_sync(FULL, row, (u0 + u) & 31);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          gv[u][i] = T{};
          if (u0 + u < m && c + 32 * i < cols)
            gv[u][i] = __ldg(grad + ru * cols + c + 32 * i);
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int ru = __shfl_sync(FULL, r, (u0 + u) & 31);
        const float wu = __shfl_sync(FULL, wt, (u0 + u) & 31);
        if (u0 + u < m) {
          if (ru != cur) {
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              if (cur >= 0 && c + 32 * i < cols)
                __stcs(out + (v0 + cur) * cols + c + 32 * i, acc[i]);
              acc[i] = T{};
            }
            cur = ru;
          }
#pragma unroll
          for (int i = 0; i < NV; ++i)
            acc[i] = vadd(acc[i],
                          w != nullptr ? V_::mul(gv[u][i], wu) : gv[u][i]);
        }
      }
    }
  };
  for (int t0 = 0; t0 < g.total; t0 += 64) {
    // the positions and weights of two chunks at once
    const int ta = t0 + lane, tb = t0 + 32 + lane;
    const int ra = g.row_of(ta), rb = g.row_of(tb);
    const long long la = __shfl_sync(FULL, g.lo, ra) - __shfl_sync(FULL, g.excl, ra);
    const long long lb = __shfl_sync(FULL, g.lo, rb) - __shfl_sync(FULL, g.excl, rb);
    const long long pa = ta < g.total ? static_cast<long long>(perm[la + ta]) : 0;
    const long long pb = tb < g.total ? static_cast<long long>(perm[lb + tb]) : 0;
    float wa = 1.0f, wb = 1.0f;
    if (w != nullptr) {
      if (ta < g.total) wa = w[pa];
      if (tb < g.total) wb = w[pb];
    }
    chunk(ra, row_of_pos<PosT>(pa, L), wa, min(32, g.total - t0));
    if (t0 + 32 < g.total)
      chunk(rb, row_of_pos<PosT>(pb, L), wb, min(32, g.total - t0 - 32));
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (cur >= 0 && c + 32 * i < cols)
      __stcs(out + (v0 + cur) * cols + c + 32 * i, acc[i]);
}

template <typename PosT>
__global__ void __launch_bounds__(NT)
    rows_small_kernel(const PosT* __restrict__ perm,
                      const PosT* __restrict__ offs,
                      const float* __restrict__ w,
                      const float* __restrict__ dout, int L, int d,
                      long long V, int long_run, float* __restrict__ dtable) {
  __shared__ float prods[NW][32 * SMALL];      // a chunk's [term, column]
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long grp = static_cast<long long>(blockIdx.x) * NW + wid;
  if (grp >= (V + 31) / 32) return;                   // whole warp
  const long long v0 = grp * 32;
  const int nr = static_cast<int>(min(32LL, V - v0));
  const Group<PosT> g(offs, v0, nr, long_run, lane);
  float* b = prods[wid];
  // output e = lane + 32 i of the group's [nr, d] block (i < d): row
  // e / d, column e % d
  float acc[SMALL];
#pragma unroll
  for (int i = 0; i < SMALL; ++i) acc[i] = 0.0f;
  for (int t0 = 0; t0 < g.total; t0 += 32) {
    const int r = g.row_of(t0 + lane);
    float wt;
    const long long row = list_term(g, perm, w, L, t0 + lane, r, &wt);
    const int ne = min(32, g.total - t0) * d;         // the chunk's floats
    float gv[SMALL];
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {                 // f = k * d + column
      if (i >= d) break;
      const int f = lane + 32 * i, k = f / d;
      const long long rk = __shfl_sync(FULL, row, k & 31);
      gv[i] = f < ne ? __ldg(dout + rk * d + (f - k * d)) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
      if (i >= d) break;
      const int f = lane + 32 * i, k = f / d;
      const float wk = __shfl_sync(FULL, wt, k & 31);
      if (f < ne) b[f] = w != nullptr ? __fmul_rn(wk, gv[i]) : gv[i];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < SMALL; ++i) {
      if (i >= d) break;
      const int e = lane + 32 * i, re = e / d, ce = e - re * d;
      const int ex = __shfl_sync(FULL, g.excl, re & 31);
      const int cn = __shfl_sync(FULL, g.cnt, re & 31);
      const int kb = max(ex, t0) - t0, ke = min(ex + cn, t0 + 32) - t0;
      for (int k = kb; k < ke; ++k) acc[i] = __fadd_rn(acc[i], b[k * d + ce]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < SMALL; ++i) {                   // long rows: long_kernel's
    if (i >= d) break;
    const int e = lane + 32 * i, re = e / d;
    const bool lng = __shfl_sync(FULL, g.lng, re & 31);
    if (re < nr && !lng) __stcs(dtable + v0 * d + e, acc[i]);
  }
}

// Bytes of long_kernel's dynamic shared memory: the ring of LW slots of
// LE floats, each slot's LK term rows (PosT) and weights.
template <typename PosT>
constexpr int long_smem() {
  return LW * LE * 4 + LW * LK * static_cast<int>(sizeof(PosT)) + LW * LK * 4;
}

// Asynchronous copies of `vw` floats (4, 8 or 16 bytes) from global to
// shared memory, and the wait for all of a thread's copies.
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int vw) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vw == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sa),
                 "l"(src)
                 : "memory");
  else if (vw == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(sa),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sa),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Steps through a stage's elements e = lane + 32 u of `per` each a term:
// the term k = e / per and the element's place j = e % per in it.
struct Walk {
  int k, j;
  const int per, kq, jq;
  __device__ __forceinline__ Walk(int lane, int per_)
      : k(lane / per_), j(lane % per_), per(per_), kq(32 / per_),
        jq(32 % per_) {}
  __device__ __forceinline__ void next() {
    k += kq;
    j += jq;
    if (j >= per) {
      j -= per;
      ++k;
    }
  }
};

// Columns a long_kernel item takes: the row at d < 32, else LC.
__host__ __device__ inline int long_width(int d) { return d < 32 ? d : LC; }

// The adder's chain over a slot's kn terms of one column, stride dc (DC
// when it is a compile-time constant, 0 otherwise): blocks of AU terms in
// two register sets, each load of the next block placed between two
// dependent adds of this one (a block past kn reads at most AU terms on,
// into the term rows after the ring at the last slot, and is never
// added).
template <int DC>
__device__ __forceinline__ float add_terms(const float* s, int kn, int dc_,
                                           float acc) {
  const int dc = DC > 0 ? DC : dc_;
  float x[AU], y[AU];
#pragma unroll
  for (int u = 0; u < AU; ++u) x[u] = s[u * dc];
  int k = 0;
  for (; k + 2 * AU <= kn; k += 2 * AU) {
    const float* sk = s + k * dc;
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      y[u] = sk[(AU + u) * dc];
      acc = __fadd_rn(acc, x[u]);
    }
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      x[u] = sk[(2 * AU + u) * dc];
      acc = __fadd_rn(acc, y[u]);
    }
  }
  if (k + AU <= kn) {
#pragma unroll
    for (int u = 0; u < AU; ++u) acc = __fadd_rn(acc, x[u]);
    k += AU;
  }
  for (; k < kn; ++k) acc = __fadd_rn(acc, s[k * dc]);
  return acc;
}

template <typename PosT>
__global__ void __launch_bounds__(LT, 1)
    long_kernel(const PosT* __restrict__ perm,
                const PosT* __restrict__ offs,
                const unsigned* __restrict__ work,
                int* __restrict__ counters, const float* __restrict__ w,
                const float* __restrict__ dout, int L, int d,
                float* __restrict__ dtable) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  PosT* srow = reinterpret_cast<PosT*>(ring + LW * LE);
  float* sw = reinterpret_cast<float*>(srow + LW * LK);
  __shared__ long long item_s;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int width = long_width(d);
  const int slabs = (d + width - 1) / width;
  const long long n_items = static_cast<long long>(counters[0]) * slabs;
  const bool al16 = reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  const bool al8 = reinterpret_cast<uintptr_t>(dout) % 8 == 0;
  for (;;) {
    if (threadIdx.x == 0) item_s = atomicAdd(counters + 1, 1);
    __syncthreads();
    const long long item = item_s;
    if (item >= n_items) {                            // the whole CTA
      // the last CTA out resets the item counter, so an order can be
      // walked again
      if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(counters + 2, 1) == static_cast<int>(gridDim.x) - 1) {
          counters[1] = 0;
          counters[2] = 0;
        }
      }
      return;
    }
    const long long v = work[item / slabs];
    const int c0 = static_cast<int>(item % slabs) * width;
    const int dc = min(width, d - c0);                // this slab's columns
    const long long o = static_cast<long long>(offs[v]);
    const long long n = static_cast<long long>(offs[v + 1]) - o;
    const int st = min(LK, LE / dc);                  // terms a stage
    const int nst = static_cast<int>((n + st - 1) / st);
    // a slot is [term][column]; a term's dc floats move in copies of vw
    // floats, as dout's base, its rows and the slab allow
    const int vw = al16 && d % 4 == 0 && dc % 4 == 0   ? 4
                   : al8 && d % 2 == 0 && dc % 2 == 0 ? 2
                                                       : 1;
    if (wid == 0) {                                   // the adder
      float acc = 0.0f;
      for (int t = 0, q = 0; t < nst; ++t, q = q + 1 == LW ? 0 : q + 1) {
        bar_sync(1 + q, 64);
        const int kn = t + 1 < nst ? st : static_cast<int>(n - 1LL * t * st);
        if (lane < dc) {
          const float* sl = ring + q * LE + lane;
          switch (dc) {                   // a stride the loads can fold in
            case 1: acc = add_terms<1>(sl, kn, 1, acc); break;
            case 2: acc = add_terms<2>(sl, kn, 2, acc); break;
            case 3: acc = add_terms<3>(sl, kn, 3, acc); break;
            case 8: acc = add_terms<8>(sl, kn, 8, acc); break;
            case 10: acc = add_terms<10>(sl, kn, 10, acc); break;
            case 16: acc = add_terms<16>(sl, kn, 16, acc); break;
            case 18: acc = add_terms<18>(sl, kn, 18, acc); break;
            default: acc = add_terms<0>(sl, kn, dc, acc);
          }
        }
        if (t + LW < nst) bar_arrive(1 + LW + q, 64);
      }
      if (lane < dc) dtable[v * d + c0 + lane] = acc;
    } else {                                          // producer of slot q
      const int q = wid - 1;
      float* s = ring + q * LE;
      PosT* rows = srow + q * LK;
      float* ws = sw + q * LK;
      const int cpt = dc / vw;                        // copies a term
      PosT pn[LI];                                    // the stage's positions
      const auto positions = [&](int t) {
        const long long j0 = o + 1LL * t * st;
        const int kn = t + 1 < nst ? st : static_cast<int>(n - 1LL * t * st);
#pragma unroll
        for (int u = 0; u < LI; ++u) {
          const int k = lane + 32 * u;
          pn[u] = k < kn ? perm[j0 + k] : PosT(0);
        }
      };
      if (q < nst) positions(q);
      for (int t = q; t < nst; t += LW) {
        if (t >= LW) bar_sync(1 + LW + q, 64);        // the adder is done
        const int kn = t + 1 < nst ? st : static_cast<int>(n - 1LL * t * st);
        float wv[LI];
#pragma unroll
        for (int u = 0; u < LI; ++u) {
          const int k = lane + 32 * u;
          const long long p = static_cast<long long>(pn[u]);
          if (k < kn) rows[k] = static_cast<PosT>(row_of_pos<PosT>(p, L));
          wv[u] = w != nullptr && k < kn ? w[p] : 1.0f;
        }
        __syncwarp();
        // the gathers, straight into the slot; then the next stage's
        // positions, in flight with them
        const int nc = kn * cpt;
        Walk g(lane, cpt);
#pragma unroll 4
        for (int e = lane; e < nc; e += 32, g.next())
          cp_async(s + g.k * dc + g.j * vw,
                   dout + static_cast<long long>(rows[g.k]) * d + c0 +
                       g.j * vw,
                   vw);
        if (t + LW < nst) positions(t + LW);
        if (w != nullptr) {
#pragma unroll
          for (int u = 0; u < LI; ++u)
            if (lane + 32 * u < kn) ws[lane + 32 * u] = wv[u];
        }
        cp_async_wait_all();
        __syncwarp();
        if (w != nullptr) {                           // the products, in place
          const int ne = kn * dc;
          if (dc % 4 == 0) {
            float4* s4 = reinterpret_cast<float4*>(s);
            Walk h(lane, dc / 4);
#pragma unroll 4
            for (int e = lane; e < ne / 4; e += 32, h.next()) {
              const float wk = ws[h.k];
              float4 x = s4[e];
              x.x = __fmul_rn(wk, x.x);
              x.y = __fmul_rn(wk, x.y);
              x.z = __fmul_rn(wk, x.z);
              x.w = __fmul_rn(wk, x.w);
              s4[e] = x;
            }
          } else {
            Walk h(lane, dc);
#pragma unroll 4
            for (int e = lane; e < ne; e += 32, h.next())
              s[e] = __fmul_rn(ws[h.k], s[e]);
          }
        }
        __syncwarp();
        bar_arrive(1 + q, 64);                        // the slot is full
      }
    }
    __syncthreads();                                  // the item is done
  }
}

template <typename IdT, typename PosT>
int sort_ids(const void* ids, int wrap, long long P, long long V,
             int long_run, unsigned* keys, PosT* pos, PosT* perm,
             void* temp, size_t temp_bytes, PosT* offs, unsigned* work,
             int* counters, int* bad, cudaStream_t st) {
  keys_kernel<IdT, PosT><<<static_cast<unsigned>((P + BT - 1) / BT), BT, 0,
                           st>>>(static_cast<const IdT*>(ids), P, V, wrap,
                                 keys, pos, counters);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys, keys + P, pos,
                                       perm, static_cast<PosT>(P),
                                       0, key_bits(V), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  offsets_kernel<PosT><<<static_cast<unsigned>((P + BT) / BT), BT, 0, st>>>(
      keys + P, P, V, long_run, offs, work, counters, bad);
  return static_cast<int>(cudaGetLastError());
}

// A second stream a device for long_kernel, and the events that fork it
// from the caller's stream and join it back; side_mu is held from the
// fork to the join's record, so two host threads never interleave them.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
std::mutex side_mu;

int side_of(Side** out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < 0 || dev >= 64) return -1;
  Side& s = sides[dev];
  if (s.stream == nullptr) {
    rc = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking);
    if (rc == cudaSuccess)
      rc = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming);
    if (rc == cudaSuccess)
      rc = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  *out = &s;
  return 0;
}

// The short-run kernel on `st` and, beside it on a side stream forked
// from `st` and joined back (the two write disjoint rows), long_kernel:
// everything after on `st` waits for both.
template <typename PosT>
int launch_bwd(const PosT* perm, const PosT* offs, const unsigned* work,
               int* counters, int long_run, const float* w, const float* dout,
               int L, int d, long long V, float* dtable, int long_blocks,
               int rows_only, cudaStream_t st) {
  cudaError_t rc;
  Side* side = nullptr;
  std::unique_lock<std::mutex> lock(side_mu, std::defer_lock);
  if (!rows_only && long_blocks > 0) {
    lock.lock();
    const int r = side_of(&side);
    if (r) return r;
    static bool smem_set = false;                     // once a PosT
    if (!smem_set) {
      rc = cudaFuncSetAttribute(long_kernel<PosT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                long_smem<PosT>());
      if (rc != cudaSuccess) return static_cast<int>(rc);
      smem_set = true;
    }
    rc = cudaEventRecord(side->fork, st);
    if (rc == cudaSuccess) rc = cudaStreamWaitEvent(side->stream, side->fork);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    long_kernel<PosT><<<long_blocks, LT, long_smem<PosT>(), side->stream>>>(
        perm, offs, work, counters, w, dout, L, d, dtable);
    rc = cudaGetLastError();
    if (rc == cudaSuccess) rc = cudaEventRecord(side->join, side->stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const long long groups = (V + 31) / 32;
  if (d < SMALL) {
    rows_small_kernel<PosT><<<blocks(groups), NT, 0, st>>>(
        perm, offs, w, dout, L, d, V, long_run, dtable);
  } else {
    // lanes across columns: VEC floats a vector, NV vectors a lane
    const bool v4 = vec4(dout, dtable, d);
    const int cols = v4 ? d / 4 : d;
    const long long slabs = (cols + 63) / 64;
    const unsigned nb = blocks(groups * (cols > 32 ? slabs : (cols + 31) / 32));
    if (v4 && cols > 32)
      rows_slab_kernel<PosT, 4, 2><<<nb, NT, 0, st>>>(
          perm, offs, w, dout, L, d, V, long_run, dtable);
    else if (v4)
      rows_slab_kernel<PosT, 4, 1><<<nb, NT, 0, st>>>(
          perm, offs, w, dout, L, d, V, long_run, dtable);
    else if (cols > 32)
      rows_slab_kernel<PosT, 1, 2><<<nb, NT, 0, st>>>(
          perm, offs, w, dout, L, d, V, long_run, dtable);
    else
      rows_slab_kernel<PosT, 1, 1><<<nb, NT, 0, st>>>(
          perm, offs, w, dout, L, d, V, long_run, dtable);
  }
  rc = cudaGetLastError();
  if (rc == cudaSuccess && side != nullptr)
    rc = cudaStreamWaitEvent(st, side->join);
  return static_cast<int>(rc);
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

// Bytes of CUB's temporary storage for sorting P (key, position) pairs of
// a V-row table (positions of `pos_bytes`), or minus a CUDA error code.
long long embedding_bag_sort_temp_bytes(long long P, long long V,
                                        int pos_bytes) {
  size_t bytes = 0;
  const int bits = embedding_bag::key_bits(V);
  cudaError_t rc;
  if (pos_bytes == 4)
    rc = cub::DeviceRadixSort::SortPairs(
        nullptr, bytes, static_cast<const unsigned*>(nullptr),
        static_cast<unsigned*>(nullptr), static_cast<const int*>(nullptr),
        static_cast<int*>(nullptr), static_cast<int>(P), 0, bits);
  else
    rc = cub::DeviceRadixSort::SortPairs(
        nullptr, bytes, static_cast<const unsigned*>(nullptr),
        static_cast<unsigned*>(nullptr),
        static_cast<const long long*>(nullptr),
        static_cast<long long*>(nullptr), P, 0, bits);
  return rc == cudaSuccess ? static_cast<long long>(bytes)
                           : -static_cast<long long>(rc);
}

// The backward's index preparation on `stream`, from the flat ids (P of
// `id_bytes`; `wrap`: a negative id counts from the end): keys [2 P]
// uint32 (the keys, then the sorted keys), pos [P] and perm [P] (the
// flat positions, then in sorted order; `pos_bytes` each, 8 only when
// P >= 2^31), CUB's temp, offs [V + 1] (`pos_bytes` each), work [at
// least min(V, P / (long_run + 1))] uint32 (the rows whose run is longer
// than long_run), counters [3] int32 (work's length; long_kernel's next
// item and its CTAs done) and bad [1] int32 (1 if an id lies outside [0, V)).  Returns 0,
// a CUDA error code (> 0), or -1 for arguments it does not take.
int embedding_bag_sort_launch(const void* ids, int id_bytes, int wrap,
                              long long P, long long V, int long_run,
                              int pos_bytes, void* keys, void* pos,
                              void* perm, void* temp, long long temp_bytes,
                              void* offs, void* work, void* counters,
                              void* bad, void* stream) {
  if (P < 1 || V < 1 || V >= (1LL << 31) || long_run < 1 ||
      (id_bytes != 4 && id_bytes != 8) || (pos_bytes != 4 && pos_bytes != 8) ||
      (pos_bytes == 4 && P >= (1LL << 31)))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto k = static_cast<unsigned*>(keys);
  auto wk = static_cast<unsigned*>(work);
  auto cn = static_cast<int*>(counters);
  auto b = static_cast<int*>(bad);
  const auto tb = static_cast<size_t>(temp_bytes);
  using embedding_bag::sort_ids;
  if (pos_bytes == 4) {
    auto ps = static_cast<int*>(pos);
    auto pm = static_cast<int*>(perm);
    auto of = static_cast<int*>(offs);
    return id_bytes == 4
               ? sort_ids<int32_t, int>(ids, wrap, P, V, long_run, k, ps, pm,
                                        temp, tb, of, wk, cn, b, st)
               : sort_ids<int64_t, int>(ids, wrap, P, V, long_run, k, ps, pm,
                                        temp, tb, of, wk, cn, b, st);
  }
  auto ps = static_cast<long long*>(pos);
  auto pm = static_cast<long long*>(perm);
  auto of = static_cast<long long*>(offs);
  return id_bytes == 4
             ? sort_ids<int32_t, long long>(ids, wrap, P, V, long_run, k, ps,
                                            pm, temp, tb, of, wk, cn, b, st)
             : sort_ids<int64_t, long long>(ids, wrap, P, V, long_run, k, ps,
                                            pm, temp, tb, of, wk, cn, b, st);
}

// The backward on `stream` from embedding_bag_sort_launch's perm, offs,
// work and counters: dtable [V, d] f32, every row written once (rows no
// id names +0.0; nothing is zero-filled first), from the weights by flat
// position (or null: unit weights) and dout [n_bags, d], each bag L
// positions; the n_long long runs (read from counters on the host) go
// to long_kernel, a CTA an item up to max_long_blocks, on a second
// stream forked from `stream` and joined back.  `rows_only` launches the
// short-run kernel alone (the long rows stay unwritten: for timing the
// two kernels apart).  Returns 0, a CUDA error code (> 0), or -1 for
// arguments it does not take.
int embedding_bag_backward_launch(const void* perm, const void* offs,
                                  int pos_bytes, const void* work,
                                  void* counters, int long_run,
                                  const void* weights, const void* dout,
                                  int L, int d, long long V, void* dtable,
                                  int n_long, int max_long_blocks,
                                  int rows_only, void* stream) {
  if (V < 1 || V >= (1LL << 31) || d < 1 || L < 1 || long_run < 1 ||
      n_long < 0 || max_long_blocks < 1 || (pos_bytes != 4 && pos_bytes != 8))
    return -1;
  // long_kernel's items: a long run's column slabs
  const int width = embedding_bag::long_width(d);
  const long long items =
      static_cast<long long>(n_long) * ((d + width - 1) / width);
  const int long_blocks =
      static_cast<int>(std::min<long long>(items, max_long_blocks));
  auto st = static_cast<cudaStream_t>(stream);
  auto wk = static_cast<const unsigned*>(work);
  auto cn = static_cast<int*>(counters);
  auto w = static_cast<const float*>(weights);
  auto g = static_cast<const float*>(dout);
  auto o = static_cast<float*>(dtable);
  if (pos_bytes == 4)
    return embedding_bag::launch_bwd<int>(
        static_cast<const int*>(perm), static_cast<const int*>(offs), wk, cn,
        long_run, w, g, L, d, V, o, long_blocks, rows_only, st);
  return embedding_bag::launch_bwd<long long>(
      static_cast<const long long*>(perm),
      static_cast<const long long*>(offs), wk, cn, long_run, w, g, L, d, V, o,
      long_blocks, rows_only, st);
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
