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
// in TF32 it would round P): a block holds the LUT of G queries in
// shared memory and gather-sums, for each item, all G scores in split
// order j = 0..m-1, which is bit-equal to the reference gather-sum.
// Gathers by item (a lane an item, a random code each) hit random banks:
// 32 random codes over 256 collide about 3.15-way.  So the lanes are
// queries and the item is shared:
//   - the LUT is laid out [m][b][G], so one (j, c) row of the G queries
//     is G / 4 float4s; a warp is 4 item groups of 8 lanes, and lane ch
//     of a group loads the float4 of queries 4ch..4ch+3 at the group's
//     code: a quarter warp reads one row of consecutive 16-byte words, no
//     bank conflict, and one load serves 4 queries;
//   - each lane sums FIT = 8 consecutive items (for uint8 codes at m = 8,
//     each item's codes are one 8-byte broadcast load);
//   - the scores go out through shared memory: each lane stages its 8
//     items of 4 rows, and the warp writes them back row-wise, since a
//     32-byte sector written in pieces costs as much as a whole one.  N
//     is arbitrary, so a row's 32 items start anywhere in a sector: each
//     warp owns a contiguous item range and writes row t shifted by d_t,
//     its offset from a 32-byte boundary, carrying the last 8 items of
//     each step to the next, so that 8 lanes store a row's 128 bytes as
//     aligned 16-byte pieces, on whole sectors;
//   - the stores are streaming (st.global.cs): S is 12.8 GB, far above
//     the 50 MB L2, and is read next by the loss;
//   - the LUT and the 8 warps' staging fill the shared memory, so G = 24
//     at m b = 2,048 (as many as fit, a multiple of 4, at most 28:
//     jpq_scores_fwd_group); a block (256 threads, one an SM) owns one
//     query group and one item range and loads its LUT once for it; the
//     host's planner (cuda.fwd_plan) picks the ranges, whole warp steps
//     of FSTEP items, so that the blocks fill their last wave on the
//     card's SMs (134 groups x 16 ranges at T = 3,200).
// Ragged T and N are masked; the caller's arrays are not padded.
//
// Backward design.  Deterministic: no float atomics, so two calls on the
// same inputs give bit-identical dP.  The grouping of items by code
// depends on the codes alone, so it is built once a call and not once a
// row (grouping every 32 items again for each of the T rows, with
// __match_any_sync and a serial leader loop, is issue-bound: 220 ms on
// an H100 at T = 3,200).
//   1. Sort (bwd_sort_kernel, grid (tile, split)): for each tile of TILE
//      = 512 items and each split j, a stable counting sort of the
//      tile's codes gives the item offsets in code order (ascending item
//      order within a code; __match_any_sync ranks, a scan of the
//      (code, warp) counts) and each bin's start.  Lists are laid out
//      [tile, j, TILE] and bin starts flat, j * TILE + start, so bin
//      k = j * b + c owns positions [fstart[k], fstart[k + 1]) of its
//      tile.  Items past N (last tile) take the virtual code b: they land
//      at the end of each split's list, inside the range of code b - 1,
//      with the offset TILE, a column of +0.0 in the staged tile (an
//      exact add, so it changes no bits).  Reads the 8 MB of codes once;
//      the lists are 2 bytes an item and split.
//   2. Sum (bwd_sum_kernel, grid (1,024 bins, 32 rows, item chunk)):
//      lanes are rows, so a warp reads 32 rows of one item with one
//      broadcast offset and 32 distinct banks (the staged rows have an
//      odd stride, TILE + 1 floats).  Each of the 32 warps owns 32 bins
//      and keeps their 32 rows' sums in registers (acc[32], fully
//      unrolled) across the chunk; it walks each bin's list in the tile
//      with plain fp32 adds.  The loop is issue-bound, so it walks 32-bit
//      shared addresses (7 instructions an item); 1,024 threads a block
//      (64 registers each) keep 32 warps on an SM to hide the two
//      dependent shared loads of an item.  The dS tile [32, 512] (4-byte
//      cp.async into the padded rows), the lists of the splits the
//      block's bins touch and the bin starts are staged double-buffered,
//      so the next tile is in flight during the adds.  32 rows x 2,048
//      bins would fill the whole register file, so a row group's bins
//      are split over ceil(m b / 1,024) blocks (2 at m b = 2,048) with
//      neighbouring block indices: they read the same dS tiles at about
//      the same time and the second read mostly hits L2.  Work is
//      balanced by bins, not by items: a code that holds most of a split
//      slows the warp that owns it (the block waits for it at each
//      tile), but no warp serialises on a conflict.
//   3. With one item chunk each output is one chain of fp32 adds over
//      its items in ascending item order from +0.0: the index_add_ of the
//      plain version on the CPU, bit for bit, and no partials.  One chunk
//      at T = 3,200 is 200 blocks of one an SM, a wave and a half on 132
//      SMs, so the wrapper by default splits the items into the chunks
//      that fill the last wave best (7 there); each chunk writes
//      partial[t, chunk, m, b] and bwd_reduce_kernel sums them in chunk
//      order.
// Chain: an output (t, j, c) takes n_q items of chunk q in one chain
// from +0.0 (n_q - 1 rounded adds), then chunks - 1 adds of the
// partials, so the longest chain of rounded adds any of its terms goes
// through is max_q n_q - 1 + chunks - 1, and |dP - exact| <=
// gamma(chain - 1) sum |dS terms| with chain = max_q n_q + chunks - 1
// (cuda.bwd_chain computes it from the codes).
// What bounds the backward: reading dS once, 12.8 GB at T = 3,200 and
// N = 1,000,002 (3.8 ms at 3.35 TB/s); then one shared-memory load and
// one add per (row, item, split), 25.6e9 of each; in practice the
// instructions that issue them (7 per warp and item: 5.6e9 at T = 3,200,
// about 6 ms on 132 SMs of 4 schedulers).
#include <cstdint>
#include <cuda_runtime.h>

#include "smem.cuh"

namespace jpq_scores {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;          // reduce: threads per block
constexpr size_t SMEM_MAX = 232448;  // shared memory a block may use (227 KB)

// forward
constexpr int FNT = 256;         // threads per block
constexpr int FWARPS = FNT / 32;
constexpr int FGMAX = 28;        // most queries per block: 7 float4s a row
constexpr int FIT = 8;           // consecutive items per lane
constexpr int FSTEP = 4 * FIT;   // items per warp step: 4 groups of 8 lanes
constexpr int FC = 8;            // carried items of a row: a 32-byte sector
constexpr int FSRS = FC + FSTEP + 4;  // staged row stride: 11 16-byte units

// Shared memory of a forward block: the LUT [m b][G], then each warp's
// staged rows [G][FSRS].
__host__ __device__ inline size_t fwd_smem(int G, int m, int b) {
  return static_cast<size_t>(G) * (static_cast<size_t>(m) * b + FWARPS * FSRS) *
         sizeof(float);
}

// Queries a forward block: the most, a multiple of 4 and at most FGMAX,
// whose LUT and staging fit a block's shared memory; 0 if 4 do not fit.
inline int fwd_group(int m, int b) {
  for (int G = FGMAX; G >= 4; G -= 4)
    if (fwd_smem(G, m, b) <= SMEM_MAX) return G;
  return 0;
}

// backward
constexpr int TILE = 512;        // items a tile (sort and sum)
constexpr int SW = TILE / 32;    // sort: warps a block (one thread an item)
constexpr int RB = 32;           // sum: rows a block, one a lane
constexpr int BW = 32;           // sum: warps a block
constexpr int BT = BW * 32;      // sum: threads a block
constexpr int KB = 32;           // sum: bins a warp, in registers
constexpr int BINS = BW * KB;    // sum: bins a block
constexpr int TS = TILE + 1;     // sum: staged row stride; column TILE is +0.0
constexpr int FSB = BINS + 8;    // sum: bin starts staged a tile
static_assert(BT % TILE == 0, "a copy pass covers whole rows");

// Row stride of the bin starts, in uint16: m b rounded up to whole sum
// blocks of BINS, plus 8, so every sum block stages FSB entries of its
// own row, 16-byte aligned for cp.async.  Entries from m b on hold the
// sentinel m * TILE: bins past m b have empty lists.
__host__ __device__ inline int fs_stride(int mb) {
  return (mb + BINS - 1) / BINS * BINS + 8;
}

// Splits that the bins of one sum block can touch, and so the list
// entries it stages a tile.
inline int pos_max(int m, int b) {
  const int touched = (BINS - 1) / b + 2;
  return (m < touched ? m : touched) * TILE;
}

// ------------------------------------------------------------- forward

using smem::lds4;

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x = a.x + v.x;
  a.y = a.y + v.y;
  a.z = a.z + v.z;
  a.w = a.w + v.w;
}

__device__ __forceinline__ float part(const float4& a, int r) {
  return r == 0 ? a.x : r == 1 ? a.y : r == 2 ? a.z : a.w;
}

__device__ __forceinline__ void sts4(unsigned a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// grid (item range, query group).  MC = 8: uint8 codes, 8 a row, 8-byte
// aligned (one load an item); MC = 0: any m and code type.
template <typename CodeT, int MC>
__global__ void __launch_bounds__(FNT, 1)
    fwd_kernel(const float* __restrict__ P, const CodeT* __restrict__ codes,
               int T, int m, int b, int N, int G, int range,
               float* __restrict__ S) {
  extern __shared__ float4 lut4[];  // [m b][G / 4], then the staging
  float* lut = reinterpret_cast<float*>(lut4);
  const int t0 = blockIdx.y * G;
  const int nq = min(G, T - t0);
  const int mb = m * b;
  for (int q = 0; q < G; ++q) {
    const float* src = P + static_cast<size_t>(t0 + q) * mb;
#pragma unroll 8
    for (int jc = threadIdx.x; jc < mb; jc += FNT)
      lut[jc * G + q] = q < nq ? src[jc] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 3;
  const int ch = lane & 7;
  const int nch = (nq + 3) / 4;     // chunks of 4 queries with a row
  const bool active = ch < nch;     // lanes past them idle
  const unsigned row = static_cast<unsigned>(G) * 4u;  // bytes a (j, c) row
  // idle lanes read chunk 0 (inside the LUT) and store nothing
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(lut)) +
                        (active ? ch : 0) * 16u;
  const unsigned split = static_cast<unsigned>(b) * row;  // bytes a split
  // this warp's staged rows [G][FSRS]: columns FC.. hold the current
  // step's 32 items, columns 0..FC the last FC items of the step before
  const float* stage = lut + static_cast<size_t>(G) * mb +
                       static_cast<size_t>(warp) * G * FSRS;
  const unsigned stage_a =
      static_cast<unsigned>(__cvta_generic_to_shared(stage));
  float* const S0 = S + static_cast<size_t>(t0) * N;
  // the warp's own contiguous items [w0, w1) of the block's range
  const int r0 = blockIdx.x * range;
  const int per_warp = (range + FWARPS * FSTEP - 1) / (FWARPS * FSTEP) * FSTEP;
  const int w0 = r0 + warp * per_warp;
  const int w1 = min(min(N, r0 + range), w0 + per_warp);
  // Row t's stored items are shifted d_t items left of the computed ones,
  // d_t the row's offset in floats from a 32-byte boundary, so that each
  // lane stores 16 aligned bytes and 8 lanes a row's 128 bytes on whole
  // sectors: the warp writes items [w0 - d_t, w1 - d_t) of row t (to N
  // at the end of the catalogue), the first d_t of each window from the
  // carry.  To have that carry at w0, the warp first scores the step
  // before w0 without storing it.
  const unsigned d0 = static_cast<unsigned>(reinterpret_cast<uintptr_t>(S0) >> 2);
  const int rq = lane >> 3, l4 = 4 * (lane & 7);  // a row of 4, 4 items
  auto store_rows = [&](int step) {
    for (int t = rq; t < nq; t += 4) {
      const int dt = static_cast<int>((d0 + static_cast<unsigned>(t) *
                                       static_cast<unsigned>(N)) & 7u);
      const int item = step - dt + l4;
      const float* src = stage + t * FSRS + FC - dt + l4;
      const float4 v = make_float4(src[0], src[1], src[2], src[3]);
      float* out = S0 + static_cast<size_t>(t) * N + item;
      if (item >= 0 && item + 4 <= N) {
        __stcs(reinterpret_cast<float4*>(out), v);
      } else {
        if (item >= 0 && item < N) __stcs(out, v.x);
        if (item + 1 >= 0 && item + 1 < N) __stcs(out + 1, v.y);
        if (item + 2 >= 0 && item + 2 < N) __stcs(out + 2, v.z);
        if (item + 3 >= 0 && item + 3 < N) __stcs(out + 3, v.w);
      }
    }
  };
  for (int step = w0 >= FSTEP && w0 < w1 ? w0 - FSTEP : w0; step < w1;
       step += FSTEP) {
    const int i0 = step + grp * FIT;
    float4 acc[FIT];
    if constexpr (MC == 8) {
      uint2 w[FIT];
#pragma unroll
      for (int s = 0; s < FIT; ++s)
        w[s] = i0 + s < N
                   ? __ldg(reinterpret_cast<const uint2*>(codes) + i0 + s)
                   : make_uint2(0u, 0u);
#pragma unroll
      for (int s = 0; s < FIT; ++s)
        acc[s] = lds4(base + (w[s].x & 0xFFu) * row);
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        const unsigned bj = base + j * split;
#pragma unroll
        for (int s = 0; s < FIT; ++s) {
          const unsigned c =
              __byte_perm(j < 4 ? w[s].x : w[s].y, 0u, 0x4440u | (j & 3));
          add4(acc[s], lds4(bj + c * row));
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < FIT; ++s) {
        const unsigned c =
            i0 + s < N ? static_cast<unsigned>(codes[static_cast<size_t>(i0 + s) * m])
                       : 0u;
        acc[s] = lds4(base + c * row);
      }
      for (int j = 1; j < m; ++j) {
        const unsigned bj = base + j * split;
#pragma unroll
        for (int s = 0; s < FIT; ++s) {
          const unsigned c =
              i0 + s < N
                  ? static_cast<unsigned>(codes[static_cast<size_t>(i0 + s) * m + j])
                  : 0u;
          add4(acc[s], lds4(bj + c * row));
        }
      }
    }
    // lane ch stages its rows in the order rho = (r + ch / 2) % 4, so the
    // 8 lanes of a quarter warp hit 8 distinct 16-byte bank groups (rows
    // 11 units apart: rows 4ch + rho fall on 3 (4ch + rho) mod 8)
    __syncwarp();
    if (active) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rho = (r + (ch >> 1)) & 3;
        const unsigned a = stage_a + ((4 * ch + rho) * FSRS + FC + grp * FIT) *
                                         static_cast<unsigned>(sizeof(float));
        sts4(a, make_float4(part(acc[0], rho), part(acc[1], rho),
                            part(acc[2], rho), part(acc[3], rho)));
        sts4(a + 16, make_float4(part(acc[4], rho), part(acc[5], rho),
                                 part(acc[6], rho), part(acc[7], rho)));
      }
    }
    __syncwarp();
    if (step >= w0) store_rows(step);
    __syncwarp();
    // the step's last FC items become the carry of the next
    for (int x = lane; x < 2 * nq; x += 32) {
      const unsigned a = stage_a + ((x >> 1) * FSRS + (x & 1) * 4) *
                                       static_cast<unsigned>(sizeof(float));
      sts4(a, lds4(a + FSTEP * sizeof(float)));
    }
  }
  // at the end of the catalogue, the last step's items past its window
  if (w1 == N && w0 < w1) {
    __syncwarp();
    store_rows(w0 + (w1 - w0 - 1) / FSTEP * FSTEP + FSTEP);
  }
}


// ------------------------------------------------------------ backward

// One asynchronous copy global -> shared of 4 or 16 bytes (cp.async).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// A value the compiler must take as it is (so that row + 4 * offset stays
// one LEA and is not re-associated into two multiply-adds).
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

// Loads from shared memory at a 32-bit shared address.
__device__ __forceinline__ unsigned lds_u16(unsigned a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float lds_f32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// 1. Per (tile, split j): the tile's item offsets in code order and the
// bin starts.  One thread an item.
template <typename CodeT>
__global__ void __launch_bounds__(TILE)
    bwd_sort_kernel(const CodeT* __restrict__ codes, int m, int b, int N,
                    uint16_t* __restrict__ offs,
                    uint16_t* __restrict__ fstart) {
  extern __shared__ int cnt[];     // [(b + 1) codes, SW warps]
  __shared__ int wtot[SW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, j = blockIdx.y;
  const long long i = static_cast<long long>(tile) * TILE + tid;
  const int ncnt = (b + 1) * SW;
  for (int x = tid; x < ncnt; x += TILE) cnt[x] = 0;
  // past N: the virtual code b, after every real code
  const int c = i < N ? static_cast<int>(codes[i * m + j]) : b;
  __syncthreads();
  const unsigned same = __match_any_sync(FULL, c);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (rank == 0) cnt[c * SW + warp] = __popc(same);
  __syncthreads();
  {  // exclusive scan of the counts in (code, warp) order
    const int per = (ncnt + TILE - 1) / TILE;
    const int lo = min(ncnt, tid * per), hi = min(ncnt, lo + per);
    int sum = 0;
    for (int x = lo; x < hi; ++x) sum += cnt[x];
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) wtot[warp] = inc;
    __syncthreads();
    int ex = inc - sum;
    for (int w = 0; w < warp; ++w) ex += wtot[w];
    for (int x = lo; x < hi; ++x) {
      const int n = cnt[x];
      cnt[x] = ex;
      ex += n;
    }
  }
  __syncthreads();
  offs[(static_cast<size_t>(tile) * m + j) * TILE + cnt[c * SW + warp] +
       rank] = static_cast<uint16_t>(i < N ? tid : TILE);
  uint16_t* f = fstart + static_cast<size_t>(tile) * fs_stride(m * b) + j * b;
  for (int x = tid; x < b; x += TILE)
    f[x] = static_cast<uint16_t>(j * TILE + cnt[x * SW]);
  if (j == m - 1)
    for (int x = b + tid; x < fs_stride(m * b) - j * b; x += TILE)
      f[x] = static_cast<uint16_t>(m * TILE);
}

// 2. Per (1,024 bins, 32 rows, item chunk): each bin's sums over the
// chunk's items, in registers, in ascending item order from +0.0.
__global__ void __launch_bounds__(BT, 1)
    bwd_sum_kernel(const float* __restrict__ dS,
                   const uint16_t* __restrict__ offs,
                   const uint16_t* __restrict__ fstart, int T, int N, int m,
                   int b, int n_tiles, int tiles_per_chunk, int chunks,
                   int pmax, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);             // [2][RB TS]
  uint16_t* lists = reinterpret_cast<uint16_t*>(tiles + 2 * RB * TS);
  uint16_t* starts = lists + 2 * pmax;                           // [2][FSB]
  const auto tiles_s = static_cast<unsigned>(__cvta_generic_to_shared(tiles));
  const auto lists_s = static_cast<unsigned>(__cvta_generic_to_shared(lists));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mb = m * b, fsr = fs_stride(mb);
  const int k0 = blockIdx.x * BINS, kend = min(mb, k0 + BINS);
  const int t0 = blockIdx.y * RB, chunk = blockIdx.z;
  const int tb = chunk * tiles_per_chunk;
  const int te = min(n_tiles, tb + tiles_per_chunk);
  const int j0 = k0 / b, nsp = (kend - 1) / b - j0 + 1;  // splits touched
  const int pbase = j0 * TILE;           // first list position staged
  if (tid < 2 * RB) tiles[(tid >> 5) * RB * TS + (tid & 31) * TS + TILE] = 0.f;

  const int ci = tid % TILE, cr = tid / TILE;  // a thread's column, row
  const int nr = min(RB, T - t0);
  auto issue = [&](int tl, int buf) {  // tile tl's copies, in flight
    const long long i0 = static_cast<long long>(tl) * TILE;
    if (i0 + ci < N) {                 // rows cr, cr + BT / TILE, ...
      const float* src = dS + static_cast<size_t>(t0 + cr) * N + i0 + ci;
      float* dst = tiles + buf * RB * TS + cr * TS + ci;
      for (int r = cr; r < nr; r += BT / TILE) {
        copy4(dst, src);
        src += static_cast<size_t>(BT / TILE) * N;
        dst += (BT / TILE) * TS;
      }
    }
    const uint16_t* ls = offs + (static_cast<size_t>(tl) * m + j0) * TILE;
    uint16_t* ld = lists + buf * pmax;
    for (int e = tid; e < nsp * TILE / 8; e += BT)
      copy16(ld + 8 * e, ls + 8 * e);
    const uint16_t* fs = fstart + static_cast<size_t>(tl) * fsr + k0;
    uint16_t* fd = starts + buf * FSB;
    for (int e = tid; e < FSB / 8; e += BT) copy16(fd + 8 * e, fs + 8 * e);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[KB];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) acc[kk] = 0.f;
  if (tb < te) issue(tb, 0);
  for (int tl = tb; tl < te; ++tl) {
    const int buf = (tl - tb) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // own copies
    __syncthreads();                   // everyone's; tile tl - 1 summed
    if (tl + 1 < te) issue(tl + 1, buf ^ 1);
    // each bin's items in list order, one add each.  The issue rate is
    // the limit, so the loop walks 32-bit shared addresses: 7
    // instructions an item (load the offset, scale it onto the row, load,
    // add, step, compare, branch).
    const unsigned row = opaque(tiles_s + 4u * (buf * RB * TS + lane * TS));
    const unsigned pos = lists_s + 2u * (buf * pmax - pbase);
    const uint16_t* fs = starts + buf * FSB + warp * KB;
    unsigned pa = pos + 2u * fs[0];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {   // bins past m b: empty lists
      const unsigned pe = pos + 2u * fs[kk + 1];
      float a = acc[kk];
#pragma unroll 1
      for (; pa < pe; pa += 2) a = a + lds_f32(row + (lds_u16(pa) << 2));
      acc[kk] = a;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // out through shared memory: [RB][BINS + 1], then coalesced rows
  float* sm = tiles;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
    sm[lane * (BINS + 1) + warp * KB + kk] = acc[kk];
  __syncthreads();
  const int nb = kend - k0;
  const size_t rstride = static_cast<size_t>(chunks) * mb;
  for (int e = tid; e < RB * nb; e += BT) {
    const int r = e / nb, k = e - r * nb;
    if (t0 + r < T)
      out[(t0 + r) * rstride + static_cast<size_t>(chunk) * mb + k0 + k] =
          sm[r * (BINS + 1) + k];
  }
}

// 3. (chunks > 1 only) dP[t, k] = the chunk partials summed in order.
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

template <typename CodeT, int MC>
int fwd_t(const float* P, const void* codes, int T, int m, int b, int N,
          int G, const dim3 grid, int range, float* S, cudaStream_t stream) {
  const size_t smem = fwd_smem(G, m, b);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<CodeT, MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<CodeT, MC><<<grid, FNT, smem, stream>>>(
      P, static_cast<const CodeT*>(codes), T, m, b, N, G, range, S);
  return static_cast<int>(cudaGetLastError());
}

// The forward on a grid of (item ranges, query groups), written to grid.
int fwd(const float* P, const void* codes, int code_bytes, int T, int m,
        int b, int N, int G, int range, float* S, int* grid_out,
        cudaStream_t stream) {
  const dim3 grid((N + range - 1) / range, (T + G - 1) / G);
  grid_out[0] = static_cast<int>(grid.x);
  grid_out[1] = static_cast<int>(grid.y);
  if (code_bytes == 4)
    return fwd_t<int32_t, 0>(P, codes, T, m, b, N, G, grid, range, S, stream);
  if (m == 8 && reinterpret_cast<uintptr_t>(codes) % 8 == 0)
    return fwd_t<uint8_t, 8>(P, codes, T, m, b, N, G, grid, range, S, stream);
  return fwd_t<uint8_t, 0>(P, codes, T, m, b, N, G, grid, range, S, stream);
}

size_t sort_smem(int b) {
  return static_cast<size_t>(b + 1) * SW * sizeof(int);
}

size_t sum_smem(int m, int b) {
  return (2 * static_cast<size_t>(RB) * TS) * sizeof(float) +
         (2 * static_cast<size_t>(pos_max(m, b)) + 2 * FSB) * sizeof(uint16_t);
}

template <typename CodeT>
int sort(const void* codes, int m, int b, int N, uint16_t* offs,
         uint16_t* fstart, cudaStream_t stream) {
  const size_t smem = sort_smem(b);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_sort_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TILE - 1) / TILE, m);
  bwd_sort_kernel<CodeT><<<grid, TILE, smem, stream>>>(
      static_cast<const CodeT*>(codes), m, b, N, offs, fstart);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT>
int bwd(const float* dS, const void* codes, int T, int m, int b, int N,
        int tiles_per_chunk, int chunks, uint16_t* sorted, float* partial,
        float* dP, cudaStream_t stream) {
  const int n_tiles = (N + TILE - 1) / TILE;
  uint16_t* offs = sorted;
  uint16_t* fstart = sorted + static_cast<size_t>(n_tiles) * m * TILE;
  int rc = sort<CodeT>(codes, m, b, N, offs, fstart, stream);
  if (rc) return rc;
  const size_t smem = sum_smem(m, b);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mb = m * b;
  const dim3 grid((mb + BINS - 1) / BINS, (T + RB - 1) / RB, chunks);
  bwd_sum_kernel<<<grid, BT, smem, stream>>>(
      dS, offs, fstart, T, N, m, b, n_tiles, tiles_per_chunk, chunks,
      pos_max(m, b), chunks == 1 ? dP : partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(T) * mb;
  bwd_reduce_kernel<<<static_cast<unsigned>((total + NT - 1) / NT), NT, 0,
                      stream>>>(partial, T, mb, chunks, dP);
  return static_cast<int>(cudaGetLastError());
}

bool bwd_args_ok(int T, int m, int b, int N, int tiles_per_chunk,
                 int chunks) {
  const int n_tiles = (N + TILE - 1) / TILE;
  return T >= 1 && m >= 1 && b >= 1 && N >= 1 &&
         static_cast<long long>(m) * TILE <= 65535 &&  // uint16 positions
         tiles_per_chunk >= 1 && chunks >= 1 && chunks <= 65535 &&
         static_cast<long long>(chunks) * tiles_per_chunk >= n_tiles &&
         static_cast<long long>(chunks - 1) * tiles_per_chunk < n_tiles &&
         (T + RB - 1) / RB <= 65535 && m <= 65535;
}

}  // namespace jpq_scores

extern "C" {

// Each returns 0, a CUDA error code (> 0), or -1 for arguments the
// kernels do not take (the Python wrapper checks them first).
// The forward with G queries a block (jpq_scores_fwd_group's) and item
// ranges of `range` items (whole warp steps, jpq_scores_fwd_step), as
// cuda.fwd_plan picks them.  Writes the grid it launched, (item ranges,
// query groups), to grid[0..1].
int jpq_scores_fwd_launch(const void* P, const void* codes, int code_bytes,
                          int T, int m, int b, int N, int G, int range,
                          void* S, int* grid, void* stream) {
  if (T < 1 || m < 1 || b < 1 || N < 1 || (code_bytes != 1 && code_bytes != 4) ||
      G < 4 || G > jpq_scores::FGMAX || G % 4 != 0 ||
      range < jpq_scores::FSTEP || range % jpq_scores::FSTEP != 0 ||
      jpq_scores::fwd_smem(G, m, b) > jpq_scores::SMEM_MAX ||
      (T + G - 1) / G > 65535)
    return -1;
  return jpq_scores::fwd(static_cast<const float*>(P), codes, code_bytes, T,
                         m, b, N, G, range, static_cast<float*>(S), grid,
                         static_cast<cudaStream_t>(stream));
}

// Queries a forward block at (m, b); 0 when the LUT of 4 does not fit.
int jpq_scores_fwd_group(int m, int b) {
  return m < 1 || b < 1 ? 0 : jpq_scores::fwd_group(m, b);
}

// Items a warp step of the forward: an item range is a multiple of it.
int jpq_scores_fwd_step() { return jpq_scores::FSTEP; }

// The backward: the code sort into `sorted` (uint16: the lists
// [n_tiles, m, TILE], then the bin starts [n_tiles, fs_stride(m b)]),
// the sums, and with chunks > 1 the reduction of `partial` [T, chunks,
// m, b] (may be null when chunks == 1).
int jpq_scores_bwd_launch(const void* dS, const void* codes, int code_bytes,
                          int T, int m, int b, int N, int tiles_per_chunk,
                          int chunks, void* sorted, void* partial, void* dP,
                          void* stream) {
  if (!jpq_scores::bwd_args_ok(T, m, b, N, tiles_per_chunk, chunks) ||
      (code_bytes != 1 && code_bytes != 4) ||
      (chunks > 1 && partial == nullptr))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const float*>(dS);
  auto so = static_cast<uint16_t*>(sorted);
  auto pa = static_cast<float*>(partial);
  auto out = static_cast<float*>(dP);
  if (code_bytes == 1)
    return jpq_scores::bwd<uint8_t>(d, codes, T, m, b, N, tiles_per_chunk,
                                    chunks, so, pa, out, st);
  return jpq_scores::bwd<int32_t>(d, codes, T, m, b, N, tiles_per_chunk,
                                  chunks, so, pa, out, st);
}

// The backward's code sort alone (its first kernel), into `sorted` as
// above: for holding it against its plain version.
int jpq_scores_sort_launch(const void* codes, int code_bytes, int m, int b,
                           int N, void* sorted, void* stream) {
  if (m < 1 || b < 1 || N < 1 ||
      static_cast<long long>(m) * jpq_scores::TILE > 65535 ||
      (code_bytes != 1 && code_bytes != 4))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto offs = static_cast<uint16_t*>(sorted);
  const int n_tiles = (N + jpq_scores::TILE - 1) / jpq_scores::TILE;
  auto fstart = offs + static_cast<size_t>(n_tiles) * m * jpq_scores::TILE;
  if (code_bytes == 1)
    return jpq_scores::sort<uint8_t>(codes, m, b, N, offs, fstart, st);
  return jpq_scores::sort<int32_t>(codes, m, b, N, offs, fstart, st);
}

size_t jpq_scores_bwd_smem_bytes(int m, int b) {
  const size_t a = jpq_scores::sort_smem(b), s = jpq_scores::sum_smem(m, b);
  return a > s ? a : s;
}

const char* jpq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
