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
// rows, the backward reads the 6.6 MB of dout and writes 0.5 MB; a few
// microseconds at 3.35 TB/s, so latency (launch, dependent loads) is the
// limit, not bandwidth or arithmetic.
//
// Forward design.  A pure gather, one warp per position: lanes 0..m-1
// load the position's code row once (m bytes: one load instruction) and
// shuffle each code to the lanes that copy that split's centroid row, 16
// bytes a lane (float4) where dk % 4 == 0 and the pointers are 16-byte
// aligned, else 4.  Bit-equal to the reference gather.  The TPU kernel's
// one-hot [m, b] x centroids contraction is an MXU device and is not
// carried over.  An id outside [0, N) is clamped so that no thread reads
// outside codes; callers pass valid ids.
//
// Backward design.  Deterministic, no float atomics: each output float
// is one chain of fp32 adds over its positions in ascending order,
// starting from +0.0, which is what index_add_ computes on the CPU (so
// the kernel is bit-equal to the plain version run there, and a code no
// position names writes +0.0).  A block of 16 warps owns one split j,
// 16 codes (one warp each) and a slice of up to 64 floats of dk.
//   1. Bucket.  It walks the positions in chunks of 4,096, reads each
//      one's code in split j, and counting-sorts the positions whose code
//      it owns into per-code lists in shared memory, each in ascending
//      position order: __match_any_sync gives a position its rank among
//      the equal codes of its warp, and a scan over the (code, pass,
//      warp) counts gives each list's offsets.  Every block reads all T
//      codes (a few microseconds); the alternative, one sort pass for the
//      whole grid, costs a second launch and a round trip through memory.
//   2. Sum.  The sorted rows of dout are staged into shared memory with
//      cp.async (16 bytes a copy where dk % 4 == 0 and dout is 16-byte
//      aligned, else 4), 384 rows a batch, double-buffered so the next
//      batch is in flight while each warp adds its code's rows of this
//      one (two floats a lane on the 16-byte path, else one; loads
//      unrolled 16 rows ahead of the adds).
// What bounds it is the data's skew, not the bytes: sequences are left-
// padded with item 0, so in the main path's batch 92% of the positions
// share one code per split and that code's 64 chains each run ~2,900
// dependent adds (~4 cycles each) in one warp.  At those shapes the grid
// (128 blocks of 221 KB, one an SM) is one wave, so the other blocks
// finish within that warp's time.
#include <cstdint>
#include <cuda_runtime.h>

namespace jpq_lookup {

constexpr int NT = 256;           // forward: threads a block
constexpr int NW = NT / 32;       // forward: positions (warps) a block
constexpr unsigned FULL = 0xffffffffu;

// backward
constexpr int BT = 512;                 // threads a block
constexpr int BW = BT / 32;             // warps a block
constexpr int CB = BW;                  // codes a block: one warp sums each
constexpr int PPT = 8;                  // positions a thread buckets a chunk
constexpr int CHUNK = BT * PPT;         // positions bucketed a pass
constexpr int SLICE = 64;               // floats of dk a block
constexpr int STAGE = 24576;            // floats a staging buffer (96 KB)
constexpr int UNR = 16;                 // rows loaded ahead of the adds
constexpr int CPW = PPT * BW;           // (pass, warp) counts of one code
constexpr int CPL = CPW / 32;           // of them, scanned by one lane
static_assert(CPW % 32 == 0, "a warp scans one code's counts");

__device__ __forceinline__ long long clamp_id(long long id, int N) {
  return id < 0 ? 0 : (id >= N ? N - 1 : id);
}

// ------------------------------------------------------------- forward

template <typename CodeT, typename IdT, typename Vec>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const IdT* __restrict__ ids, const CodeT* __restrict__ codes,
               const float* __restrict__ cent, int T, int m, int b, int dk,
               int N, float* __restrict__ out) {
  constexpr int V = sizeof(Vec) / sizeof(float);
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * NW + (threadIdx.x >> 5);
  if (i >= T) return;                          // the whole warp
  const long long id = clamp_id(static_cast<long long>(ids[i]), N);
  const CodeT* row = codes + id * m;
  const int mine = lane < m ? static_cast<int>(row[lane]) : 0;
  const int per = dk / V;                      // vectors a split
  const int total = m * per;                   // vectors a position
  const Vec* src = reinterpret_cast<const Vec*>(cent);
  Vec* dst = reinterpret_cast<Vec*>(out) + i * total;
#pragma unroll 4
  for (int v0 = 0; v0 < total; v0 += 32) {     // the same count every lane
    const int v = v0 + lane;
    const int j = min(v / per, m - 1);
    const int c = m <= 32 ? __shfl_sync(FULL, mine, j)
                          : static_cast<int>(row[j]);
    if (v < total)
      dst[v] = src[(static_cast<size_t>(j) * b + c) * per + (v - j * per)];
  }
}

// ------------------------------------------------------------ backward

struct BwdSmem {
  float stage[2][STAGE];          // dout rows of two batches
  int pos[CHUNK];                 // the chunk's owned positions, by code
  int cnt[CB * CPW];              // counts, then their exclusive offsets
  int off[CB + 1];                // each code's list in pos
  int wtot[BW];
};

// One 16-byte (V = 4) or 4-byte copy from global to shared memory that
// does not wait for its data (cp.async).
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// V: floats a copy; VA: floats a lane adds (2 on the V = 4 path only).
template <typename CodeT, typename IdT, int V, int VA>
__global__ void __launch_bounds__(BT, 1)
    bwd_kernel(const IdT* __restrict__ ids, const CodeT* __restrict__ codes,
               const float* __restrict__ dout, int T, int m, int b, int dk,
               int N, float* __restrict__ dcent) {
  constexpr int QN = (SLICE + 32 * VA - 1) / (32 * VA);   // vectors a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int c0 = blockIdx.x * CB, j = blockIdx.y, k0 = blockIdx.z * SLICE;
  const int W = min(SLICE, dk - k0);           // floats of a row summed here
  const int wv = W / V;                        // copies a row
  const int R = STAGE / W;                     // rows a batch
  const int rpp = BT / wv;                     // rows a copy pass
  const int my_r = tid / wv, my_v = tid - my_r * wv;
  float acc[QN][VA];                           // code c0 + warp, floats
#pragma unroll                                 // k0 + (lane + 32 q) VA + v
  for (int q = 0; q < QN; ++q)
#pragma unroll
    for (int v = 0; v < VA; ++v) acc[q][v] = 0.f;

  for (int t0 = 0; t0 < T; t0 += CHUNK) {
    // 1. each position's code in split j, relative to c0 (owned: [0, CB))
    int cl[PPT];
    {
      long long id[PPT];
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const int t = t0 + p * BT + tid;
        id[p] = t < T ? clamp_id(static_cast<long long>(ids[t]), N) : -1;
      }
#pragma unroll
      for (int p = 0; p < PPT; ++p)
        cl[p] = id[p] < 0 ? -1
                          : static_cast<int>(codes[id[p] * m + j]) - c0;
    }
    __syncthreads();                           // the last chunk is summed
#pragma unroll
    for (int u = 0; u < CPL; ++u) s.cnt[tid * CPL + u] = 0;
    __syncthreads();
    // 2. counting sort by (code, position): rank among the warp's equal
    // codes, and each (code, pass, warp) count
    int rank[PPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const bool own = static_cast<unsigned>(cl[p]) < static_cast<unsigned>(CB);
      const unsigned same = __match_any_sync(FULL, own ? cl[p] : -1);
      rank[p] = __popc(same & lt);
      if (own && rank[p] == 0)
        s.cnt[cl[p] * CPW + p * BW + warp] = __popc(same);
    }
    __syncthreads();
    {   // exclusive scan of the counts; warp w scans code w's
      int x[CPL], sum = 0;
#pragma unroll
      for (int u = 0; u < CPL; ++u) sum += x[u] = s.cnt[tid * CPL + u];
      int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
      }
      if (lane == 31) s.wtot[warp] = inc;
      __syncthreads();
      int ex = inc - sum;
      for (int w = 0; w < warp; ++w) ex += s.wtot[w];
      if (lane == 0) s.off[warp] = ex;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        s.cnt[tid * CPL + u] = ex;
        ex += x[u];
      }
      if (tid == BT - 1) s.off[CB] = ex;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PPT; ++p)
      if (static_cast<unsigned>(cl[p]) < static_cast<unsigned>(CB))
        s.pos[s.cnt[cl[p] * CPW + p * BW + warp] + rank[p]] =
            t0 + p * BT + tid;
    __syncthreads();
    // 3. stage the sorted rows batch by batch; each warp adds its code's
    const int n = s.off[CB];
    const int lo = s.off[warp], hi = s.off[warp + 1];
    const int nb = (n + R - 1) / R;
    auto issue = [&](int bi) {                 // batch bi's copies, in flight
      if (bi < nb && my_r < rpp) {
        const int e0 = bi * R, rows = min(R, n - e0);
        float* st = s.stage[bi & 1] + my_v * V;
        const float* src = dout + static_cast<size_t>(j) * dk + k0 + my_v * V;
#pragma unroll 4
        for (int r = my_r; r < rows; r += rpp)
          copy_async<V>(st + r * W,
                        src + static_cast<size_t>(s.pos[e0 + r]) * m * dk);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    issue(0);
    for (int bi = 0; bi < nb; ++bi) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // own copies
      __syncthreads();                         // everyone's; bi - 1 summed
      issue(bi + 1);
      const float* st = s.stage[bi & 1];
      const int e0 = bi * R;
      const int ra = max(lo, e0) - e0, rb = min(hi, e0 + R) - e0;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int k = (lane + 32 * q) * VA;
        if (k >= W) continue;
        const float* row = st + k;
        int r = ra;
        for (; r + UNR <= rb; r += UNR) {
          float x[UNR][VA];
#pragma unroll
          for (int u = 0; u < UNR; ++u) {
            if constexpr (VA == 2) {
              const float2 y =
                  *reinterpret_cast<const float2*>(row + (r + u) * W);
              x[u][0] = y.x;
              x[u][1] = y.y;
            } else {
              x[u][0] = row[(r + u) * W];
            }
          }
#pragma unroll
          for (int u = 0; u < UNR; ++u)
#pragma unroll
            for (int v = 0; v < VA; ++v)
              acc[q][v] = __fadd_rn(acc[q][v], x[u][v]);
        }
        for (; r < rb; ++r)
#pragma unroll
          for (int v = 0; v < VA; ++v)
            acc[q][v] = __fadd_rn(acc[q][v], row[r * W + v]);
      }
    }
  }
  const int c = c0 + warp;
  if (c < b) {
    float* o = dcent + (static_cast<size_t>(j) * b + c) * dk + k0;
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const int k = (lane + 32 * q) * VA;
      if (k < W)
#pragma unroll
        for (int v = 0; v < VA; ++v) o[k + v] = acc[q][v];
    }
  }
}

// ------------------------------------------------------------ launchers

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename CodeT, typename IdT>
int fwd(const void* ids, const void* codes, const float* cent, int T, int m,
        int b, int dk, int N, float* out, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((T + NW - 1) / NW);
  auto i = static_cast<const IdT*>(ids);
  auto c = static_cast<const CodeT*>(codes);
  if (dk % 4 == 0 && aligned16(cent) && aligned16(out))
    fwd_kernel<CodeT, IdT, float4><<<grid, NT, 0, stream>>>(
        i, c, cent, T, m, b, dk, N, out);
  else
    fwd_kernel<CodeT, IdT, float><<<grid, NT, 0, stream>>>(
        i, c, cent, T, m, b, dk, N, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT, typename IdT, int V, int VA>
int bwd_launch(const void* ids, const void* codes, const float* dout, int T,
               int m, int b, int dk, int N, float* dcent,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<CodeT, IdT, V, VA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(BwdSmem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b + CB - 1) / CB, m, (dk + SLICE - 1) / SLICE);
  bwd_kernel<CodeT, IdT, V, VA><<<grid, BT, sizeof(BwdSmem), stream>>>(
      static_cast<const IdT*>(ids), static_cast<const CodeT*>(codes), dout,
      T, m, b, dk, N, dcent);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT, typename IdT>
int bwd(const void* ids, const void* codes, const float* dout, int T, int m,
        int b, int dk, int N, float* dcent, cudaStream_t stream) {
  if (dk % 4 == 0 && aligned16(dout))
    return bwd_launch<CodeT, IdT, 4, 2>(ids, codes, dout, T, m, b, dk, N,
                                        dcent, stream);
  return bwd_launch<CodeT, IdT, 1, 1>(ids, codes, dout, T, m, b, dk, N,
                                      dcent, stream);
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
         T > (1 << 30) || (dk + SLICE - 1) / SLICE > 65535 ||
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
