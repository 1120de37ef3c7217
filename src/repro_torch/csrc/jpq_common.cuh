// Shared device code of the PQTopK kernels (jpq_topk.cu,
// jpq_topk_pruned.cu through jpq_sweep.cuh): the total-order key and the
// warp-aggregated append to a candidate buffer.
//
// Ranking.  Every candidate is one 64-bit key
//     key = ukey(value) << 32 | id
// where ukey maps a float to a uint32 whose ASCENDING order is the IEEE
// total order of the value DESCENDING (+0.0 above -0.0) — the ranking of
// the reference's lax.top_k.  Ascending key order is then (value desc,
// id asc), the order of a top-k over the materialised score matrix with
// ties to the smallest id.  Two equal keys are the same (value, id)
// entry, so any choice among them gives the same result.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace jpq {

constexpr int KMAX = 1024;  // largest k the kernels take

__device__ __forceinline__ uint32_t ukey(float v) {
  int b = __float_as_int(-v);
  int k = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return static_cast<uint32_t>(k) ^ 0x80000000u;
}

__device__ __forceinline__ float uval(uint32_t u) {
  int k = static_cast<int>(u ^ 0x80000000u);
  int b = k < 0 ? (k ^ 0x7FFFFFFF) : k;
  return -__int_as_float(b);
}

__device__ __forceinline__ uint64_t make_key(float v, int id) {
  return (static_cast<uint64_t>(ukey(v)) << 32) | static_cast<uint32_t>(id);
}

__device__ __forceinline__ float key_value(uint64_t key) {
  return uval(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ int key_id(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key & 0xFFFFFFFFull));
}

// Append `key` to a candidate buffer when `pass`; one atomic per warp.
// All 32 lanes must call it together.
__device__ __forceinline__ void append(bool pass, uint64_t key,
                                       uint64_t* buf, int* cnt) {
  const unsigned ballot = __ballot_sync(0xffffffffu, pass);
  if (ballot == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (pass) buf[base + __popc(ballot & ((1u << lane) - 1u))] = key;
}

}  // namespace jpq
