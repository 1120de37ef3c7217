// Shared-memory loads at a 32-bit shared address (__cvta_generic_to_shared),
// for kernels that compute their own addresses: jpq_scores.cu's forward and
// jpq_sweep.cuh.  The address must be 16-byte aligned.
#pragma once

#include <cuda_runtime.h>

namespace smem {

__device__ __forceinline__ float4 lds4(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

}  // namespace smem
