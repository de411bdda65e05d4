// Warp-level building blocks shared by the transmittance-weights kernels.
#pragma once

#include <cuda_runtime.h>

namespace tn {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

// Inclusive prefix sum across the 32 lanes of a warp (Kogge-Stone with
// __shfl_up_sync: five shuffle+add rounds, no shared memory).  Every lane of
// the warp must call it.
__device__ __forceinline__ float warp_inclusive_scan(float v) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int k = 1; k < kWarp; k <<= 1) {
    const float u = __shfl_up_sync(kFullMask, v, k);
    if (lane >= k) v += u;
  }
  return v;
}

// Transmittance weight of one sample from its optical depth s = sigma*delta*m
// and the inclusive optical depth c of its ray up to and including it:
//   w = exp(-(c - s)) * (1 - exp(-s)),  zero unless m > 0 and T_before > thr.
__device__ __forceinline__ float transmittance_weight(float s, float c, float m,
                                                      float thr) {
  const float t_before = expf(-(c - s));
  const float w = t_before * (1.0f - expf(-s));
  return (m > 0.0f && t_before > thr) ? w : 0.0f;
}

}  // namespace tn
