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

// Sum over the 32 lanes of a warp, returned to every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = kWarp / 2; k > 0; k >>= 1) v += __shfl_xor_sync(kFullMask, v, k);
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

// Closed-form backward of the weights over one ray's samples [begin, end),
// walked by one warp (every lane must call it):
//   d sigma_k = delta_k * m_k * (incl_k(w g) - total(w g) + exp(-c_k) g_k)
// with c_k the inclusive optical depth.  incl - total is minus the strict
// suffix sum of w g, the reference's reverse scan.  Pass 1 scans w g for
// total(w g), the last inclusive sum, as the TPU kernel takes it
// (weights_pallas.py:_bwd_kernel); pass 2 repeats that scan operation for
// operation, beside the scan of s, with both carries in registers, so sums
// stay inside the ray and incl - total is exactly 0 past the ray's last
// sample with a weight (a total reduced in another order would leave a
// rounding residue there, which the unbounded marcher's far-field deltas,
// hundreds of units, would multiply).
__device__ __forceinline__ void weights_backward_run(
    const float* __restrict__ sigmas, const float* __restrict__ deltas,
    const float* __restrict__ m, const float* __restrict__ w,
    const float* __restrict__ g, int begin, int end, float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  float total = 0.0f;
  for (int base = begin; base < end; base += kWarp) {  // warp-uniform
    const int i = base + lane;
    // __fmul_rn: no FMA contraction, so that pass 2 rounds w g the same
    const float incl = total + warp_inclusive_scan(i < end ? __fmul_rn(w[i], g[i]) : 0.0f);
    total = __shfl_sync(kFullMask, incl, kWarp - 1);
  }
  float carry_s = 0.0f, carry_wg = 0.0f;
  for (int base = begin; base < end; base += kWarp) {  // warp-uniform
    const int i = base + lane;
    const bool in = i < end;
    float s = 0.0f, wg = 0.0f, gi = 0.0f, di = 0.0f, mi = 0.0f;
    if (in) {
      mi = m[i];
      di = deltas[i];
      s = sigmas[i] * di * mi;
      gi = g[i];
      wg = __fmul_rn(w[i], gi);
    }
    const float c = carry_s + warp_inclusive_scan(s);
    const float incl = carry_wg + warp_inclusive_scan(wg);
    if (in) out[i] = di * (incl - total + expf(-c) * gi) * mi;
    carry_s = __shfl_sync(kFullMask, c, kWarp - 1);
    carry_wg = __shfl_sync(kFullMask, incl, kWarp - 1);
  }
}

}  // namespace tn
