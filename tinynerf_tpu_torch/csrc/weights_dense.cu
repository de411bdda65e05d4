// Dense transmittance weights on an [R, S] ray-by-sample grid.
//
// Replaces tinynerf_tpu/ops/weights_pallas.py:_fwd_kernel, the Pallas TPU
// forward of compute_weights_pallas: per row, s = sigma*delta*m, inclusive
// cumsum c along the row, w = exp(-(c - s)) * (1 - exp(-s)), zeroed where
// m == 0 or T_before <= threshold.
//
// What bounds it on an H100: memory.  Each sample is read once as sigma,
// delta and m (12 B) and written once as w (4 B); at the dense fallback's
// [2048, 400] that is 13 MB per call, 3.9 us at an H100 SXM's published
// 3.35 TB/s (700 W limit), so the kernel must avoid a second pass (no
// materialized cumsum) and keep its loads coalesced (PERF.md has the
// measured time, on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Design.  The TPU kernel scans all rows of a 256-row VMEM block at once
// with a log2(S) Hillis-Steele sweep along lanes.  Here one warp owns one
// row and walks it in chunks of 32 samples: coalesced loads, an inclusive
// __shfl_up_sync scan, a running carry in a register, and the fused exp/mask
// epilogue, so sigma/delta/m are read once and w is written once.  Rows are
// independent, so 2048 rows give 2048 warps, enough to fill the 132 SMs.

#include <cuda_runtime.h>

#include "warp_scan.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void weights_dense_kernel(const float* __restrict__ sigmas,
                                     const float* __restrict__ deltas,
                                     const float* __restrict__ mask, int n_rows,
                                     int n_cols, float threshold,
                                     float* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x / tn::kWarp);
  if (row >= n_rows) return;  // warp-uniform
  const int lane = threadIdx.x & (tn::kWarp - 1);
  const size_t off = static_cast<size_t>(row) * n_cols;
  float carry = 0.0f;
  for (int base = 0; base < n_cols; base += tn::kWarp) {  // warp-uniform
    const int j = base + lane;
    const bool in = j < n_cols;
    float s = 0.0f, mj = 0.0f;
    if (in) {
      mj = mask[off + j];
      s = sigmas[off + j] * deltas[off + j] * mj;
    }
    const float c = carry + tn::warp_inclusive_scan(s);
    if (in) out[off + j] = tn::transmittance_weight(s, c, mj, threshold);
    carry = __shfl_sync(tn::kFullMask, c, tn::kWarp - 1);
  }
}

}  // namespace

extern "C" {

int tn_weights_dense(const void* sigmas, const void* deltas, const void* mask,
                     int n_rows, int n_cols, float threshold, void* out,
                     void* stream) {
  if (n_rows > 0 && n_cols > 0) {
    const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    weights_dense_kernel<<<blocks, kWarpsPerBlock * tn::kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(deltas),
        static_cast<const float*>(mask), n_rows, n_cols, threshold,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
