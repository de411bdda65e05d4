// Packed transmittance weights: a segmented (per-ray) scan over a flat buffer.
//
// Replaces tinynerf_tpu/ops/segscan.py:_segscan_kernel (the Pallas TPU
// segmented Hillis-Steele cumsum) together with the weights math around it
// (segscan.py:_weights_packed_fwd_math).
//
// What bounds it on an H100: memory.  Per sample it reads sigma, delta and
// valid (12 B) and writes one weight (4 B), ~16 B of traffic for a few dozen
// flops, below the ~20 flop/B at which an H100 SXM's published f32 rate
// (67 TFLOP/s) meets its HBM bandwidth (3.35 TB/s), both at its 700 W
// limit.  The serving buffer of 131,072 samples is only ~2 MB, so launch
// latency, the setup kernels and the per-warp dependency chain (load -> 5
// shuffle rounds -> exp) matter as much as the bytes (PERF.md has the
// measured times, on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Design.  The TPU kernel carries a (value, segment id) pair in SMEM from one
// grid step to the next, which works only because a TPU grid runs in order.
// CUDA blocks run in no order, so the carry lives inside a warp instead:
//   * the wrapper passes each segment's [start, end) (segment ids ascend, so
//     the starts come from a sorted search, with no host sync);
//   * one warp owns one segment: its lanes load 32 consecutive samples
//     (coalesced), take an inclusive warp scan with __shfl_up_sync, add the
//     running carry held in a register, apply the fused exp/mask epilogue
//     and store; lane 31's sum becomes the next carry.
// Sums therefore stay segment-local (a ray's own optical depth), which keeps
// f32 precision where a global cumsum minus a per-segment base would not.
// A segment longer than 32 samples loops; the serving path's rays hold up to
// a few hundred samples, so no warp loops more than ~13 times.  Samples whose
// segment is not listed (the renderer's pad tail) are not touched.

#include <cuda_runtime.h>

#include "warp_scan.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// MODE 0: out = segment-local inclusive cumsum of a.
// MODE 1: out = transmittance weights of s = a*b*m (a = sigma, b = delta,
//         m = valid), with c the segment-local inclusive cumsum of s.
template <int MODE>
__global__ void segscan_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ m,
                               const int* __restrict__ starts, int n_segments,
                               float threshold, float* __restrict__ out) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x / tn::kWarp);
  if (warp >= n_segments) return;  // warp-uniform
  const int lane = threadIdx.x & (tn::kWarp - 1);
  const int begin = starts[warp];
  const int end = starts[warp + 1];
  float carry = 0.0f;
  for (int base = begin; base < end; base += tn::kWarp) {  // warp-uniform
    const int i = base + lane;
    const bool in = i < end;
    float s = 0.0f, mi = 0.0f;
    if (in) {
      if (MODE == 0) {
        s = a[i];
      } else {
        mi = m[i];
        s = a[i] * b[i] * mi;
      }
    }
    const float c = carry + tn::warp_inclusive_scan(s);
    if (in) out[i] = (MODE == 0) ? c : tn::transmittance_weight(s, c, mi, threshold);
    carry = __shfl_sync(tn::kFullMask, c, tn::kWarp - 1);
  }
}

int launch_blocks(int n_segments) {
  return (n_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

extern "C" {

// Segment-local inclusive cumsum of x[n]; segment k spans [starts[k], starts[k+1]).
int tn_segmented_cumsum(const void* x, const void* starts, int n_segments,
                        void* out, void* stream) {
  if (n_segments > 0) {
    segscan_kernel<0><<<launch_blocks(n_segments), kWarpsPerBlock * tn::kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), nullptr, nullptr,
        static_cast<const int*>(starts), n_segments, 0.0f,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Packed transmittance weights of sigmas/deltas/valid; segments as above.
int tn_weights_packed(const void* sigmas, const void* deltas, const void* valid,
                      const void* starts, int n_segments, float threshold,
                      void* out, void* stream) {
  if (n_segments > 0) {
    segscan_kernel<1><<<launch_blocks(n_segments), kWarpsPerBlock * tn::kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(deltas),
        static_cast<const float*>(valid), static_cast<const int*>(starts),
        n_segments, threshold, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
