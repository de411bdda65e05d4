// Packed transmittance weights: a segmented (per-ray) scan over a flat buffer.
//
// Replaces tinynerf_tpu/ops/segscan.py:_segscan_kernel (the Pallas TPU
// segmented Hillis-Steele cumsum) together with the weights math around it
// (segscan.py:_weights_packed_fwd_math), and its reverse scan in the
// backward (segscan.py:_cwp_bwd).
//
// What bounds it on an H100: at the training buffer of 819,200 samples,
// memory (20 B per sample forward: sigma, delta, valid, the ray id and the
// weight; 28 B backward; a few dozen flops against the ~20 flop/B at which
// an H100 SXM's published 67 TFLOP/s of f32 meets its 3.35 TB/s, both at its
// 700 W limit).  At the serving buffer of 131,072 samples the bytes take
// under a microsecond, less than any launch: there the bound is the time of
// the card's shortest kernel and the number of launches per call.  What
// kept a scan with one warp per ray away from either bound is the ray-length
// distribution: its parallelism is the number of rays, its lanes in use the
// ray length modulo 32 (a converged scene leaves ~3 samples per ray, so 3
// lanes of 32), its work per warp a serial chain of rounds, and the ray
// boundaries had to be searched for by extra launches (PERF.md has the
// measured times, on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Design: parallel over samples, one launch per direction, no auxiliary
// launch.  The TPU kernel carries a (value, segment id) pair from one grid
// step to the next, which works only because a TPU grid runs in order; CUDA
// blocks run in no order, so no block waits for another here:
//   * a block takes a tile of kTile contiguous samples; a thread loads
//     kItems consecutive samples of each array with one 16-byte load and
//     finds segment heads itself, from seg[i] != seg[i-1];
//   * inside the tile a segmented scan on (sum, head flag) pairs: serial
//     over the thread's own samples, __shfl_up_sync across the warp's thread
//     totals, and the eight warp totals through shared memory;
//   * the carry into the tile, for the one segment that began before it: the
//     block walks BACK from the tile's first sample while the id stays the
//     same and sums there (kThreads samples per round, from L2).  A ray holds
//     at most n_samples (400) samples, so that is at most two rounds; the
//     walk needs no order between blocks and no look-back flags;
//   * ids outside [0, n_segments) (the renderer's pad tail) get an explicit
//     0 from the kernel, and a tile that starts inside them walks nowhere:
//     the output needs no fill and the wrapper no search for the boundaries.
// Sums stay segment-local (a ray's own optical depth: the walked carry, then
// the tile's prefix), which keeps f32 precision where a global cumsum minus
// a per-segment base would not.  Ids may be any contiguous runs, ascending
// or not.  The general cumsum (MODE 0, no id range) is correct for segments
// of any length, but every tile inside a segment walks back to its head: a
// segment of L samples costs L/kTile tiles x L/(2 kThreads) rounds on
// average, quadratic in L, each round one load and one block barrier
// (~100,000 samples: ~200 rounds for each of its ~100 tiles).
//
// Backward (weights_packed_bwd_kernel), in the same launch shape.  The TPU
// backward runs the segmented scan in reverse for the strict suffix sums of
// w*g and reads the inclusive optical depth c saved by its forward.  Here
// the forward keeps no c: the tile rescans s with the walk back (two extra
// loads per sample, cheaper than writing and re-reading c), and scans w*g
// FROM THE RIGHT with a walk forward to the ray's end for the suffix sum.
// The reverse scan is the reference's own formulation and needs one walk;
// total(w g) - incl(w g) would need a walk each way for w*g and cancels
// where the suffix is small against the total.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "warp_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // samples per thread: one 16-byte load per array
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / tn::kWarp;

// Scratch of one tile scan, and of one walk (two rounds in flight).
struct ScanScratch {
  float v[kWarps];
  int f[kWarps];
};
struct WalkScratch {
  float sum[2][kWarps];
  int stop[2][kWarps];
};

// kItems consecutive values from p[i0 ...]: one 16-byte load when `vec` (the
// array is 16-byte aligned) and all lie below n, else one by one, `fill`
// from n on.
template <typename T>
__device__ __forceinline__ void load_items(const T* __restrict__ p, int i0, int n, bool vec,
                                           T fill, T (&x)[kItems]) {
  static_assert(sizeof(T) * kItems == sizeof(int4), "one 16-byte load");
  if (vec && i0 + kItems <= n) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p + i0));
    memcpy(x, &raw, sizeof(raw));
  } else {
#pragma unroll
    for (int u = 0; u < kItems; ++u) x[u] = i0 + u < n ? __ldg(p + i0 + u) : fill;
  }
}

__device__ __forceinline__ void store_items(float* __restrict__ p, int i0, int n, bool vec,
                                            const float (&x)[kItems]) {
  if (vec && i0 + kItems <= n) {
    int4 raw;
    memcpy(&raw, x, sizeof(raw));
    *reinterpret_cast<int4*>(p + i0) = raw;
  } else {
#pragma unroll
    for (int u = 0; u < kItems; ++u)
      if (i0 + u < n) p[i0 + u] = x[u];
  }
}

// Where each of the thread's samples starts a segment in the scan's
// direction: its id differs from its predecessor's (REV: its successor's),
// or it has none, or it lies beyond n.
template <bool REV>
__device__ __forceinline__ void segment_starts(const int* __restrict__ seg, const int (&id)[kItems],
                                               int i0, int n, bool (&start)[kItems]) {
  const int nb = REV ? i0 + kItems : i0 - 1;  // the neighbouring thread's nearest sample
  const bool has_nb = REV ? nb < n : nb >= 0 && nb < n;
  const int nb_id = has_nb ? __ldg(seg + nb) : 0;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const bool edge = REV ? u == kItems - 1 : u == 0;
    const int other = edge ? nb_id : id[REV ? u + 1 : u - 1];
    const bool has = edge ? has_nb : (REV ? i0 + u + 1 < n : true);
    start[u] = i0 + u >= n || !has || id[u] != other;
  }
}

// Segmented inclusive scan of the tile's values v (in place), forward or
// from the right, with `carry` the sum of the first segment's samples that
// lie before (REV: after) the tile.  Every thread of the block must call it.
template <bool REV>
__device__ __forceinline__ void tile_scan(float (&v)[kItems], const bool (&start)[kItems],
                                          float carry, ScanScratch& sh) {
  const int lane = threadIdx.x & (tn::kWarp - 1), warp = threadIdx.x / tn::kWarp;
  // the thread's own samples, serially
  float run = 0.0f;
  bool any = false;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int j = REV ? kItems - 1 - u : u;
    run = start[j] ? v[j] : run + v[j];
    any |= start[j];
    v[j] = run;
  }
  // the warp's thread totals: a scan of (sum, a start seen) pairs
  float tv = run;
  int tf = any;
#pragma unroll
  for (int d = 1; d < tn::kWarp; d <<= 1) {
    const float ov = REV ? __shfl_down_sync(tn::kFullMask, tv, d) : __shfl_up_sync(tn::kFullMask, tv, d);
    const int of = REV ? __shfl_down_sync(tn::kFullMask, tf, d) : __shfl_up_sync(tn::kFullMask, tf, d);
    if (REV ? lane + d < tn::kWarp : lane >= d) {
      if (!tf) tv += ov;
      tf |= of;
    }
  }
  if (lane == (REV ? 0 : tn::kWarp - 1)) {  // the warp's total
    sh.v[warp] = tv;
    sh.f[warp] = tf;
  }
  // what the lanes before this one hold
  float ev = REV ? __shfl_down_sync(tn::kFullMask, tv, 1) : __shfl_up_sync(tn::kFullMask, tv, 1);
  int ef = REV ? __shfl_down_sync(tn::kFullMask, tf, 1) : __shfl_up_sync(tn::kFullMask, tf, 1);
  if (lane == (REV ? tn::kWarp - 1 : 0)) {
    ev = 0.0f;
    ef = 0;
  }
  __syncthreads();
  // the carry, then the warps before this one, in the scan's order
  float pv = carry;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int o = REV ? kWarps - 1 - u : u;
    if (REV ? o > warp : o < warp) pv = sh.f[o] ? sh.v[o] : pv + sh.v[o];
  }
  const float before = ef ? ev : pv + ev;
  bool open = true;  // no start yet among the thread's samples
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int j = REV ? kItems - 1 - u : u;
    open = open && !start[j];
    if (open) v[j] += before;
  }
}

// The sum of value(j) over the run of samples with id `id` that ends right
// before position `from` (FWD: that begins at `from`), kThreads samples per
// round, nearest first; every thread returns the same sum.  Every thread of
// the block must call it.
template <bool FWD, typename Value>
__device__ __forceinline__ float walk(const int* __restrict__ seg, int id, int from, int n,
                                      Value value, WalkScratch& sh) {
  const int lane = threadIdx.x & (tn::kWarp - 1), warp = threadIdx.x / tn::kWarp;
  const int room = FWD ? n - from : from;  // samples on that side
  float acc = 0.0f;
  for (int r = 0;; ++r) {  // block-uniform
    const int d = r * kThreads + threadIdx.x;
    const int j = FWD ? from + d : from - 1 - d;
    const bool ok = d < room && __ldg(seg + j) == id;
    const int stop = __ffs(~__ballot_sync(tn::kFullMask, ok)) - 1;  // first lane off the run, or -1
    const float part = tn::warp_sum(ok && (stop < 0 || lane < stop) ? value(j) : 0.0f);
    if (lane == 0) {
      sh.sum[r & 1][warp] = part;
      sh.stop[r & 1][warp] = stop;
    }
    __syncthreads();
    bool done = false;
    for (int u = 0; u < kWarps && !done; ++u) {
      acc += sh.sum[r & 1][u];
      done = sh.stop[r & 1][u] >= 0;
    }
    if (done) return acc;
  }
}

__device__ __forceinline__ bool in_range(int id, int n_segments) {
  return n_segments < 0 || static_cast<unsigned>(id) < static_cast<unsigned>(n_segments);
}

// MODE 0: out = segment-local inclusive cumsum of a.
// MODE 1: out = transmittance weights of s = a*b*m (a = sigma, b = delta,
//         m = valid), with c the segment-local inclusive cumsum of s.
// Ids outside [0, n_segments) get 0 (n_segments < 0: every id counts).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    segscan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ m, const int* __restrict__ seg, int n, int n_segments,
                   float threshold, bool vec, float* __restrict__ out) {
  __shared__ ScanScratch scan_sh;
  __shared__ WalkScratch walk_sh;
  const int base = blockIdx.x * kTile;
  const int i0 = base + threadIdx.x * kItems;
  int id[kItems];
  float s[kItems], mi[kItems], c[kItems];
  load_items(seg, i0, n, vec, 0, id);
  load_items(a, i0, n, vec, 0.0f, s);
  if (MODE == 1) {
    float bi[kItems];
    load_items(b, i0, n, vec, 0.0f, bi);
    load_items(m, i0, n, vec, 0.0f, mi);
#pragma unroll
    for (int u = 0; u < kItems; ++u) s[u] = s[u] * bi[u] * mi[u];
  }
  bool start[kItems];
  segment_starts<false>(seg, id, i0, n, start);
  const int id0 = __ldg(seg + base);
  float carry = 0.0f;
  if (base > 0 && in_range(id0, n_segments)) {  // block-uniform
    carry = walk<false>(seg, id0, base, n, [&](int j) {
      return MODE == 0 ? __ldg(a + j) : __ldg(a + j) * __ldg(b + j) * __ldg(m + j);
    }, walk_sh);
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) c[u] = s[u];
  tile_scan<false>(c, start, carry, scan_sh);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const float y = MODE == 0 ? c[u] : tn::transmittance_weight(s[u], c[u], mi[u], threshold);
    c[u] = in_range(id[u], n_segments) ? y : 0.0f;
  }
  store_items(out, i0, n, vec, c);
}

// d loss / d sigma of the weights above, from the weights w and their
// cotangent g:  delta * m * (exp(-c) g - sum_{j > k in the ray} w_j g_j).
__global__ void __launch_bounds__(kThreads)
    weights_packed_bwd_kernel(const float* __restrict__ sigmas, const float* __restrict__ deltas,
                              const float* __restrict__ valid, const int* __restrict__ seg,
                              const float* __restrict__ w, const float* __restrict__ g, int n,
                              int n_segments, bool vec, float* __restrict__ out) {
  __shared__ ScanScratch scan_sh[2];
  __shared__ WalkScratch walk_sh[2];
  const int base = blockIdx.x * kTile;
  const int i0 = base + threadIdx.x * kItems;
  int id[kItems];
  float c[kItems], di[kItems], mi[kItems], wg[kItems], gi[kItems], suffix[kItems];
  load_items(seg, i0, n, vec, 0, id);
  load_items(sigmas, i0, n, vec, 0.0f, c);
  load_items(deltas, i0, n, vec, 0.0f, di);
  load_items(valid, i0, n, vec, 0.0f, mi);
  load_items(w, i0, n, vec, 0.0f, wg);
  load_items(g, i0, n, vec, 0.0f, gi);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    c[u] = c[u] * di[u] * mi[u];
    wg[u] *= gi[u];
    suffix[u] = wg[u];
  }
  bool start[kItems];
  // the inclusive optical depth c: forward, the carry walked back
  segment_starts<false>(seg, id, i0, n, start);
  const int id0 = __ldg(seg + base);
  float carry = 0.0f;
  if (base > 0 && in_range(id0, n_segments)) {  // block-uniform
    carry = walk<false>(seg, id0, base, n, [&](int j) {
      return __ldg(sigmas + j) * __ldg(deltas + j) * __ldg(valid + j);
    }, walk_sh[0]);
  }
  tile_scan<false>(c, start, carry, scan_sh[0]);
  // the inclusive suffix sum of w g: from the right, the carry walked forward
  segment_starts<true>(seg, id, i0, n, start);
  const int end = min(base + kTile, n);
  const int id1 = __ldg(seg + end - 1);
  carry = 0.0f;
  if (end < n && in_range(id1, n_segments)) {  // block-uniform
    carry = walk<true>(seg, id1, end, n, [&](int j) { return __ldg(w + j) * __ldg(g + j); },
                       walk_sh[1]);
  }
  tile_scan<true>(suffix, start, carry, scan_sh[1]);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const float y = di[u] * (expf(-c[u]) * gi[u] - (suffix[u] - wg[u])) * mi[u];
    c[u] = in_range(id[u], n_segments) ? y : 0.0f;
  }
  store_items(out, i0, n, vec, c);
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

// Whether every array can take 16-byte loads (a view into a tensor may not).
template <typename... P>
bool aligned16(P... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ...) & 15) == 0;
}

constexpr int kMaxSamples = INT_MAX - 2 * kTile;  // index arithmetic stays in int

}  // namespace

extern "C" {

// Segment-local inclusive cumsum of x[n] by the ids seg[n] (contiguous
// runs); ids outside [0, n_segments) get 0, n_segments < 0: none is outside.
int tn_segmented_cumsum(const void* x, const void* seg, int n, int n_segments, void* out,
                        void* stream) {
  if (n < 0 || n > kMaxSamples) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    segscan_kernel<0><<<tiles(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), nullptr, nullptr, static_cast<const int*>(seg), n,
        n_segments, 0.0f, aligned16(x, seg, out), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Packed transmittance weights of sigmas/deltas/valid; segments as above.
int tn_weights_packed(const void* sigmas, const void* deltas, const void* valid, const void* seg,
                      int n, int n_segments, float threshold, void* out, void* stream) {
  if (n < 0 || n > kMaxSamples) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    segscan_kernel<1><<<tiles(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(deltas),
        static_cast<const float*>(valid), static_cast<const int*>(seg), n, n_segments, threshold,
        aligned16(sigmas, deltas, valid, seg, out), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// d loss / d sigmas of tn_weights_packed given the weights w and their
// cotangent g; ids outside [0, n_segments) get 0.
int tn_weights_packed_bwd(const void* sigmas, const void* deltas, const void* valid,
                          const void* seg, const void* w, const void* g, int n, int n_segments,
                          void* out, void* stream) {
  if (n < 0 || n > kMaxSamples) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    weights_packed_bwd_kernel<<<tiles(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigmas), static_cast<const float*>(deltas),
        static_cast<const float*>(valid), static_cast<const int*>(seg),
        static_cast<const float*>(w), static_cast<const float*>(g), n, n_segments,
        aligned16(sigmas, deltas, valid, seg, w, g, out), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
