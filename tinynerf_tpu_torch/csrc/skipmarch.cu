// Empty-space-skipping march (AABB marcher): per ray, the emitted sample
// indices k_idx [R, n_steps] (-1 = none) and the completeness flag [R].
//
// Replaces the lax.scan of tinynerf_tpu/core/skipmarch.py:skip_march (not a
// Pallas kernel: XLA fuses the scan body on the TPU; eager PyTorch would
// launch ~25 small ops per round).  One thread per ray walks all its rounds:
// per round it computes the candidate sample's position, probes ONE value of
// the cone skip grid (the JAX _probe's lane trick is a plain gather here),
// then emits the sample or jumps over the certified-empty span.
//
// Exactness: the emitted set must equal the dense march's surviving set bit
// for bit, so every step is the dense path's f32 operation in its order,
// each rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn:
// nvcc -O3 would otherwise contract a*b+c into an FMA):
//   t    = (t_min + k * delta) + u * delta     (core/marching.py, renderer.py)
//   p    = o + d * t
//   c    = (p - lo) / (hi - lo) * 2 - 1, in box iff lo <= p <= hi per axis
//   voxel = clip(rint((c + 1) * 0.5 * (r - 1)), 0, r - 1), rint = half-to-even
//   k_end = clip(floor((t_exit - t_min) / delta) + 2, 0, n_samples)
//   dominant axis = first maximum of |d_a| / w_a; rate = delta * that
//   adv  = max(floor((g - 2) / rate), 1)
// and the jitter u is the uint32 fmix32 hash of ops/hashrng.py.
//
// What bounds it on an H100: latency, not bandwidth.  Each round is one
// dependent 4-byte gather into the 6 x r^3 int32 skip grid (50 MB at r = 128,
// about the size of the L2) plus ~40 f32 operations; a serving chunk has
// 2048 rays, i.e. 64 warps on 132 SMs.  The design keeps everything else in
// registers: k, done and the ray's constants; the output row is written as
// the rounds go (after a ray finishes, -1 for its remaining rounds).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// uniform [0, 1) per (seed, ray, sample): ops/hashrng.py:hash_u01
__device__ __forceinline__ float hash_u01(uint32_t s0, uint32_t s1, uint32_t ray, uint32_t k) {
  const uint32_t h = fmix32((ray * 0x9E3779B9u + k * 0x7FEB352Du + s0) ^ s1);
  return __fmul_rn(static_cast<float>(h >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ int voxel(float p, float lo, float ext, float res) {
  const float c = __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(p, lo), ext), 2.0f), 1.0f);
  const float x = rintf(__fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), res));
  return static_cast<int>(fminf(fmaxf(x, 0.0f), res));
}

__global__ void skip_march_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                                  const float* __restrict__ t_min, const float* __restrict__ t_exit,
                                  const int* __restrict__ grid, const long long* __restrict__ seed,
                                  int n_rays, int r0, int r1, int r2, int n_samples, float delta,
                                  int n_steps, float3 lo, float3 hi, float3 w,
                                  int* __restrict__ k_idx, bool* __restrict__ complete) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = rays_o[3 * r], oy = rays_o[3 * r + 1], oz = rays_o[3 * r + 2];
  const float dx = rays_d[3 * r], dy = rays_d[3 * r + 1], dz = rays_d[3 * r + 2];

  // dominant axis by index rate |d_a| / w_a, the first maximum on ties
  const float ir0 = __fdiv_rn(fabsf(dx), w.x), ir1 = __fdiv_rn(fabsf(dy), w.y),
              ir2 = __fdiv_rn(fabsf(dz), w.z);
  int dom = 0;
  float ir = ir0;
  if (ir1 > ir) dom = 1, ir = ir1;
  if (ir2 > ir) dom = 2, ir = ir2;
  const float d_dom = dom == 0 ? dx : (dom == 1 ? dy : dz);
  const long long n_vox = static_cast<long long>(r0) * r1 * r2;
  const int* g_dir = grid + (dom * 2 + (d_dom < 0.0f ? 1 : 0)) * n_vox;
  const float rate = __fmul_rn(delta, ir);

  const float tm = t_min[r];
  float ke = __fadd_rn(floorf(__fdiv_rn(__fsub_rn(t_exit[r], tm), delta)), 2.0f);
  const int k_end = static_cast<int>(fminf(fmaxf(ke, 0.0f), static_cast<float>(n_samples)));

  const bool jitter = seed != nullptr;
  const uint32_t s0 = jitter ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t s1 = jitter ? static_cast<uint32_t>(seed[1]) : 0u;
  const float ext_x = __fsub_rn(hi.x, lo.x), ext_y = __fsub_rn(hi.y, lo.y), ext_z = __fsub_rn(hi.z, lo.z);
  const float res_x = static_cast<float>(r0 - 1), res_y = static_cast<float>(r1 - 1),
              res_z = static_cast<float>(r2 - 1);

  int* out = k_idx + static_cast<long long>(r) * n_steps;
  int k = 0;
  bool done = false;
  for (int s = 0; s < n_steps; ++s) {
    if (done) {  // finished rays emit nothing and stay where they are
      out[s] = -1;
      continue;
    }
    const int kk = min(k, n_samples - 1);
    float t = __fadd_rn(tm, __fmul_rn(static_cast<float>(kk), delta));
    if (jitter) t = __fadd_rn(t, __fmul_rn(hash_u01(s0, s1, static_cast<uint32_t>(r), kk), delta));
    const float px = __fadd_rn(ox, __fmul_rn(dx, t)), py = __fadd_rn(oy, __fmul_rn(dy, t)),
                pz = __fadd_rn(oz, __fmul_rn(dz, t));
    const bool inbox = px >= lo.x && px <= hi.x && py >= lo.y && py <= hi.y && pz >= lo.z && pz <= hi.z;
    const int ix = voxel(px, lo.x, ext_x, res_x), iy = voxel(py, lo.y, ext_y, res_y),
              iz = voxel(pz, lo.z, ext_z, res_z);
    const int g = __ldg(g_dir + (static_cast<long long>(ix) * r1 + iy) * r2 + iz);
    const bool active = k < k_end;
    out[s] = (active && g == 0 && inbox) ? kk : -1;
    if (active) {
      const int adv = static_cast<int>(floorf(__fdiv_rn(__fsub_rn(static_cast<float>(g), 2.0f), rate)));
      k += max(adv, 1);
    }
    done = k >= k_end;
  }
  complete[r] = done;
}

}  // namespace

extern "C" {

// rays_o, rays_d: [n_rays, 3] f32; t_min, t_exit: [n_rays] f32; grid: [6, r0,
// r1, r2] int32; seed: two int64 words holding uint32 values, or null (no
// jitter); k_idx: [n_rays, n_steps] int32; complete: [n_rays] bool.  All
// contiguous on one device.  lo / hi: the box; w: the voxel widths.
int tn_skip_march(const void* rays_o, const void* rays_d, const void* t_min, const void* t_exit,
                  const void* grid, const void* seed, int n_rays, int r0, int r1, int r2,
                  int n_samples, float delta, int n_steps, float lo_x, float lo_y, float lo_z,
                  float hi_x, float hi_y, float hi_z, float w_x, float w_y, float w_z, void* k_idx,
                  void* complete, void* stream) {
  if (n_rays < 1 || r0 < 2 || r1 < 2 || r2 < 2 || n_samples < 1 || n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  skip_march_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(t_min), static_cast<const float*>(t_exit),
      static_cast<const int*>(grid), static_cast<const long long*>(seed), n_rays, r0, r1, r2,
      n_samples, delta, n_steps, make_float3(lo_x, lo_y, lo_z), make_float3(hi_x, hi_y, hi_z),
      make_float3(w_x, w_y, w_z), static_cast<int*>(k_idx), static_cast<bool*>(complete));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
