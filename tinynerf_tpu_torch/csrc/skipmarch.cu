// Empty-space-skipping marches: per ray, the emitted sample indices k_idx
// [R, n_steps] (-1 = none) and the completeness flag [R].  Two kernels, one
// per marcher: skip_march_kernel (AABB, below) and
// skip_march_unbounded_kernel (the Mip-360 disparity grid, further down).
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

// ---------------------------------------------------------------- unbounded
//
// Replaces the lax.scan of tinynerf_tpu/core/skipmarch.py:skip_march_unbounded
// (not a Pallas kernel either).  Per round, one thread per ray computes the
// candidate sample's t on the disparity grid, its jitter, position and
// Mip-360 contraction, probes ONE int32 of the isotropic skip grid, emits on
// g == 0 and advances by the local Lipschitz certificate.  The position side
// repeats the dense march's f32 operations in their order, each rounded on
// its own (the dense march's t comes from a numpy grid on the host):
//   x    = k * step_x;  f = x < 0.5 ? 2x : 1 / max(2 - 2x, 1e-9)
//   t_k  = f * range + near;  delta_k = t_{k+1} - t_k;  t = t_k + u * delta_k
//   p    = o + d * t;  m = max|p_a|;  c = m <= 1 ? p : ((2 - 1/max(m, 1e-12)) * p) / max(m, 1e-12)
//   voxel = clip(rint(((c / 2) + 1) * 0.5 * (r - 1)), 0, r - 1)
// The advance side (the radii, F(m0), x_of_t) need not match anything bit
// for bit, only stay conservative, but it repeats the plain version's
// operations too (__fsqrt_rn, __fdiv_rn), so that the kernel and the plain
// version give the same k_idx on the card.
//
// What bounds it: latency, as the AABB march.  Each round is one dependent
// 4-byte gather into the r^3 int32 grid (8 MB at r = 128, in L2) and ~100
// f32 operations (four IEEE divisions, two square roots); a serving chunk
// has 2048 rays, 64 warps on 132 SMs.

__device__ __forceinline__ float t_of_x(float x, float rng, float near) {
  const float f = x < 0.5f ? __fmul_rn(2.0f, x)
                           : __fdiv_rn(1.0f, fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, x)), static_cast<float>(1e-9)));
  return __fadd_rn(__fmul_rn(f, rng), near);
}

__device__ __forceinline__ float x_of_t(float t, float rng, float near) {
  const float y = fmaxf(__fdiv_rn(__fsub_rn(t, near), rng), 0.0f);
  return y < 1.0f ? __fmul_rn(y, 0.5f) : __fsub_rn(1.0f, __fdiv_rn(0.5f, fmaxf(y, 1.0f)));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

// the order-inf Mip-360 contraction of one coordinate given the point's
// inf-norm m, then the voxel index on an align_corners grid of r - 1 cells
__device__ __forceinline__ int contracted_voxel(float p, float m, float res) {
  float c = p;
  if (!(m <= 1.0f)) {
    const float safe = fmaxf(m, static_cast<float>(1e-12));
    c = __fdiv_rn(__fmul_rn(__fsub_rn(2.0f, __fdiv_rn(1.0f, safe)), p), safe);
  }
  c = __fmul_rn(c, 0.5f);
  const float x = rintf(__fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), res));
  return static_cast<int>(fminf(fmaxf(x, 0.0f), res));
}

__global__ void skip_march_unbounded_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                                            const int* __restrict__ grid, const long long* __restrict__ seed,
                                            int n_rays, int r, int n_samples, int n_steps, float step_x,
                                            float rng, float near, float x_last, float w_c, float inv_sqrt3,
                                            float inv_lip, int* __restrict__ k_idx, bool* __restrict__ complete) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const float ox = rays_o[3 * ray], oy = rays_o[3 * ray + 1], oz = rays_o[3 * ray + 2];
  const float dx = rays_d[3 * ray], dy = rays_d[3 * ray + 1], dz = rays_d[3 * ray + 2];
  // closest approach to the origin: t_star and the radius there
  const float t_star = -__fadd_rn(__fadd_rn(__fmul_rn(ox, dx), __fmul_rn(oy, dy)), __fmul_rn(oz, dz));
  const float n_perp = norm3(__fadd_rn(ox, __fmul_rn(dx, t_star)), __fadd_rn(oy, __fmul_rn(dy, t_star)),
                             __fadd_rn(oz, __fmul_rn(dz, t_star)));

  const bool jitter = seed != nullptr;
  const uint32_t s0 = jitter ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t s1 = jitter ? static_cast<uint32_t>(seed[1]) : 0u;
  const float res = static_cast<float>(r - 1);
  const float m0_min = static_cast<float>(1.3);

  int* out = k_idx + static_cast<long long>(ray) * n_steps;
  int k = 0;
  bool done = false;
  for (int s = 0; s < n_steps; ++s) {
    if (done) {  // finished rays emit nothing and stay where they are
      out[s] = -1;
      continue;
    }
    const int kk = min(k, n_samples - 1);
    const float t_lo = t_of_x(__fmul_rn(static_cast<float>(kk), step_x), rng, near);
    float t = t_lo;
    if (jitter) {
      const float delta = __fsub_rn(t_of_x(__fmul_rn(static_cast<float>(kk + 1), step_x), rng, near), t_lo);
      t = __fadd_rn(t_lo, __fmul_rn(hash_u01(s0, s1, static_cast<uint32_t>(ray), kk), delta));
    }
    const float px = __fadd_rn(ox, __fmul_rn(dx, t)), py = __fadd_rn(oy, __fmul_rn(dy, t)),
                pz = __fadd_rn(oz, __fmul_rn(dz, t));
    const float m = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
    const int ix = contracted_voxel(px, m, res), iy = contracted_voxel(py, m, res),
              iz = contracted_voxel(pz, m, res);
    const int g = __ldg(grid + (static_cast<long long>(ix) * r + iy) * r + iz);
    // active: k < n_samples, since done = k >= n_samples
    out[s] = g == 0 ? kk : -1;

    // the local Lipschitz certificate (core/skipmarch.py:skip_march_unbounded_plain)
    const float rho = __fmul_rn(__fsub_rn(static_cast<float>(g), 1.0f), w_c);
    const float n_eff = fmaxf(t < t_star ? n_perp : norm3(px, py, pz), 1.0f);
    const float m0 = fmaxf(__fmul_rn(n_eff, inv_sqrt3), m0_min);
    const float a = __fsub_rn(1.0f, __fdiv_rn(0.5f, m0)), b = __fsub_rn(1.0f, __fdiv_rn(1.0f, m0));
    const float f_m0 = __fdiv_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))), m0);
    const float l_inv = n_eff >= 2.25f ? fmaxf(__fdiv_rn(1.0f, f_m0), inv_lip) : inv_lip;
    const float t_safe = __fadd_rn(t_lo, fmaxf(__fmul_rn(__fsub_rn(rho, w_c), l_inv), 0.0f));
    const int k_safe = static_cast<int>(floorf(__fdiv_rn(fminf(x_of_t(t_safe, rng, near), x_last), step_x)));
    k += max(k_safe - kk, 1);
    done = k >= n_samples;
  }
  complete[ray] = done;
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

// rays_o, rays_d: [n_rays, 3] f32; grid: [r, r, r] int32; seed: two int64
// words holding uint32 values, or null (no jitter); k_idx: [n_rays, n_steps]
// int32; complete: [n_rays] bool.  All contiguous on one device.  step_x,
// range, near: the disparity grid; x_last = n_samples * step_x; w_c: the
// contracted voxel width; inv_sqrt3, inv_lip: f32 constants of the bound.
int tn_skip_march_unbounded(const void* rays_o, const void* rays_d, const void* grid, const void* seed,
                            int n_rays, int r, int n_samples, int n_steps, float step_x, float range,
                            float near, float x_last, float w_c, float inv_sqrt3, float inv_lip, void* k_idx,
                            void* complete, void* stream) {
  if (n_rays < 1 || r < 2 || n_samples < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  skip_march_unbounded_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d), static_cast<const int*>(grid),
      static_cast<const long long*>(seed), n_rays, r, n_samples, n_steps, step_x, range, near, x_last, w_c,
      inv_sqrt3, inv_lip, static_cast<int*>(k_idx), static_cast<bool*>(complete));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
