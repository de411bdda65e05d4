// Empty-space-skipping marches: per ray, the emitted sample indices k_idx
// [R, n_steps] (-1 = none) and the completeness flag [R].  Two marches, one
// per marcher: Aabb (below) and Unbounded (the Mip-360 disparity grid,
// further down), each a set of per-candidate functions that one kernel
// template walks (march_kernel, at the end).
//
// Replaces the lax.scan of tinynerf_tpu/core/skipmarch.py:skip_march (not a
// Pallas kernel: XLA fuses the scan body on the TPU; eager PyTorch would
// launch ~25 small ops per round).  Per round a ray computes the candidate
// sample's position, probes ONE value of the cone skip grid (the JAX
// _probe's lane trick is a plain gather here), then emits the sample or
// jumps over the certified-empty span.
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
// about the size of the L2) plus ~40 dependent f32 operations, four of them
// IEEE divisions; a 2048-ray serving chunk is 64 warps of one lane per ray.
// The kernel (march_kernel, at the end) runs several candidates of a ray
// at once and resolves the walk among them in registers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr long long kFillThreads = 65536;  // lanes_for: rays x lanes at which the march fills the card

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

// The jitter words (two int64 holding uint32 values) or none.
struct Jitter {
  bool on;
  uint32_t s0, s1;
  __device__ static Jitter load(const long long* seed) {
    if (seed == nullptr) return {false, 0u, 0u};
    return {true, static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1])};
  }
};

// Each march below gives the kernel template four things: its launch
// constants (Params), a ray's constants (ray), the end of a ray's walk
// (k_end: done once k >= k_end), and per candidate sample index kc < k_end
// the grid value to probe (site) and, from the probed value g, whether the
// round emits kc (emits) and the index it moves to (target: kc + the
// advance, at most k_end).  A candidate's values depend on kc alone, never
// on the rounds before it.

struct Aabb {
  struct Params {
    const float *rays_o, *rays_d, *t_min, *t_exit;
    const int* grid;
    const long long* seed;
    int r0, r1, r2, n_samples;
    float delta;
    float3 lo, hi, w;
  };
  struct Ray {
    float ox, oy, oz, dx, dy, dz, tm, rate;
    float3 ext, res;
    const int* g_dir;
    int k_end;
    uint32_t id;
    Jitter jit;
  };
  struct Site {
    const int* at;
    bool inbox;
  };

  __device__ static Ray ray(const Params& p, int r) {
    Ray q;
    q.id = static_cast<uint32_t>(r);
    q.ox = p.rays_o[3 * r], q.oy = p.rays_o[3 * r + 1], q.oz = p.rays_o[3 * r + 2];
    q.dx = p.rays_d[3 * r], q.dy = p.rays_d[3 * r + 1], q.dz = p.rays_d[3 * r + 2];
    // dominant axis by index rate |d_a| / w_a, the first maximum on ties
    const float ir0 = __fdiv_rn(fabsf(q.dx), p.w.x), ir1 = __fdiv_rn(fabsf(q.dy), p.w.y),
                ir2 = __fdiv_rn(fabsf(q.dz), p.w.z);
    int dom = 0;
    float ir = ir0;
    if (ir1 > ir) dom = 1, ir = ir1;
    if (ir2 > ir) dom = 2, ir = ir2;
    const float d_dom = dom == 0 ? q.dx : (dom == 1 ? q.dy : q.dz);
    const long long n_vox = static_cast<long long>(p.r0) * p.r1 * p.r2;
    q.g_dir = p.grid + (dom * 2 + (d_dom < 0.0f ? 1 : 0)) * n_vox;
    q.rate = __fmul_rn(p.delta, ir);
    q.tm = p.t_min[r];
    const float ke = __fadd_rn(floorf(__fdiv_rn(__fsub_rn(p.t_exit[r], q.tm), p.delta)), 2.0f);
    q.k_end = static_cast<int>(fminf(fmaxf(ke, 0.0f), static_cast<float>(p.n_samples)));
    q.jit = Jitter::load(p.seed);
    q.ext = make_float3(__fsub_rn(p.hi.x, p.lo.x), __fsub_rn(p.hi.y, p.lo.y), __fsub_rn(p.hi.z, p.lo.z));
    q.res = make_float3(static_cast<float>(p.r0 - 1), static_cast<float>(p.r1 - 1),
                        static_cast<float>(p.r2 - 1));
    return q;
  }

  __device__ static int k_end(const Params&, const Ray& q) { return q.k_end; }

  __device__ static Site site(const Params& p, const Ray& q, int kc) {
    const int kk = min(kc, p.n_samples - 1);
    float t = __fadd_rn(q.tm, __fmul_rn(static_cast<float>(kk), p.delta));
    if (q.jit.on) t = __fadd_rn(t, __fmul_rn(hash_u01(q.jit.s0, q.jit.s1, q.id, kk), p.delta));
    const float px = __fadd_rn(q.ox, __fmul_rn(q.dx, t)), py = __fadd_rn(q.oy, __fmul_rn(q.dy, t)),
                pz = __fadd_rn(q.oz, __fmul_rn(q.dz, t));
    const bool inbox = px >= p.lo.x && px <= p.hi.x && py >= p.lo.y && py <= p.hi.y && pz >= p.lo.z &&
                       pz <= p.hi.z;
    const int ix = voxel(px, p.lo.x, q.ext.x, q.res.x), iy = voxel(py, p.lo.y, q.ext.y, q.res.y),
              iz = voxel(pz, p.lo.z, q.ext.z, q.res.z);
    return {q.g_dir + (static_cast<long long>(ix) * p.r1 + iy) * p.r2 + iz, inbox};
  }

  __device__ static bool emits(const Site& s, int g) { return g == 0 && s.inbox; }

  __device__ static int target(const Params&, const Ray& q, const Site&, int kc, int g) {
    // skipped sample kc + i advances <= (i + 1) * rate + 1 axis slices, all
    // within the certified g - 1
    const int adv = static_cast<int>(floorf(__fdiv_rn(__fsub_rn(static_cast<float>(g), 2.0f), q.rate)));
    return kc + min(max(adv, 1), q.k_end - kc);
  }
};

// ---------------------------------------------------------------- unbounded
//
// Replaces the lax.scan of tinynerf_tpu/core/skipmarch.py:skip_march_unbounded
// (not a Pallas kernel either).  Per round a ray computes the candidate
// sample's t on the disparity grid, its jitter, position and Mip-360
// contraction, probes ONE int32 of the isotropic skip grid, emits on g == 0
// and advances by the local Lipschitz certificate.  The position side
// repeats the dense march's f32 operations in their order, each rounded on
// its own (the dense march's t comes from a numpy grid on the host):
//   x    = k * step_x;  f = x < 0.5 ? 2x : 1 / max(2 - 2x, 1e-9)
//   t_k  = f * range + near;  delta_k = t_{k+1} - t_k;  t = t_k + u * delta_k
//   p    = o + d * t;  m = max|p_a|;  c = m <= 1 ? p : ((2 - 1/max(m, 1e-12)) * p) / max(m, 1e-12)
//   voxel = clip(rint(((c / 2) + 1) * 0.5 * (r - 1)), 0, r - 1)
// The advance side (the radii, F(m0), x_of_t) need not match anything bit
// for bit, only stay conservative, but it repeats the plain version's
// operations too (__fsqrt_rn, __fdiv_rn), so that the kernel and the plain
// version give the same k_idx on the card.  A round is one 4-byte gather
// into the r^3 int32 grid (8 MB at r = 128, in L2) and ~100 f32 operations
// (four IEEE divisions, two square roots).

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

struct Unbounded {
  struct Params {
    const float *rays_o, *rays_d;
    const int* grid;
    const long long* seed;
    int r, n_samples;
    float step_x, rng, near, x_last, w_c, inv_sqrt3, inv_lip;
  };
  struct Ray {
    float ox, oy, oz, dx, dy, dz, t_star, n_perp;
    uint32_t id;
    Jitter jit;
  };
  struct Site {
    const int* at;
    float t_lo, t, px, py, pz;
  };

  __device__ static Ray ray(const Params& p, int r) {
    Ray q;
    q.id = static_cast<uint32_t>(r);
    q.ox = p.rays_o[3 * r], q.oy = p.rays_o[3 * r + 1], q.oz = p.rays_o[3 * r + 2];
    q.dx = p.rays_d[3 * r], q.dy = p.rays_d[3 * r + 1], q.dz = p.rays_d[3 * r + 2];
    // closest approach to the origin: t_star and the radius there
    q.t_star = -__fadd_rn(__fadd_rn(__fmul_rn(q.ox, q.dx), __fmul_rn(q.oy, q.dy)), __fmul_rn(q.oz, q.dz));
    q.n_perp = norm3(__fadd_rn(q.ox, __fmul_rn(q.dx, q.t_star)), __fadd_rn(q.oy, __fmul_rn(q.dy, q.t_star)),
                     __fadd_rn(q.oz, __fmul_rn(q.dz, q.t_star)));
    q.jit = Jitter::load(p.seed);
    return q;
  }

  __device__ static int k_end(const Params& p, const Ray&) { return p.n_samples; }

  __device__ static Site site(const Params& p, const Ray& q, int kc) {
    const int kk = min(kc, p.n_samples - 1);
    const float t_lo = t_of_x(__fmul_rn(static_cast<float>(kk), p.step_x), p.rng, p.near);
    float t = t_lo;
    if (q.jit.on) {
      const float delta = __fsub_rn(t_of_x(__fmul_rn(static_cast<float>(kk + 1), p.step_x), p.rng, p.near), t_lo);
      t = __fadd_rn(t_lo, __fmul_rn(hash_u01(q.jit.s0, q.jit.s1, q.id, kk), delta));
    }
    const float px = __fadd_rn(q.ox, __fmul_rn(q.dx, t)), py = __fadd_rn(q.oy, __fmul_rn(q.dy, t)),
                pz = __fadd_rn(q.oz, __fmul_rn(q.dz, t));
    const float m = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
    const float res = static_cast<float>(p.r - 1);
    const int ix = contracted_voxel(px, m, res), iy = contracted_voxel(py, m, res),
              iz = contracted_voxel(pz, m, res);
    return {p.grid + (static_cast<long long>(ix) * p.r + iy) * p.r + iz, t_lo, t, px, py, pz};
  }

  __device__ static bool emits(const Site&, int g) { return g == 0; }

  __device__ static int target(const Params& p, const Ray& q, const Site& s, int kc, int g) {
    // the local Lipschitz certificate (core/skipmarch.py:skip_march_unbounded_plain)
    const float rho = __fmul_rn(__fsub_rn(static_cast<float>(g), 1.0f), p.w_c);
    const float n_eff = fmaxf(s.t < q.t_star ? q.n_perp : norm3(s.px, s.py, s.pz), 1.0f);
    const float m0 = fmaxf(__fmul_rn(n_eff, p.inv_sqrt3), static_cast<float>(1.3));
    const float a = __fsub_rn(1.0f, __fdiv_rn(0.5f, m0)), b = __fsub_rn(1.0f, __fdiv_rn(1.0f, m0));
    const float f_m0 = __fdiv_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))), m0);
    const float l_inv = n_eff >= 2.25f ? fmaxf(__fdiv_rn(1.0f, f_m0), p.inv_lip) : p.inv_lip;
    const float t_safe = __fadd_rn(s.t_lo, fmaxf(__fmul_rn(__fsub_rn(rho, p.w_c), l_inv), 0.0f));
    const int k_safe =
        static_cast<int>(floorf(__fdiv_rn(fminf(x_of_t(t_safe, p.rng, p.near), p.x_last), p.step_x)));
    return kc + min(max(k_safe - kc, 1), p.n_samples - kc);  // kc < n_samples: kc is its own clamp
  }
};

// ------------------------------------------------------------------ kernel
//
// Several lanes per ray, probing the next candidates together.  A ray gets
// `lanes` lanes (a power of two up to 32, a sub-warp); its window is the
// candidates base .. base + lanes - 1, lane j computing candidate base + j
// in full: its t, position, voxel, gather and target.  Each round s is one
// resolved step, as in the one-thread-per-ray walk: the ray at k takes
// lane k - base's values with a shuffle, emits k or -1 and moves to that
// lane's target.  A target inside the window costs the next round no
// gather; one beyond it reloads the window there.  A run of unit steps
// through occupied space costs one gather per `lanes` rounds and a jump one,
// and the emitted rows equal the one-lane walk's round by round, since each
// candidate's values are the same f32 sequence.  The lanes of the card a
// 2048-ray serving chunk leaves idle (one lane per ray is 16 blocks on 132
// SMs) run the candidates ahead; a full card (131,072 rays) runs one lane.
//
// The rounds go to shared memory (a warp stages 1024 rounds: its 32 / lanes
// rays x 32 lanes rounds, a row padded by one word so that the rays' stores
// of a round meet distinct banks), and each chunk is written out row by row
// as coalesced 16-byte stores (4-byte stores where a row is not a multiple
// of 4 rounds).  A warp stops at the round in which its last ray finishes
// and fills its rows' remaining rounds with -1 in 16-byte stores.

constexpr int kWarps = kThreads / 32;
constexpr int kStaged = 1024;  // rounds a warp stages, over all its rays

// rows [row0, row0 + rows) of k_idx [n_rays, n_steps] from round s0: n_cols
// values each, from buf (row stride `stride`), or -1 where buf is null
__device__ __forceinline__ void store_rows(int* __restrict__ k_idx, const int* buf, int stride, int row0, int rows,
                                           int n_rays, int n_steps, int s0, int n_cols, bool vec, int lane) {
  rows = min(rows, n_rays - row0);
  if (vec) {  // n_steps and s0 are multiples of 4, k_idx on 16 bytes
    const int per_row = n_cols / 4;
    for (int i = lane; i < rows * per_row; i += 32) {
      const int row = i / per_row, c = 4 * (i - row * per_row);
      int4 v = make_int4(-1, -1, -1, -1);
      if (buf != nullptr) {
        const int* src = buf + row * stride + c;
        v = make_int4(src[0], src[1], src[2], src[3]);
      }
      *reinterpret_cast<int4*>(k_idx + static_cast<long long>(row0 + row) * n_steps + s0 + c) = v;
    }
  } else {
    for (int i = lane; i < rows * n_cols; i += 32) {
      const int row = i / n_cols, c = i - row * n_cols;
      k_idx[static_cast<long long>(row0 + row) * n_steps + s0 + c] = buf != nullptr ? buf[row * stride + c] : -1;
    }
  }
}

template <class M>
__global__ void __launch_bounds__(kThreads) march_kernel(const typename M::Params p, int lanes, int n_rays,
                                                         int n_steps, bool vec, int* __restrict__ k_idx,
                                                         bool* __restrict__ complete) {
  __shared__ int stage[kWarps][kStaged + 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kThreads + warp * 32) / lanes;  // the warp's first ray
  if (row0 >= n_rays) return;  // the whole warp
  const unsigned full = 0xFFFFFFFFu;
  const int rows = 32 / lanes, cols = kStaged / rows, stride = cols + 1;
  const int sub = lane / lanes, j = lane % lanes;  // the lane's ray in the warp, its place in the ray
  const int r = row0 + sub;
  const bool valid = r < n_rays;
  const typename M::Ray q = M::ray(p, valid ? r : row0);
  const int k_end = valid ? M::k_end(p, q) : 0;  // a lane past the last ray: done from the start
  int* buf = stage[warp];

  int k = 0, base = -lanes;  // the window [base, base + lanes): none yet
  bool done = k >= k_end;
  int cand = 0;  // lane j's candidate base + j: target * 2 + emits
  for (int s0 = 0; s0 < n_steps; s0 += cols) {
    const int n_cols = min(cols, n_steps - s0);
    int c = 0;
    for (; c < n_cols && !__all_sync(full, done); ++c) {
      if (!done && k - base >= lanes) {  // beyond the window: reload it at k
        base = k;
        const int kc = k + j;
        if (kc < k_end) {  // a candidate past the end is never reached
          const typename M::Site site = M::site(p, q, kc);
          const int g = __ldg(site.at);
          cand = M::target(p, q, site, kc, g) * 2 + (M::emits(site, g) ? 1 : 0);
        }
      }
      const int got = __shfl_sync(full, cand, done ? 0 : k - base, lanes);
      const int v = !done && (got & 1) ? k : -1;
      if (!done) k = got >> 1, done = k >= k_end;
      if (j == 0) buf[sub * stride + c] = v;
    }
    for (; c < n_cols; ++c)  // every ray of the warp has finished
      if (j == 0) buf[sub * stride + c] = -1;
    __syncwarp();
    store_rows(k_idx, buf, stride, row0, rows, n_rays, n_steps, s0, n_cols, vec, lane);
    __syncwarp();
    if (__all_sync(full, done)) {
      if (s0 + cols < n_steps)
        store_rows(k_idx, nullptr, 0, row0, rows, n_rays, n_steps, s0 + cols, n_steps - s0 - cols, vec, lane);
      break;
    }
  }
  if (valid && j == 0) complete[r] = done;
}

// Lanes per ray for a march of n_rays: enough that n_rays x lanes fills the
// card, one where the rays alone do (set by tools/walk_bound_torch.py's
// sweep, PERF.md section 6).
int lanes_for(int n_rays) {
  int lanes = 1;
  while (lanes < 32 && static_cast<long long>(n_rays) * lanes < kFillThreads) lanes *= 2;
  return lanes;
}

Aabb::Params aabb_params(const void* rays_o, const void* rays_d, const void* t_min, const void* t_exit,
                         const void* grid, const void* seed, int r0, int r1, int r2, int n_samples, float delta,
                         float lo_x, float lo_y, float lo_z, float hi_x, float hi_y, float hi_z, float w_x,
                         float w_y, float w_z) {
  return {static_cast<const float*>(rays_o), static_cast<const float*>(rays_d), static_cast<const float*>(t_min),
          static_cast<const float*>(t_exit), static_cast<const int*>(grid), static_cast<const long long*>(seed),
          r0, r1, r2, n_samples, delta, make_float3(lo_x, lo_y, lo_z), make_float3(hi_x, hi_y, hi_z),
          make_float3(w_x, w_y, w_z)};
}

Unbounded::Params unbounded_params(const void* rays_o, const void* rays_d, const void* grid, const void* seed,
                                   int r, int n_samples, float step_x, float range, float near, float x_last,
                                   float w_c, float inv_sqrt3, float inv_lip) {
  return {static_cast<const float*>(rays_o), static_cast<const float*>(rays_d), static_cast<const int*>(grid),
          static_cast<const long long*>(seed), r, n_samples, step_x, range, near, x_last, w_c, inv_sqrt3,
          inv_lip};
}

template <class M>
int launch_march(const typename M::Params& p, int lanes, int n_rays, int n_steps, void* k_idx, void* complete,
                 void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || p.n_samples >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n_steps % 4 == 0 && reinterpret_cast<uintptr_t>(k_idx) % 16 == 0;
  const long long threads = static_cast<long long>(n_rays) * lanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  march_kernel<M><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, lanes, n_rays, n_steps, vec, static_cast<int*>(k_idx), static_cast<bool*>(complete));
  return static_cast<int>(cudaGetLastError());
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
  return launch_march<Aabb>(aabb_params(rays_o, rays_d, t_min, t_exit, grid, seed, r0, r1, r2, n_samples, delta,
                                        lo_x, lo_y, lo_z, hi_x, hi_y, hi_z, w_x, w_y, w_z),
                            lanes_for(n_rays), n_rays, n_steps, k_idx, complete, stream);
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
  return launch_march<Unbounded>(unbounded_params(rays_o, rays_d, grid, seed, r, n_samples, step_x, range, near,
                                                  x_last, w_c, inv_sqrt3, inv_lip),
                                 lanes_for(n_rays), n_rays, n_steps, k_idx, complete, stream);
}

// The lanes per ray both marches take for n_rays rays.
int tn_skip_lanes(int n_rays) { return lanes_for(n_rays); }

}  // extern "C"
