// Empty-space-skipping marches: per ray, the emitted sample indices k_idx
// [R, n_steps] (-1 = none) and the completeness flag [R].  Two marches, one
// per marcher: Aabb (below) and Unbounded (the Mip-360 disparity grid,
// further down), each a set of per-candidate functions that one kernel
// template walks (march_kernel); and the cone skip grid that the Aabb march
// reads, built in one launch (skip_grid_kernel, at the end).
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

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

// ------------------------------------------------------------- cone grid
// The cone skip grid the AABB march reads (core/skipmarch.py make_skip_grid;
// the JAX package's six lax.scan sweeps, tinynerf_tpu/core/skipmarch.py:92
// _cone_sweep), in one launch where the eager slice loop took ~3,570 small
// ones a 128^3 build.  Each (axis, sign) direction walks that axis's slices
// in sweep order (+axis from the far end down, -axis from 0 up) and carries
// a plane of minima from slice to slice.  Per slice and voxel v of the plane:
//   carry(v) = 0 where the occupancy dilated by +-2 along both lateral axes
//              is set, else min(3x3 lateral neighbours of the previous
//              slice's carry, outside the plane INF) + 1
//   out(v)   = 0 where v is occupied, else clamp(carry(v), 1, 127)
//
// What bounds it on an H100: not bytes (2.1 MB read and 50.3 MB written at
// 128^3, 0.016 ms at 3.35 TB/s) but the chain of dependent slices, and what
// one SM can move: a first design, one block a direction, took 1.16 ms, each
// SM writing its 8 MB at ~12 bytes a cycle (PERF.md section 6).  So:
//   - a cluster of kGridCluster blocks takes a direction, each block a band
//     of rows of the plane; at each slice a block pushes its edge rows of the
//     new carry into its neighbours' planes (distributed shared memory), and
//     the cluster's barrier is the slice's only synchronisation;
//   - the carry is a byte saturating at 128: min and +1 are monotone, so it
//     sweeps to min(plain carry, 128), and the output clamps at 127: bit-equal;
//   - a thread takes 16 voxels of a row as four words, the minima and the +1
//     four bytes at a time (__vminu4, __vaddus4);
//   - the occupancy of the band and two rows each side is staged kGridChunk
//     slices at a time as rows of 32-bit words, so a slice's dilation is 15
//     word loads and shifts.
// The grid is written in its final layout [6, r0, r1, r2]: on axes 0 and 1
// a slice's rows are runs of the output (16-byte stores); axis 2's slices
// are strided columns, staged kGridChunk deep and written as whole runs.

constexpr int kGridCluster = 8;  // blocks a direction
constexpr int kGridThreads = 512;
constexpr int kGridChunk = 32;           // slices staged at once: occupancy bits, and axis 2's output
constexpr uint32_t kSat4 = 0x80808080u;  // four carries at 128, which stands for the plain version's INF
// the launch's vector flags: rows of the occupancy 4-byte aligned (axes 0,
// 1), its columns 16-byte aligned (axis 2), the output's rows 16-byte aligned
constexpr int kVecRowsIn = 1, kVecColsIn = 2, kVecOut = 4;

// A direction's view of the grid: its axis's slices (ra), each slice's rows
// (rb) and columns (rc), the other two axes in order, and the strides of the
// three in the occupancy and in one output grid (both [r0, r1, r2]); a block
// of its cluster takes `rows` of the rows.
struct SweepShape {
  int ra, rb, rc;
  long long ss, sp, sq;
  int rows;   // a block's band
  int cols;   // rc rounded up to a thread's strip of 16
  int words;  // 32-bit words of a row of occupancy bits
  int width;  // bytes of a carry row: cols and 16 of padding each side
  __host__ __device__ SweepShape(int axis, int r0, int r1, int r2) {
    const long long plane = static_cast<long long>(r1) * r2;
    ra = axis == 0 ? r0 : (axis == 1 ? r1 : r2);
    rb = axis == 0 ? r1 : r0;
    rc = axis == 2 ? r1 : r2;
    ss = axis == 0 ? plane : (axis == 1 ? r2 : 1);
    sp = axis == 0 ? r2 : plane;
    sq = axis == 2 ? r2 : 1;
    rows = (rb + kGridCluster - 1) / kGridCluster;
    cols = (rc + 15) / 16 * 16;
    words = (rc + 31) / 32;
    width = cols + 32;
  }
  // two carry planes of the band and a row each side, the staged bits of the
  // band and two rows each side, and axis 2's staged output
  __host__ __device__ long long carry_bytes() const { return static_cast<long long>(rows + 2) * width; }
  __host__ __device__ long long bits_bytes() const { return 4LL * kGridChunk * (rows + 4) * words; }
  __host__ __device__ long long stage_bytes() const { return static_cast<long long>(kGridChunk) * rows * cols; }
};

long long skip_grid_smem(int r0, int r1, int r2) {
  long long most = 0;
  for (int axis = 0; axis < 3; ++axis) {
    const SweepShape g(axis, r0, r1, r2);
    const long long need = 2 * g.carry_bytes() + g.bits_bytes() + (axis == 2 ? g.stage_bytes() : 0);
    most = need > most ? need : most;
  }
  return most;
}

// bit i of nib -> byte i all ones
__device__ __forceinline__ uint32_t byte_mask(uint32_t nib) { return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu; }

// bits[t][r][w] bit l = the occupancy at slice s0 + t, row pb + r, column
// 32 w + l, for r < rows + 4 (0 outside the grid, past rc and past n_t).
// Rows of the occupancy (axes 0 and 1): a warp reads 128 columns of a
// (slice, row), 4 a lane, and ORs the lanes' nibbles into words with
// shuffles, eight (slice, row)s loaded at once.  Columns (axis 2, whose
// slices are contiguous): a lane reads a column's n_t bytes, and a ballot a
// slice makes the words.
__device__ void stage_bits(const uint8_t* __restrict__ occ, const SweepShape& g, int s0, int n_t, int pb,
                           int vec, uint32_t* bits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5, n_r = g.rows + 4;
  if (g.sq == 1) {
    constexpr int kBatch = 8;
    const int groups = (g.rc + 127) / 128, tasks = n_t * n_r * groups;
    for (int base = warp * kBatch; base < tasks; base += n_warps * kBatch) {
      uint32_t x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int task = base + j, grp = task % groups, r = task / groups % n_r, t = task / groups / n_r;
        const int p = pb + r, q = grp * 128 + 4 * lane;
        x[j] = 0;
        if (task < tasks && p >= 0 && p < g.rb && q < g.rc) {
          const uint8_t* src = occ + (s0 + t) * g.ss + p * g.sp + q;
          if (vec & kVecRowsIn) {
            x[j] = __ldg(reinterpret_cast<const uint32_t*>(src));
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (q + i < g.rc) x[j] |= static_cast<uint32_t>(__ldg(src + i)) << (8 * i);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int task = base + j;  // the same in every lane
        if (task >= tasks) break;
        const uint32_t nib = ((__vcmpne4(x[j], 0u) & 0x01010101u) * 0x01020408u) >> 24;
        uint32_t word = nib << (4 * (lane & 7));
        word |= __shfl_xor_sync(0xFFFFFFFFu, word, 1);
        word |= __shfl_xor_sync(0xFFFFFFFFu, word, 2);
        word |= __shfl_xor_sync(0xFFFFFFFFu, word, 4);
        const int grp = task % groups, r = task / groups % n_r, t = task / groups / n_r, w = grp * 4 + (lane >> 3);
        if ((lane & 7) == 0 && w < g.words) bits[(t * n_r + r) * g.words + w] = word;
      }
    }
  } else {
    const int tasks = n_r * g.words;
    for (int task = warp; task < tasks; task += n_warps) {
      const int r = task / g.words, w = task - r * g.words, p = pb + r, q = w * 32 + lane;
      uint32_t x[kGridChunk / 4] = {};
      if (p >= 0 && p < g.rb && q < g.rc) {
        const uint8_t* src = occ + p * g.sp + q * g.sq + s0;
        if ((vec & kVecColsIn) && n_t % 16 == 0) {
#pragma unroll
          for (int k = 0; k < kGridChunk / 16; ++k)
            if (16 * k < n_t) {
              const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + k);
              x[4 * k] = v.x, x[4 * k + 1] = v.y, x[4 * k + 2] = v.z, x[4 * k + 3] = v.w;
            }
        } else {
#pragma unroll
          for (int t = 0; t < kGridChunk; ++t)
            if (t < n_t) x[t >> 2] |= static_cast<uint32_t>(__ldg(src + t)) << (8 * (t & 3));
        }
      }
      uint32_t mine = 0;
#pragma unroll
      for (int t = 0; t < kGridChunk; ++t) {
        const uint32_t word = __ballot_sync(0xFFFFFFFFu, (x[t >> 2] >> (8 * (t & 3))) & 0xFFu);
        if (lane == t) mine = word;
      }
      if (lane < n_t) bits[(lane * n_r + r) * g.words + w] = mine;
    }
  }
}

// One slice of the sweep for the strip of 16 columns q0 .. q0 + 15 of row p
// (the block's carry row pl): the new carry from `cur` into `nxt` and
// `carry` (columns past rc stay 128), and the output bytes (byte i of word
// j: column q0 + 4 j + i).  `bits_t`: the slice's staged rows, from row pb.
__device__ __forceinline__ uint4 sweep_strip(const SweepShape& g, const uint32_t* bits_t, int pb, const uint8_t* cur,
                                             uint8_t* nxt, int p, int pl, int q0, uint4& carry) {
  // the occupancy dilated by +-2 rows (OR of rows p - 2 .. p + 2) and +-2
  // columns (shifts, across the neighbouring words), and the occupancy
  const int w = q0 >> 5, o = q0 & 16;
  uint32_t x = 0, xl = 0, xr = 0;
  for (int r = max(p - 2, 0); r <= min(p + 2, g.rb - 1); ++r) {
    const uint32_t* row = bits_t + (r - pb) * g.words;
    x |= row[w];
    if (w > 0) xl |= row[w - 1];
    if (w + 1 < g.words) xr |= row[w + 1];
  }
  const uint32_t dil = (x | x << 1 | x << 2 | x >> 1 | x >> 2 | xl >> 30 | xl >> 31 | xr << 30 | xr << 31) >> o;
  const uint32_t occ16 = bits_t[(p - pb) * g.words + w] >> o;
  // the previous carry's minimum over rows p - 1 .. p + 1, for the 16
  // columns and the one each side (bytes 3 of ml and 0 of mr), then along
  // the row
  const uint8_t* at = cur + pl * g.width + 16 + q0;
  uint4 m = *reinterpret_cast<const uint4*>(at);
  uint32_t ml = *reinterpret_cast<const uint32_t*>(at - 4), mr = *reinterpret_cast<const uint32_t*>(at + 16);
#pragma unroll
  for (int d = -1; d <= 1; d += 2) {
    const uint8_t* a = at + d * g.width;
    const uint4 n = *reinterpret_cast<const uint4*>(a);
    m = make_uint4(__vminu4(m.x, n.x), __vminu4(m.y, n.y), __vminu4(m.z, n.z), __vminu4(m.w, n.w));
    ml = __vminu4(ml, *reinterpret_cast<const uint32_t*>(a - 4));
    mr = __vminu4(mr, *reinterpret_cast<const uint32_t*>(a + 16));
  }
  const uint32_t c[6] = {ml, m.x, m.y, m.z, m.w, mr};
  const int n_in = min(16, g.rc - q0);
  const uint32_t past = n_in < 16 ? 0xFFFFu << n_in : 0u;
  uint32_t cw[4], out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t left = __byte_perm(c[j], c[j + 1], 0x6543), right = __byte_perm(c[j + 1], c[j + 2], 0x4321);
    const uint32_t ahead = __vminu4(__vaddus4(__vminu4(__vminu4(left, c[j + 1]), right), 0x01010101u), kSat4);
    const uint32_t beyond = byte_mask((past >> (4 * j)) & 0xFu);
    cw[j] = (ahead & ~byte_mask((dil >> (4 * j)) & 0xFu) & ~beyond) | (kSat4 & beyond);
    out[j] = __vminu4(__vmaxu4(cw[j], 0x01010101u), 0x7F7F7F7Fu) & ~byte_mask((occ16 >> (4 * j)) & 0xFu);
  }
  carry = make_uint4(cw[0], cw[1], cw[2], cw[3]);
  *reinterpret_cast<uint4*>(nxt + pl * g.width + 16 + q0) = carry;
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ int4 widen(uint32_t w) {
  return make_int4(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, w >> 24);
}

// The first n of a strip's 16 output bytes as int32 at dst (a row of the
// grid): four 16-byte stores where whole and aligned.
__device__ __forceinline__ void store_row(int* dst, uint4 o, int n, bool vec) {
  if (vec && n == 16) {
    int4* d = reinterpret_cast<int4*>(dst);
    d[0] = widen(o.x), d[1] = widen(o.y), d[2] = widen(o.z), d[3] = widen(o.w);
    return;
  }
  const uint32_t w[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) dst[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
}

// Axis 2's staged slices s0 .. s0 + n_t - 1 of rows p0 .. p1 - 1 into the
// grid, where the slices are the innermost axis: a thread a voxel, its n_t
// values contiguous (16-byte stores where aligned: whole lines at 32).
__device__ void write_columns(const uint8_t* stage, const SweepShape& g, int p0, int p1, int s0, int n_t, bool vec,
                              int* grid) {
  const int plane = g.rows * g.cols;
  for (int v = threadIdx.x; v < (p1 - p0) * g.rc; v += blockDim.x) {
    const int pr = v / g.rc, q = v - pr * g.rc;
    const uint8_t* src = stage + pr * g.cols + q;
    int* dst = grid + (p0 + pr) * g.sp + q * g.sq + s0;
    if (vec) {
      for (int t = 0; t < n_t; t += 4)
        *reinterpret_cast<int4*>(dst + t) = make_int4(src[t * plane], src[(t + 1) * plane], src[(t + 2) * plane],
                                                      src[(t + 3) * plane]);
    } else {
      for (int t = 0; t < n_t; ++t) dst[t] = src[t * plane];
    }
  }
}

// Blocks: 6 clusters (the directions +x, -x, +y, -y, +z, -z) of
// kGridCluster blocks, block `rank` of a cluster taking rows [rank * rows,
// (rank + 1) * rows).
__global__ void __cluster_dims__(kGridCluster, 1, 1) __launch_bounds__(kGridThreads)
    skip_grid_kernel(const uint8_t* __restrict__ occ, int r0, int r1, int r2, int vec, int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t sweep_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), dir = blockIdx.x / kGridCluster, axis = dir >> 1;
  const bool down = (dir & 1) == 0;
  const SweepShape g(axis, r0, r1, r2);
  const int p0 = min(rank * g.rows, g.rb), p1 = min(p0 + g.rows, g.rb);
  uint8_t* cur = sweep_smem;
  uint8_t* nxt = sweep_smem + g.carry_bytes();
  uint32_t* bits = reinterpret_cast<uint32_t*>(sweep_smem + 2 * g.carry_bytes());
  uint8_t* stage = sweep_smem + 2 * g.carry_bytes() + g.bits_bytes();
  int* grid = out + static_cast<long long>(dir) * r0 * r1 * r2;

  for (int i = threadIdx.x; i < 2 * g.carry_bytes() / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(sweep_smem)[i] = kSat4;  // outside the plane, and before the first slice
  cluster.sync();  // every block filled before any pushes into it
  const int per_row = g.cols / 16, n_strips = (p1 - p0) * per_row;
  const int n_chunks = (g.ra + kGridChunk - 1) / kGridChunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = (down ? n_chunks - 1 - ci : ci) * kGridChunk, n_t = min(kGridChunk, g.ra - s0);
    stage_bits(occ, g, s0, n_t, p0 - 2, vec, bits);
    __syncthreads();
    for (int i = 0; i < n_t; ++i) {
      const int t = down ? n_t - 1 - i : i;
      for (int st = threadIdx.x; st < n_strips; st += blockDim.x) {
        const int pr = st / per_row, p = p0 + pr, q0 = (st - pr * per_row) * 16;
        uint4 carry;
        const uint4 o = sweep_strip(g, bits + t * (g.rows + 4) * g.words, p0 - 2, cur, nxt, p, pr + 1, q0, carry);
        // the band's edge rows into the neighbours' planes: the row after
        // the band above, the row before the band below
        if (pr == 0 && rank > 0)
          *cluster.map_shared_rank(reinterpret_cast<uint4*>(nxt + (g.rows + 1) * g.width + 16 + q0), rank - 1) = carry;
        if (p == p1 - 1 && p1 < g.rb)
          *cluster.map_shared_rank(reinterpret_cast<uint4*>(nxt + 16 + q0), rank + 1) = carry;
        if (axis == 2)
          *reinterpret_cast<uint4*>(stage + (t * g.rows + pr) * g.cols + q0) = o;
        else
          store_row(grid + (s0 + t) * g.ss + p * g.sp + q0, o, min(16, g.rc - q0), vec & kVecOut);
      }
      cluster.sync();
      uint8_t* done = cur;
      cur = nxt, nxt = done;
    }
    if (axis == 2) write_columns(stage, g, p0, p1, s0, n_t, vec & kVecOut, grid);
  }
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

// The shared memory a block may opt in to on the current device, or minus
// the CUDA error.
int tn_smem_optin() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// The shared memory a block of tn_skip_grid takes for an [r0, r1, r2] grid
// (at most INT_MAX).
int tn_skip_grid_smem(int r0, int r1, int r2) {
  const long long need = skip_grid_smem(r0, r1, r2);
  return need > 0x7FFFFFFFLL ? 0x7FFFFFFF : static_cast<int>(need);
}

// occ: [r0, r1, r2] bool (a byte a voxel); out: [6, r0, r1, r2] int32, the
// cone grids of the directions (+x, -x, +y, -y, +z, -z).  Both contiguous on
// one device.  Refused (cudaErrorInvalidValue) where a block's planes do not
// fit its shared memory.
int tn_skip_grid(const void* occ, int r0, int r1, int r2, void* out, void* stream) {
  if (r0 < 1 || r1 < 1 || r2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = skip_grid_smem(r0, r1, r2);
  const int limit = tn_smem_optin();
  if (limit < 0) return -limit;
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(skip_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t o = reinterpret_cast<uintptr_t>(occ), d = reinterpret_cast<uintptr_t>(out);
  const int vec = (r2 % 4 == 0 && o % 4 == 0 ? kVecRowsIn : 0) | (r2 % 16 == 0 && o % 16 == 0 ? kVecColsIn : 0) |
                  (r2 % 4 == 0 && d % 16 == 0 ? kVecOut : 0);
  skip_grid_kernel<<<6 * kGridCluster, kGridThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), r0, r1, r2, vec, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
