// Probes, not part of the port's library: what a skip-march round costs on
// the card.  tools/walk_bound_torch.py builds and times them.
//
// tn_chase: the latency of one dependent 4-byte load.  One thread follows a
// random cycle through a buffer, one element per 32-byte sector, each
// load's address the value of the one before (ld.global.cg: cached in L2,
// not in L1, as a gather into a grid larger than L1 finds it).  A buffer
// that fits the 50 MB L2 gives an L2 hit's latency once warm; one far
// larger than the L2 gives a load from device memory.
//
// tn_probe_skip_march{,_unbounded}: a round's two halves apart, on the
// library's own per-candidate functions (csrc/skipmarch.cu), one thread per
// ray in blocks of 128 walking all its rounds, each row stored round by
// round as the one-thread-per-ray kernel did:
//   mode 0 records, per round and ray ([n_steps, n_rays], coalesced), the
//          grid value the round gathered and where (-1 once the ray is done);
//   mode 1 runs the round's arithmetic with the gather replaced by the
//          recorded value, loaded two rounds ahead (in a register when the
//          round needs it): the same walk, the same k_idx, no dependent load;
//   mode 2 runs the gathers alone: each round loads the recorded grid offset
//          plus 0 from the value before (a dependent chain), and stores.
// Mode 3 launches the library's march with `lanes` lanes per ray (a power
// of two up to 32) in place of its own pick (lanes_for): the sweep that
// chose that pick.

#include "../tinynerf_tpu_torch/csrc/skipmarch.cu"

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start, long long steps, int* __restrict__ end) {
  int i = start;
  for (long long s = 0; s < steps; ++s) i = __ldcg(next + i);
  *end = i;  // keeps the chain
}

template <class M>
__global__ void record_kernel(const typename M::Params p, int n_rays, int n_steps, int* __restrict__ rec_g,
                              int* __restrict__ rec_off) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const typename M::Ray q = M::ray(p, r);
  const int k_end = M::k_end(p, q);
  int k = 0;
  bool done = k >= k_end;
  for (int s = 0; s < n_steps; ++s) {
    const long long i = static_cast<long long>(s) * n_rays + r;
    if (done) {
      rec_g[i] = 0, rec_off[i] = -1;
      continue;
    }
    const typename M::Site site = M::site(p, q, k);
    const int g = __ldg(site.at);
    rec_g[i] = g, rec_off[i] = static_cast<int>(site.at - p.grid);
    k = M::target(p, q, site, k, g);
    done = k >= k_end;
  }
}

template <class M>
__global__ void arith_kernel(const typename M::Params p, int n_rays, int n_steps, const int* __restrict__ rec_g,
                             int* __restrict__ k_idx, bool* __restrict__ complete) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const typename M::Ray q = M::ray(p, r);
  const int k_end = M::k_end(p, q);
  int* out = k_idx + static_cast<long long>(r) * n_steps;
  auto rec = [&](int s) { return s < n_steps ? __ldcs(rec_g + static_cast<long long>(s) * n_rays + r) : 0; };
  int g0 = rec(0), g1 = rec(1);
  int k = 0;
  bool done = k >= k_end;
  for (int s = 0; s < n_steps; ++s) {
    int g = g0;
    g0 = g1, g1 = rec(s + 2);
    if (done) {
      out[s] = -1;
      continue;
    }
    const typename M::Site site = M::site(p, q, k);
    // keeps the site's arithmetic live and ahead of the advance, as the
    // gather did (the offset is far below 2^62: adds 0)
    g += static_cast<int>((site.at - p.grid) >> 62);
    out[s] = M::emits(site, g) ? k : -1;
    k = M::target(p, q, site, k, g);
    done = k >= k_end;
  }
  complete[r] = done;
}

__global__ void chain_kernel(const int* __restrict__ grid, int n_rays, int n_steps, const int* __restrict__ rec_off,
                             int* __restrict__ k_idx, bool* __restrict__ complete) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  int* out = k_idx + static_cast<long long>(r) * n_steps;
  auto rec = [&](int s) { return s < n_steps ? __ldcs(rec_off + static_cast<long long>(s) * n_rays + r) : -1; };
  int o0 = rec(0), o1 = rec(1);
  int g = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int off = o0;
    o0 = o1, o1 = rec(s + 2);
    if (off < 0) {
      out[s] = -1;
      continue;
    }
    g = __ldg(grid + off + (g >> 31));  // g >= 0: the value before feeds the address
    out[s] = g == 0 ? s : -1;
  }
  complete[r] = g == 0;
}

template <class M>
int probe(int mode, int lanes, const typename M::Params& p, int n_rays, int n_steps, void* k_idx, void* complete,
          void* rec_g, void* rec_off, void* stream) {
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* const out = static_cast<int*>(k_idx);
  bool* const done = static_cast<bool*>(complete);
  if (mode == 0) {
    record_kernel<M><<<blocks, kThreads, 0, st>>>(p, n_rays, n_steps, static_cast<int*>(rec_g),
                                                  static_cast<int*>(rec_off));
  } else if (mode == 1) {
    arith_kernel<M><<<blocks, kThreads, 0, st>>>(p, n_rays, n_steps, static_cast<const int*>(rec_g), out, done);
  } else if (mode == 2) {
    chain_kernel<<<blocks, kThreads, 0, st>>>(p.grid, n_rays, n_steps, static_cast<const int*>(rec_off), out, done);
  } else if (mode == 3) {
    return launch_march<M>(p, lanes, n_rays, n_steps, k_idx, complete, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// next: the cycle (next[i] is the element after i); steps dependent loads
// from `start`, the last index written to end[0].
int tn_chase(const void* next, int start, long long steps, void* end, void* stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(next), start, steps,
                                                             static_cast<int*>(end));
  return static_cast<int>(cudaGetLastError());
}

// mode, lanes (mode 3), then tn_skip_march's arguments, then the records
// rec_g, rec_off: [n_steps, n_rays] int32 each.
int tn_probe_skip_march(int mode, int lanes, const void* rays_o, const void* rays_d, const void* t_min,
                        const void* t_exit, const void* grid, const void* seed, int n_rays, int r0, int r1, int r2,
                        int n_samples, float delta, int n_steps, float lo_x, float lo_y, float lo_z, float hi_x,
                        float hi_y, float hi_z, float w_x, float w_y, float w_z, void* k_idx, void* complete,
                        void* rec_g, void* rec_off, void* stream) {
  if (n_rays < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  return probe<Aabb>(mode, lanes,
                     aabb_params(rays_o, rays_d, t_min, t_exit, grid, seed, r0, r1, r2, n_samples, delta, lo_x,
                                 lo_y, lo_z, hi_x, hi_y, hi_z, w_x, w_y, w_z),
                     n_rays, n_steps, k_idx, complete, rec_g, rec_off, stream);
}

// mode, lanes (mode 3), then tn_skip_march_unbounded's arguments, then the
// records rec_g, rec_off: [n_steps, n_rays] int32 each.
int tn_probe_skip_march_unbounded(int mode, int lanes, const void* rays_o, const void* rays_d, const void* grid,
                                  const void* seed, int n_rays, int r, int n_samples, int n_steps, float step_x,
                                  float range, float near, float x_last, float w_c, float inv_sqrt3, float inv_lip,
                                  void* k_idx, void* complete, void* rec_g, void* rec_off, void* stream) {
  if (n_rays < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  return probe<Unbounded>(mode, lanes,
                          unbounded_params(rays_o, rays_d, grid, seed, r, n_samples, step_x, range, near, x_last,
                                           w_c, inv_sqrt3, inv_lip),
                          n_rays, n_steps, k_idx, complete, rec_g, rec_off, stream);
}

}  // extern "C"
