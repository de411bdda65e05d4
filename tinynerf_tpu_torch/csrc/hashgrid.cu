// Instant-NGP's multiresolution hash encoding (arXiv:2201.05989, section 3):
// the lookup of the kept samples over every level, and the table gradient
// summed per row in a fixed order.  The JAX package has no such field; the
// plain versions of every kernel here are in ops/hashgrid.py, and each
// kernel gives their bits.
//
// Levels (struct Levels, copied into each launch's parameters): level l has
// resolution N_l and starts at row offset_l of one flat table of rows of two
// features.  A dense level holds its (N_l + 1)^3 vertices at row
// (x (N_l + 1) + y) (N_l + 1) + z; a hashed level T = mask + 1 rows at
// (x ^ y * 2654435761 ^ z * 805459861) & mask, uint32 arithmetic.  A sample
// p in [-1, 1]^3 sits at vertex coordinate ((p + 1) * 0.5) * N_l clamped to
// [0, N_l], its cell origin the floor clipped to [0, N_l - 1]; corners in
// CORNERS_3D order (dx slowest), weight (wx wy) wz.  Every f32 operation is
// written with an _rn intrinsic, so nothing is contracted into an FMA and
// the CPU's plain version gives the same bits.
//
// What bounds them on an H100.  At the training shape (819,200 samples, 16
// levels, 6,098,925 rows):
//   * hash_encode_kernel reads 9.8 MB of positions and 24.4 MB of bf16
//     table and writes 105 MB of features: 0.042 ms at 3.35 TB/s.  Its real
//     cost is 105M gathers of one 4-byte row each; the bf16 table fits the
//     50 MB L2, so they are L2 hits in 32-byte sectors.  A thread per
//     (sample, level): a warp's 32 threads are two samples' 16 levels, so
//     the positions are read by broadcast and the features written as one
//     contiguous 256-byte run per warp.
//   * hash_terms_kernel: a thread per (sample, level) writes its 8 terms,
//     sort key (the row), value (the term's index) and product w * g,
//     contiguously (two 16-byte stores of keys, of values, four of
//     products).  Terms of a (sample, level) whose cotangent is all zero get
//     the key `sentinel` (the row count), so they sort last and are dropped.
//   * the hash_group kernels then group the terms by row, each row's in
//     term order: the order a stable sort by key gives (note below);
//   * hash_accumulate_kernel: a thread per chunk of kChunk sorted terms
//     loads their keys and values with 16-byte loads, gathers the products
//     of the live ones (kChunk independent 8-byte loads in flight), and sums
//     each run of equal keys in order from 0.  A run that starts and ends in
//     the chunk is stored into the output.  A chunk's leading run that
//     continues the previous chunk's key is stored as its head partial; a
//     last run that the chunk owns and that continues into the next chunk
//     is stored as its tail partial with its key.
//     hash_accumulate_combine_kernel: each owner of a tail adds the heads of
//     the following chunks in chunk order, as far as the key runs, and
//     stores the row.  No float atomics; the result does not depend on the
//     order in which blocks run.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kChunk = 16;  // ops/hashgrid.py ACC_CHUNK
constexpr unsigned kPrimeY = 2654435761u, kPrimeZ = 805459861u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;

struct Levels {
  int n;
  unsigned mask;  // T - 1
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int hashed[kMaxLevels];
};

// levels_host: [L, T - 1, N_l (L), offset_l (L), hashed_l (L)] int32.
bool make_levels(const int* host, Levels* out) {
  if (host == nullptr || host[0] < 1 || host[0] > kMaxLevels) return false;
  out->n = host[0];
  out->mask = static_cast<unsigned>(host[1]);
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool in = l < out->n;
    out->res[l] = in ? host[2 + l] : 1;
    out->offset[l] = in ? host[2 + out->n + l] : 0;
    out->hashed[l] = in ? host[2 + 2 * out->n + l] : 0;
  }
  return true;
}

__device__ __forceinline__ void axis(float p, float fres, int& o, float& t) {
  const float v = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(p, 1.0f), 0.5f), fres), 0.0f), fres);
  const float f = fminf(fmaxf(floorf(v), 0.0f), __fsub_rn(fres, 1.0f));
  o = static_cast<int>(f);
  t = __fsub_rn(v, f);
}

// Rows and weights of level l's 8 corners at the sample (px, py, pz).
__device__ __forceinline__ void corners(float px, float py, float pz, const Levels& lv, int l, int* row,
                                        float* w) {
  const int res = lv.res[l];
  const float fres = static_cast<float>(res);
  int ox, oy, oz;
  float tx, ty, tz;
  axis(px, fres, ox, tx);
  axis(py, fres, oy, ty);
  axis(pz, fres, oz, tz);
  const float wx[2] = {__fsub_rn(1.0f, tx), tx};
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};
  const float wz[2] = {__fsub_rn(1.0f, tz), tz};
  const bool hashed = lv.hashed[l] != 0;
  const unsigned r1 = static_cast<unsigned>(res) + 1u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
    w[c] = __fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]);
    const unsigned ix = static_cast<unsigned>(ox + dx);
    const unsigned iy = static_cast<unsigned>(oy + dy);
    const unsigned iz = static_cast<unsigned>(oz + dz);
    const unsigned local = hashed ? ((ix ^ (iy * kPrimeY) ^ (iz * kPrimeZ)) & lv.mask) : (ix * r1 + iy) * r1 + iz;
    row[c] = lv.offset[l] + static_cast<int>(local);
  }
}

__device__ __forceinline__ float lo_bf16(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// pos [n, 3] f32, table [rows] bf16 pairs (as uint32), out [n, L] float2.
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const float* __restrict__ pos, const unsigned* __restrict__ table, Levels lv, int n,
                   float2* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * lv.n) return;
  const int i = static_cast<int>(t / lv.n), l = static_cast<int>(t - static_cast<long long>(i) * lv.n);
  int row[8];
  float w[8];
  corners(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], lv, l, row, w);
  unsigned v[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __ldg(table + row[c]);
  float a0 = __fmul_rn(lo_bf16(v[0]), w[0]), a1 = __fmul_rn(hi_bf16(v[0]), w[0]);
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    a0 = __fadd_rn(a0, __fmul_rn(lo_bf16(v[c]), w[c]));
    a1 = __fadd_rn(a1, __fmul_rn(hi_bf16(v[c]), w[c]));
  }
  out[t] = make_float2(a0, a1);
}

// g [n, L] float2; keys, vals [n L 8] int32, prods [n L 8] float2, term
// (i L + l) 8 + c.
__global__ void __launch_bounds__(kThreads)
hash_terms_kernel(const float* __restrict__ pos, const float2* __restrict__ g, Levels lv, int n, int sentinel,
                  int* __restrict__ keys, int* __restrict__ vals, float2* __restrict__ prods) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * lv.n) return;
  const int i = static_cast<int>(t / lv.n), l = static_cast<int>(t - static_cast<long long>(i) * lv.n);
  int row[8];
  float w[8];
  corners(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], lv, l, row, w);
  const float2 gl = g[t];
  const bool zero = gl.x == 0.0f && gl.y == 0.0f;
  const int base = static_cast<int>(t * 8);
  int4* k4 = reinterpret_cast<int4*>(keys + base);
  int4* v4 = reinterpret_cast<int4*>(vals + base);
  float4* p4 = reinterpret_cast<float4*>(prods + base);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 4 * h;
    k4[h] = zero ? make_int4(sentinel, sentinel, sentinel, sentinel)
                 : make_int4(row[c], row[c + 1], row[c + 2], row[c + 3]);
    v4[h] = make_int4(base + c, base + c + 1, base + c + 2, base + c + 3);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 2 * q;
    p4[q] = make_float4(__fmul_rn(w[c], gl.x), __fmul_rn(w[c], gl.y), __fmul_rn(w[c + 1], gl.x),
                        __fmul_rn(w[c + 1], gl.y));
  }
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// keys, vals [n_terms] sorted by key; prods [n_terms] float2 in term order;
// head, tail [chunks] float2, tail_key [chunks]; out [n_rows] float2, zeroed.
__global__ void __launch_bounds__(kThreads)
hash_accumulate_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                       const float2* __restrict__ prods, long long n_terms, int n_rows, float2* __restrict__ head,
                       float2* __restrict__ tail, int* __restrict__ tail_key, float2* __restrict__ out) {
  const long long chunk = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long begin = chunk * kChunk;
  if (begin >= n_terms) return;
  const int count = n_terms - begin < kChunk ? static_cast<int>(n_terms - begin) : kChunk;
  int k[kChunk], v[kChunk];
  if (count == kChunk) {
    const int4* k4 = reinterpret_cast<const int4*>(keys + begin);
    const int4* v4 = reinterpret_cast<const int4*>(vals + begin);
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const int4 a = k4[q], b = v4[q];
      k[4 * q] = a.x, k[4 * q + 1] = a.y, k[4 * q + 2] = a.z, k[4 * q + 3] = a.w;
      v[4 * q] = b.x, v[4 * q + 1] = b.y, v[4 * q + 2] = b.z, v[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      k[j] = j < count ? keys[begin + j] : n_rows;
      v[j] = j < count ? vals[begin + j] : 0;
    }
  }
  float2 p[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) p[j] = (j < count && k[j] < n_rows) ? prods[v[j]] : make_float2(0.0f, 0.0f);
  const int prev_key = begin > 0 ? keys[begin - 1] : -1;
  const int next_key = begin + count < n_terms ? keys[begin + count] : -1;

  float2 head_sum = make_float2(0.0f, 0.0f);
  int own_key = -1;
  float2 acc = make_float2(0.0f, 0.0f);
  int cur = k[0];
  bool first_run = true;
#pragma unroll
  for (int j = 0; j <= kChunk; ++j) {
    const bool ends = j == count || (j < count && k[j] != cur);
    if (j <= count && ends) {
      // the run [.., j) of key cur is complete in this chunk
      const bool continued = first_run && cur == prev_key;
      const bool continues = j == count && cur == next_key;
      if (continued) {
        head_sum = acc;
      } else if (cur < n_rows) {
        if (continues) {
          own_key = cur;
          tail[chunk] = acc;
        } else {
          out[cur] = acc;
        }
      }
      first_run = false;
      if (j < count) {
        cur = k[j];
        acc = make_float2(0.0f, 0.0f);
      }
    }
    if (j < count) acc = add2(acc, p[j]);
  }
  head[chunk] = head_sum;
  tail_key[chunk] = own_key;
}

__global__ void __launch_bounds__(kThreads)
hash_accumulate_combine_kernel(const int* __restrict__ keys, long long n_terms, long long chunks,
                               const float2* __restrict__ head, const float2* __restrict__ tail,
                               const int* __restrict__ tail_key, float2* __restrict__ out) {
  const long long chunk = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (chunk >= chunks) return;
  const int key = tail_key[chunk];
  if (key < 0) return;
  float2 acc = tail[chunk];
  for (long long u = chunk + 1; u < chunks; ++u) {
    acc = add2(acc, head[u]);
    const long long end = (u + 1) * kChunk < n_terms ? (u + 1) * kChunk : n_terms;
    if (end >= n_terms || keys[end - 1] != key || keys[end] != key) break;
  }
  out[key] = acc;
}

// ---------------------------------------------------------------- grouping
//
// The hash_group kernels put the table gradient's terms in row order, each
// row's terms in term order: the stable sort of the keys (rows) with the
// term indices as values, bit for bit.  They replace no TPU kernel (the JAX
// package has no hash grid).  They were added because kernel 4
// (csrc/radix_sort.cu), which sorted the terms before, is built for rows of
// under a million keys held in the 50 MB L2: per 8-bit pass it reads the keys
// once to count each tile's digits and again to move them.  A training
// step's terms are 104,857,600 pairs (840 MB) keyed by 23 bits of row, so
// each extra read goes to device memory.  Kernel 4 stays with the window
// sorts it was built for (K-Planes, Cobafa), which fit the L2.
//
// What bounds them: the grouped keys and values have to be written, 8 bytes
// a term (0.25 ms at 3.35 TB/s at the early cell's ~780k kept samples).  A
// counting sort would write each term once, but to a random 4-byte slot:
// on an H100 1e8 such stores take 1.70 ms even inside an L2-resident 4 MB
// window, and the atomics that count the rows 0.8-1.1 ms more; a sort of
// the terms through those kernels took 5.4-8.7 ms.  So these kernels move
// the terms in coalesced runs, an LSD radix sort of 8 bits a pass over the
// key's bits, each pass reading every pair once:
//   * hash_group_histogram_kernel reads the keys once and counts every
//     pass's digits (shared-memory counts, one global add per block and
//     digit);
//   * hash_group_sweep_kernel, once per pass: a block takes the next tile
//     of kTile pairs in arrival order (an atomic ticket), ranks each key
//     among the tile's equal digits in tile order (__match_any_sync and a
//     counter per warp and digit, as kernel 4), publishes its digit counts
//     and finds the counts of all earlier tiles by decoupled look-back (a
//     tile's status word per digit: its count, flagged as the tile's own or
//     as the sum of all tiles up to it), then stages the tile in shared
//     memory ordered by digit and writes each digit's run contiguously.  The
//     first pass makes the values (the term index) instead of reading them.
// Equal digits keep their order at every level, so the sort is stable.  No
// float atomics, no host readback; the look-back waits only on tiles that
// took their ticket earlier, so are running or done.

constexpr int kBins = 256;
constexpr int kKeysPerThread = 16;
constexpr int kTile = kThreads * kKeysPerThread;  // 4096 pairs
constexpr int kMaxPasses = 4;                     // keys below 2^31
constexpr int kHistogramBlocks = 1024;            // the histogram's grid, which strides over the keys
constexpr unsigned kOwn = 1u << 30, kUpTo = 2u << 30, kCount = kOwn - 1u;  // look-back status words
static_assert(kThreads == kBins, "thread d owns digit d");

__device__ __forceinline__ unsigned lanes_below() { return (1u << (threadIdx.x & 31)) - 1u; }

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int u = __shfl_up_sync(kFull, v, k);
    if (lane >= k) v += u;
  }
  return v;
}

// Exclusive scan of v over the block's kThreads threads; every thread calls
// it, and `sums` ([kWarps]) is not read by another thread on entry.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums) {
  const int warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if ((threadIdx.x & 31) == 31) sums[warp] = inc;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += sums[w];
  return base + inc - v;
}

// counts [passes, kBins] += the digits (key >> 8 p) & 255 of keys [n].
__global__ void __launch_bounds__(kThreads)
hash_group_histogram_kernel(const int* __restrict__ keys, int n, int passes, int* __restrict__ counts) {
  __shared__ int local[kMaxPasses][kBins];
  for (int p = 0; p < passes; ++p) local[p][threadIdx.x] = 0;
  __syncthreads();
  const int quads = n / 4;
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < quads; q += gridDim.x * kThreads) {
    const int4 k = __ldg(k4 + q);
    for (int p = 0; p < passes; ++p) {
      const int shift = 8 * p;
      atomicAdd(&local[p][(k.x >> shift) & (kBins - 1)], 1);
      atomicAdd(&local[p][(k.y >> shift) & (kBins - 1)], 1);
      atomicAdd(&local[p][(k.z >> shift) & (kBins - 1)], 1);
      atomicAdd(&local[p][(k.w >> shift) & (kBins - 1)], 1);
    }
  }
  if (blockIdx.x == 0)  // the keys past the last whole quad
    for (int i = quads * 4 + static_cast<int>(threadIdx.x); i < n; i += kThreads)
      for (int p = 0; p < passes; ++p) atomicAdd(&local[p][(keys[i] >> (8 * p)) & (kBins - 1)], 1);
  __syncthreads();
  for (int p = 0; p < passes; ++p)
    if (local[p][threadIdx.x] != 0) atomicAdd(counts + p * kBins + threadIdx.x, local[p][threadIdx.x]);
}

// One pass over the digit (key >> shift) & 255: pairs (keys_in, vals_in) ->
// (keys_out, vals_out), vals_in unread in the first pass (the value is the
// pair's index).  counts: the pass's [kBins] digit counts; status: [tiles,
// kBins], zero on entry; ticket: zero on entry.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads, 4)
hash_group_sweep_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in, int* __restrict__ keys_out,
                        int* __restrict__ vals_out, int n, int shift, const int* __restrict__ counts,
                        unsigned* status, int* ticket) {
  __shared__ int staged[kTile], staged_vals[kTile];
  __shared__ int warp_count[kWarps][kBins + 1];  // bin kBins: past the end
  __shared__ int local_base[kBins], global_base[kBins];
  __shared__ int sums[2][kWarps];
  __shared__ int tile_of_block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d_own = threadIdx.x;
  if (threadIdx.x == 0) tile_of_block = atomicAdd(ticket, 1);
  for (int i = threadIdx.x; i < kWarps * (kBins + 1); i += kThreads) (&warp_count[0][0])[i] = 0;
  __syncthreads();
  const int tile = tile_of_block;
  const int tile_base = tile * kTile;
  const int base = tile_base + warp * (32 * kKeysPerThread) + lane;
  const unsigned below = lanes_below();
  int key[kKeysPerThread], rank[kKeysPerThread];
#pragma unroll
  for (int r = 0; r < kKeysPerThread; ++r) {
    const int i = base + r * 32;
    const bool valid = i < n;
    key[r] = valid ? keys_in[i] : 0;
    const int d = valid ? (key[r] >> shift) & (kBins - 1) : kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = __popc(peers & below);
    int prev = 0;
    if (before == 0) {  // the lowest lane of each digit keeps the warp's counter
      prev = warp_count[warp][d];
      warp_count[warp][d] = prev + __popc(peers);
    }
    __syncwarp();
    rank[r] = __shfl_sync(kFull, prev, __ffs(peers) - 1) + before;
  }
  __syncthreads();

  // thread d: digit d's counts scanned over the warps; the tile's total of d
  int total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w][d_own];
    warp_count[w][d_own] = total;
    total += c;
  }
  // publish the tile's count of d, then add the earlier tiles' counts of d
  volatile unsigned* own = status + static_cast<long long>(tile) * kBins + d_own;
  int before_tile = 0;
  if (tile == 0) {
    *own = kUpTo | static_cast<unsigned>(total);
  } else {
    *own = kOwn | static_cast<unsigned>(total);
    for (int t = tile - 1;; --t) {
      const volatile unsigned* at = status + static_cast<long long>(t) * kBins + d_own;
      unsigned v;
      do {
        v = *at;
      } while (v == 0);
      before_tile += static_cast<int>(v & kCount);
      if (v & kUpTo) break;
    }
    *own = kUpTo | static_cast<unsigned>(before_tile + total);
  }
  const int local = block_exclusive_scan(total, sums[0]);
  const int digit_base = block_exclusive_scan(counts[d_own], sums[1]);
  local_base[d_own] = local;
  global_base[d_own] = digit_base + before_tile - local;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kKeysPerThread; ++r) {
    const int i = base + r * 32;
    if (i < n) {
      const int d = (key[r] >> shift) & (kBins - 1);
      const int at = local_base[d] + warp_count[warp][d] + rank[r];
      staged[at] = key[r];
      staged_vals[at] = kFirst ? i : vals_in[i];  // read here, not held through the ranking
    }
  }
  __syncthreads();
  const int n_here = min(n - tile_base, kTile);
  for (int i = threadIdx.x; i < n_here; i += kThreads) {
    const int k = staged[i];
    const int to = global_base[(k >> shift) & (kBins - 1)] + i;
    keys_out[to] = k;
    vals_out[to] = staged_vals[i];
  }
}

int blocks_for(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// pos [n, 3] f32, table [rows, 2] bf16, levels as make_levels reads them;
// out [n, 2L] f32.  All contiguous.
int tn_hash_encode(const void* pos, const void* table, const int* levels, int n, void* out, void* stream) {
  Levels lv;
  if (!make_levels(levels, &lv) || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n) * lv.n;
  if (threads == 0) return 0;
  hash_encode_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const unsigned*>(table), lv, n, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

// pos [n, 3] f32, g [n, 2L] f32; keys, vals [8 n L] int32, prods [8 n L, 2]
// f32 (16-byte aligned).  `sentinel`: the key of a zero cotangent's terms.
int tn_hash_terms(const void* pos, const void* g, const int* levels, int n, int sentinel, void* keys, void* vals,
                  void* prods, void* stream) {
  Levels lv;
  if (!make_levels(levels, &lv) || n < 0 || static_cast<long long>(n) * lv.n * 8 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n) * lv.n;
  if (threads == 0) return 0;
  hash_terms_kernel<<<blocks_for(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float2*>(g), lv, n, sentinel, static_cast<int*>(keys),
      static_cast<int*>(vals), static_cast<float2*>(prods));
  return static_cast<int>(cudaGetLastError());
}

// keys [n_terms] int32 in [0, 2^bits) (16-byte aligned), n_terms < 2^30;
// scratch: scratch_ints >= kMaxPasses 256 + kMaxPasses + passes 256
// ceil(n_terms / 4096) int32; keys_s, vals_s [n_terms] int32 out, tmp_k,
// tmp_v [n_terms] int32 (unused for one pass): keys_s the keys sorted
// stably, vals_s their indices.
int tn_hash_group(const void* keys, int n_terms, int bits, void* scratch, long long scratch_ints, void* keys_s,
                  void* vals_s, void* tmp_k, void* tmp_v, void* stream) {
  const int passes = (bits + 7) / 8;
  const long long tiles = (static_cast<long long>(n_terms) + kTile - 1) / kTile;
  if (n_terms < 0 || n_terms >= (1 << 30) || bits < 1 || bits > 31 ||
      scratch_ints < static_cast<long long>(kMaxPasses) * (kBins + 1) + passes * kBins * tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(scratch);     // [kMaxPasses, kBins]
  int* tickets = counts + kMaxPasses * kBins;   // [kMaxPasses]
  unsigned* status = reinterpret_cast<unsigned*>(tickets + kMaxPasses);  // [passes, tiles, kBins]
  const size_t used = (static_cast<size_t>(kMaxPasses) * (kBins + 1) + passes * kBins * tiles) * sizeof(int);
  cudaError_t err = cudaMemsetAsync(scratch, 0, used, s);
  if (err != cudaSuccess || n_terms == 0) return static_cast<int>(err);
  hash_group_histogram_kernel<<<kHistogramBlocks, kThreads, 0, s>>>(static_cast<const int*>(keys), n_terms, passes,
                                                                    counts);
  const int* src_k = static_cast<const int*>(keys);
  const int* src_v = nullptr;
  for (int p = 0; p < passes; ++p) {
    // the last pass writes keys_s, vals_s, and the passes before it alternate
    const bool to_out = (passes - 1 - p) % 2 == 0;
    int* dst_k = static_cast<int*>(to_out ? keys_s : tmp_k);
    int* dst_v = static_cast<int*>(to_out ? vals_s : tmp_v);
    unsigned* st = status + static_cast<long long>(p) * kBins * tiles;
    if (p == 0)
      hash_group_sweep_kernel<true><<<static_cast<int>(tiles), kThreads, 0, s>>>(
          src_k, nullptr, dst_k, dst_v, n_terms, 0, counts, st, tickets);
    else
      hash_group_sweep_kernel<false><<<static_cast<int>(tiles), kThreads, 0, s>>>(
          src_k, src_v, dst_k, dst_v, n_terms, 8 * p, counts + p * kBins, st, tickets + p);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, vals [n_terms] int32 sorted by key (16-byte aligned), prods
// [n_terms, 2] f32; head, tail [ceil(n_terms / 16), 2] f32 and tail_key
// [ceil(n_terms / 16)] int32 scratch; out [n_rows, 2] f32, zeroed here.
int tn_hash_accumulate(const void* keys, const void* vals, const void* prods, long long n_terms, int n_rows,
                       void* head, void* tail, void* tail_key, void* out, void* stream) {
  if (n_terms < 0 || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n_rows) * sizeof(float2), s);
  if (err != cudaSuccess || n_terms == 0) return static_cast<int>(err);
  const long long chunks = (n_terms + kChunk - 1) / kChunk;
  hash_accumulate_kernel<<<blocks_for(chunks), kThreads, 0, s>>>(
      static_cast<const int*>(keys), static_cast<const int*>(vals), static_cast<const float2*>(prods), n_terms,
      n_rows, static_cast<float2*>(head), static_cast<float2*>(tail), static_cast<int*>(tail_key),
      static_cast<float2*>(out));
  hash_accumulate_combine_kernel<<<blocks_for(chunks), kThreads, 0, s>>>(
      static_cast<const int*>(keys), n_terms, chunks, static_cast<const float2*>(head),
      static_cast<const float2*>(tail), static_cast<const int*>(tail_key), static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
