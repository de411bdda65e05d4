// Stable ascending sort of int32 keys by a range of their bits, batched over
// rows: a least-significant-digit radix sort.
//
// Replaces tinynerf_tpu/ops/bitonic.py:_sort_kernel, the Pallas TPU sort of
// the packed keys (window << idx_bits) | sample_index that partition the
// K-Planes table gradient by table window.  The TPU kernel is a bitonic
// network: it holds a row of up to 2^20 keys in VMEM and runs all
// log^2(n) / 2 compare-exchange passes there with lane and sublane rolls,
// which its vector unit does well and which needs no scatter.  This card has
// a fast scatter through shared memory, so the sort is a radix sort: one
// pass per 8-bit digit, each key moved once per pass, and only over the bits
// the caller names.  The packed keys' low idx_bits are an ascending iota, so
// a stable sort over the window bits alone (10 bits at the training shape:
// two passes) is the full ascending sort.
//
// What bounds it on an H100: memory traffic per pass.  Three rows of
// 819,200 keys are 9.8 MB, resident in the 50 MB L2 cache; each pass reads
// the keys twice and writes them once.
//
// Design, per digit pass (least significant first), three launches over
// tiles of kTile keys:
//   * radix_histogram_kernel: a block counts its tile's digits in shared
//     memory (one atomic per distinct digit of a warp's 32 keys, found with
//     __match_any_sync) and writes hist[row, digit, tile];
//   * radix_scan_kernel: one warp per (row, digit) turns hist into its
//     exclusive scan over tiles and writes the digit's total;
//   * radix_scatter_kernel: a block reloads its tile, 16 keys a thread in
//     registers, warp w holding keys [512 w, 512 w + 512) of the tile in 16
//     rounds of 32 consecutive keys.  Each key is ranked among the equal
//     digits before it: inside the round by __match_any_sync and a popcount
//     of the lower lanes, across rounds by a per-warp counter per digit in
//     shared memory, across warps by a scan of those counters.  Keys go to
//     their rank in a shared-memory copy of the tile ordered by digit, and
//     from there to device memory, each digit's run contiguous, at the
//     digit's base in the row (exclusive scan of the totals over digits)
//     plus the tile's offset from the scan kernel.
// Equal digits keep their input order at every level, so the sort is
// stable.  The key-value form (tn_sort_pairs_i32) moves an int32 value with
// each key through the same ranks: Cobafa's oct gradient sorts window ids
// as keys with the sample index as the value, because its grids' windows
// and sample indices together need more than 32 bits (127^3 cells in
// windows of 64: 15 bits; 819,200 samples: 20).  Passes ping-pong between two buffers; the input is only read.
// Bit 31 is flipped in the digit, so signed keys sort as torch.sort sorts
// them.  A chained scan with decoupled look-back would make it one launch
// per pass; the three-launch form needs no forward-progress guarantee.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kThreads = kBins;  // thread d owns digit d in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerThread = 16;
constexpr int kWarpKeys = 32 * kKeysPerThread;
constexpr int kTile = kThreads * kKeysPerThread;  // 4096 keys, 16 KB

__device__ __forceinline__ int digit_of(int key, int shift, unsigned mask) {
  return static_cast<int>(((static_cast<unsigned>(key) ^ 0x80000000u) >> shift) & mask);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int u = __shfl_up_sync(kFull, v, k);
    if (lane >= k) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread over the block's kBins threads.
// `sums` holds kWarps ints; the caller synchronizes before reusing it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums) {
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if ((threadIdx.x & 31) == 31) sums[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += sums[w];
  return base + incl - v;
}

// hist [rows, kBins, tiles]
__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(const int* __restrict__ keys, int n, int tiles, int shift, unsigned mask,
                      int* __restrict__ hist) {
  __shared__ int counts[kBins];
  const int row = blockIdx.y, tile = blockIdx.x;
  counts[threadIdx.x] = 0;
  __syncthreads();
  const int* src = keys + static_cast<long long>(row) * n;
  const long long base = static_cast<long long>(tile) * kTile;
  const unsigned below = lanes_below();
  for (int r = 0; r < kKeysPerThread; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    const bool valid = i < n;
    const int d = valid ? digit_of(src[i], shift, mask) : kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid && (peers & below) == 0) atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  hist[(static_cast<long long>(row) * kBins + threadIdx.x) * tiles + tile] = counts[threadIdx.x];
}

// One warp per (row, digit): hist[row, digit, :] becomes its exclusive scan,
// totals[row, digit] its sum.
__global__ void __launch_bounds__(kThreads)
radix_scan_kernel(int* __restrict__ hist, int tiles, int* __restrict__ totals) {
  const int run = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  int* h = hist + static_cast<long long>(run) * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const int t = t0 + lane;
    const int v = t < tiles ? h[t] : 0;
    const int incl = warp_inclusive_scan(v);
    if (t < tiles) h[t] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) totals[run] = carry;
}

// With PAIRS, vals_in[i] moves with keys_in[i] to the same place.
template <bool PAIRS>
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const int* __restrict__ keys_in, int* __restrict__ keys_out,
                     const int* __restrict__ vals_in, int* __restrict__ vals_out, int n, int tiles,
                     int shift, unsigned mask, const int* __restrict__ hist,
                     const int* __restrict__ totals) {
  __shared__ int staged[kTile];
  __shared__ int staged_vals[PAIRS ? kTile : 1];
  __shared__ int warp_count[kWarps][kBins + 1];  // bin kBins: past the row's end
  __shared__ int local_base[kBins];   // where digit d's run starts in `staged`
  __shared__ int global_base[kBins];  // row position of staged[i], less i, for digit d
  __shared__ int sums[2][kWarps];
  const int row = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * (kBins + 1); i += kThreads) (&warp_count[0][0])[i] = 0;
  __syncthreads();

  const int* src = keys_in + static_cast<long long>(row) * n;
  const long long tile_base = static_cast<long long>(tile) * kTile;
  const long long base = tile_base + warp * kWarpKeys + lane;
  const unsigned below = lanes_below();
  const int* vsrc = PAIRS ? vals_in + static_cast<long long>(row) * n : nullptr;
  int key[kKeysPerThread], rank[kKeysPerThread], val[PAIRS ? kKeysPerThread : 1];
#pragma unroll
  for (int r = 0; r < kKeysPerThread; ++r) {
    const long long i = base + r * 32;
    const bool valid = i < n;
    key[r] = valid ? src[i] : 0;
    if constexpr (PAIRS) val[r] = valid ? vsrc[i] : 0;
    const int d = valid ? digit_of(key[r], shift, mask) : kBins;
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

  // thread d: digit d's counts scanned over the warps, its total over digits
  const int d_own = threadIdx.x;
  int total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_count[w][d_own];
    warp_count[w][d_own] = total;
    total += c;
  }
  const int local = block_exclusive_scan(total, sums[0]);
  const long long run = static_cast<long long>(row) * kBins + d_own;
  const int digit_base = block_exclusive_scan(totals[run], sums[1]);
  local_base[d_own] = local;
  global_base[d_own] = digit_base + hist[run * tiles + tile] - local;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kKeysPerThread; ++r) {
    if (base + r * 32 < n) {
      const int d = digit_of(key[r], shift, mask);
      const int at = local_base[d] + warp_count[warp][d] + rank[r];
      staged[at] = key[r];
      if constexpr (PAIRS) staged_vals[at] = val[r];
    }
  }
  __syncthreads();

  const long long left = n - tile_base;
  const int n_here = left < kTile ? static_cast<int>(left) : kTile;
  int* dst = keys_out + static_cast<long long>(row) * n;
  int* vdst = PAIRS ? vals_out + static_cast<long long>(row) * n : nullptr;
  for (int i = threadIdx.x; i < n_here; i += kThreads) {
    const int k = staged[i];
    const int to = global_base[digit_of(k, shift, mask)] + i;
    dst[to] = k;
    if constexpr (PAIRS) vdst[to] = staged_vals[i];
  }
}

// The passes of tn_sort_i32 / tn_sort_pairs_i32 (vals null: keys only).
int sort_passes(const int* src, const int* vsrc, void* buf_a, void* buf_b, void* vbuf_a, void* vbuf_b,
                void* scratch_v, int n_rows, int n, int begin_bit, int end_bit, cudaStream_t stream) {
  if (n_rows <= 0 || n <= 0 || n_rows > 65535 || begin_bit < 0 || end_bit > 32 ||
      begin_bit >= end_bit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + kTile - 1) / kTile;
  int* hist = static_cast<int*>(scratch_v);
  int* totals = hist + static_cast<long long>(n_rows) * kBins * tiles;
  const dim3 grid(tiles, n_rows);
  int pass = 0;
  for (int shift = begin_bit; shift < end_bit; shift += kRadixBits, ++pass) {
    const int bits = end_bit - shift < kRadixBits ? end_bit - shift : kRadixBits;
    const unsigned mask = (1u << bits) - 1u;
    int* dst = static_cast<int*>(pass % 2 == 0 ? buf_a : buf_b);
    int* vdst = static_cast<int*>(pass % 2 == 0 ? vbuf_a : vbuf_b);
    if (dst == nullptr || (vsrc != nullptr && vdst == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    radix_histogram_kernel<<<grid, kThreads, 0, stream>>>(src, n, tiles, shift, mask, hist);
    radix_scan_kernel<<<n_rows * (kBins / kWarps), kThreads, 0, stream>>>(hist, tiles, totals);
    if (vsrc != nullptr) {
      radix_scatter_kernel<true><<<grid, kThreads, 0, stream>>>(src, dst, vsrc, vdst, n, tiles, shift, mask,
                                                                hist, totals);
    } else {
      radix_scatter_kernel<false><<<grid, kThreads, 0, stream>>>(src, dst, nullptr, nullptr, n, tiles, shift,
                                                                 mask, hist, totals);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    vsrc = vdst;
  }
  return 0;
}

}  // namespace

extern "C" {

// Sorts each row of keys [n_rows, n] stably by the key bits [begin_bit,
// end_bit), ascending, bit 31 taken as the sign.  One pass per 8 bits: pass
// 0 reads `keys` and writes buf_a, pass 1 reads buf_a and writes buf_b, and
// so on in turns, so the result is in buf_a after an odd number of passes,
// in buf_b after an even one (buf_b may be null for one pass).  `scratch`
// holds n_rows * 256 * (ceil(n / 4096) + 1) int32.
int tn_sort_i32(const void* keys_v, void* buf_a, void* buf_b, void* scratch_v, int n_rows, int n,
                int begin_bit, int end_bit, void* stream_v) {
  return sort_passes(static_cast<const int*>(keys_v), nullptr, buf_a, buf_b, nullptr, nullptr, scratch_v,
                     n_rows, n, begin_bit, end_bit, static_cast<cudaStream_t>(stream_v));
}

// The same sort of keys [n_rows, n], carrying vals [n_rows, n] int32: pass
// by pass into (keys_a, vals_a), then (keys_b, vals_b), in turns, as above.
int tn_sort_pairs_i32(const void* keys_v, const void* vals_v, void* keys_a, void* keys_b, void* vals_a,
                      void* vals_b, void* scratch_v, int n_rows, int n, int begin_bit, int end_bit,
                      void* stream_v) {
  if (vals_v == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return sort_passes(static_cast<const int*>(keys_v), static_cast<const int*>(vals_v), keys_a, keys_b,
                     vals_a, vals_b, scratch_v, n_rows, n, begin_bit, end_bit,
                     static_cast<cudaStream_t>(stream_v));
}

}  // extern "C"
