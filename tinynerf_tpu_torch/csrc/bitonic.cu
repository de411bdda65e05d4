// Ascending sort of int32 keys, batched over rows: a bitonic network.
//
// Replaces tinynerf_tpu/ops/bitonic.py:_sort_kernel, the Pallas TPU sort of
// the packed keys (window << idx_bits) | sample_index that partition the
// K-Planes table gradient by table window.  The TPU kernel holds a whole
// row of up to 2^20 keys in VMEM and runs every compare-exchange pass there
// with lane and sublane rolls of a column-major tile; that layout is a TPU
// device for VMEM, not part of the result.
//
// What bounds it on an H100: memory traffic per pass.  A row of 2^20 keys
// is 4 MB and three rows (the three projections) are 12 MB: more than a
// block's 227 KB of shared memory, less than the 50 MB L2 cache.
//
// Design.  Each row has a power-of-two length n_row >= 256 (the wrapper
// pads with INT32_MAX, which sorts to the tail).  Pass (k, j) of the network
// compare-exchanges keys i and i | j (bit j of i clear), ascending where bit
// k of i's position in its row is clear.  Rows are contiguous and aligned to
// n_row, so one flat launch sorts every row: the direction reads the
// row-local index, and no partner crosses a row.
//   * tile kernel: a block loads a tile of kTile keys into shared memory and
//     runs every pass whose stride j is below the tile (all of them for the
//     first kTile-wide stage, the tail j < kTile of a merge stage), with a
//     __syncthreads between passes;
//   * global kernel: one thread per pair for a pass whose stride j >= kTile,
//     straight on device memory (L2-resident at these sizes).
// At 3 x 2^20 keys that is 1 tile sort, 8 tile merges and 36 global passes.
// Keys are compared as signed int32, so the result equals torch.sort's
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;  // keys per shared-memory tile: 8 KB, 1024 threads

__device__ __forceinline__ void compare_exchange(int& a, int& b, bool up) {
  if ((a > b) == up) {
    const int t = a;
    a = b;
    b = t;
  }
}

// Runs the passes (k, j) for j < tile inside shared memory.  SORT: every
// stage k = 2 .. tile; otherwise the tail of merge stage `k_merge`.
template <bool SORT>
__global__ void bitonic_tile_kernel(int* __restrict__ keys, int n_row, int tile,
                                    int k_merge) {
  __shared__ int sh[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) sh[t] = keys[base + t];
  __syncthreads();
  const int half = tile >> 1;
  // position of the tile's first key inside its row (rows align to n_row)
  const int row_off = static_cast<int>(base & (n_row - 1));
  const int k_first = SORT ? 2 : k_merge;
  const int k_last = SORT ? tile : k_merge;
  for (int k = k_first; k <= k_last; k <<= 1) {
    for (int j = (SORT ? k : tile) >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
        const bool up = (((row_off + i) & k) == 0);
        compare_exchange(sh[i], sh[i + j], up);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) keys[base + t] = sh[t];
}

__global__ void bitonic_global_kernel(int* __restrict__ keys, long long n_pairs,
                                      int n_row, int k, int j) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const long long i = 2 * p - (p & (j - 1));
  const bool up = ((static_cast<int>(i & (n_row - 1)) & k) == 0);
  int a = keys[i], b = keys[i + j];
  if ((a > b) == up) {
    keys[i] = b;
    keys[i + j] = a;
  }
}

}  // namespace

extern "C" {

// Sorts each of the n_rows rows of keys [n_rows, n_row] ascending, in place.
// n_row must be a power of two >= 2 (the wrapper pads to >= 256).
int tn_sort_i32(void* keys_v, int n_rows, int n_row, void* stream_v) {
  if (n_rows <= 0 || n_row < 2 || (n_row & (n_row - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* keys = static_cast<int*>(keys_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const int tile = n_row < kTile ? n_row : kTile;
  const long long n_total = static_cast<long long>(n_rows) * n_row;
  const int tiles = static_cast<int>(n_total / tile);
  const int threads = tile / 2;
  const long long n_pairs = n_total / 2;
  const int pair_threads = 256;
  const int pair_blocks = static_cast<int>((n_pairs + pair_threads - 1) / pair_threads);

  bitonic_tile_kernel<true><<<tiles, threads, 0, stream>>>(keys, n_row, tile, 0);
  cudaError_t err = cudaGetLastError();
  for (int k = 2 * tile; k <= n_row && err == cudaSuccess; k <<= 1) {
    for (int j = k >> 1; j >= tile && err == cudaSuccess; j >>= 1) {
      bitonic_global_kernel<<<pair_blocks, pair_threads, 0, stream>>>(
          keys, n_pairs, n_row, k, j);
      err = cudaGetLastError();
    }
    if (err == cudaSuccess) {
      bitonic_tile_kernel<false><<<tiles, threads, 0, stream>>>(keys, n_row, tile, k);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
