// Windowed table-gradient accumulation over window-sorted samples.
//
// Replaces tinynerf_tpu/ops/table_grad.py:_accum_kernel, the Pallas TPU
// kernel that, per (projection p, window of W cells), sums the sorted
// samples' rows concat_c(w_c * g) into the window's [W, nc*F] slice of the
// cell-packed gradient table.  The TPU kernel scatters with one-hot bf16
// hi/lo matmuls on its matrix unit, its way around a row-serial scatter;
// here the scatter is a shared-memory atomic add in f32.
//
// Payload rows [P, M, fp] (the encodings of table_grad.py, keyed on dtype):
//   f32:  [g(F) | w(nc) | cell | pad], the cell id an exact f32 integer;
//   bf16: [g(F) | w_hi(nc) | w_lo(nc) | cell % W | pad], w = hi + lo.
// offsets [P, NW + 1]: the sorted samples of window v of projection p are
// rows [offsets[p, v], offsets[p, v + 1]).
//
// What bounds it on an H100: memory.  At the training default (P = 3,
// 819,200 samples each, F = 96, nc = 4, 262,144 cells) it reads ~1.26 GB of
// f32 payload (0.63 GB bf16) and writes the 1.2 GB f32 table, ~0.75 ms at
// the published 3.35 TB/s (700 W).
//
// Design.  One window's output tile, W x nc*F = 256 x 384 f32, is 384 KB,
// more than a block's 227 KB of shared memory.  So a block owns a band of
// `rows` consecutive cells of one window (64 x 384 x 4 B = 96 KB at the
// default, two blocks per SM), zeroes it in shared memory, walks a chunk of
// the window's samples one warp per sample (the lanes read the row's cell
// field; a warp whose sample lies outside the band skips it, so each band
// re-reads only that one 32-byte sector of the other bands' samples, and a
// sample whose cotangent is all zero adds nothing and is skipped too), adds
// w_c * g into the band with shared-memory atomics (lanes on consecutive
// columns: no bank conflicts) and writes the band out once, coalesced.
//
// Windows are split into chunks of `chunk` samples, one block per (chunk,
// band): in training every pad sample of the packed buffer sits at the
// same position, so one window can hold most of a projection's samples, in
// one cell, and a single block walking them all stalls the whole launch.
// The wrapper lists the chunks on the device (an exclusive scan of
// ceil(count / chunk) over the windows, no host sync) and launches an
// upper bound of blocks; a block finds its window by binary search.  The
// output starts at 0 (cells no sample touches stay exactly 0); a band of a
// one-chunk window is stored, a band of a split window is added with
// global atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // 16 warps, each on its own sample
constexpr int kMaxCorners = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void windowed_accumulate_kernel(const T* __restrict__ packed,
                                           const int* __restrict__ offsets,
                                           const int* __restrict__ chunk_start, int chunk,
                                           int n_proj, int m_rows, int fp, int f_dim,
                                           int nc, int n_windows, int w_window, int rows,
                                           float* __restrict__ out) {
  extern __shared__ float band[];  // [rows, nc * f_dim]
  __shared__ int any_sample;
  const int n_items = n_proj * n_windows;
  const int item = blockIdx.x;
  if (item >= chunk_start[n_items]) return;  // past the last chunk: block-uniform
  // the (projection, window) whose chunks hold `item`: the last pw with
  // chunk_start[pw] <= item
  int lo = 0, hi = n_items - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk_start[mid] <= item) lo = mid; else hi = mid - 1;
  }
  const int pw = lo;
  const bool split = chunk_start[pw + 1] - chunk_start[pw] > 1;
  const int p = pw / n_windows, win = pw % n_windows;
  const int* off = offsets + static_cast<long long>(p) * (n_windows + 1);
  const int start = off[win] + (item - chunk_start[pw]) * chunk;
  const int end = min(off[win + 1], start + chunk);

  const bool bf16 = sizeof(T) == 2;
  const int width = nc * f_dim;
  const int band_lo = blockIdx.y * rows;  // first cell of the band, window-local
  for (int t = threadIdx.x; t < rows * width; t += blockDim.x) band[t] = 0.0f;
  if (threadIdx.x == 0) any_sample = 0;
  __syncthreads();

  const T* base = packed + static_cast<long long>(p) * m_rows * fp;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int i = start + (threadIdx.x >> 5); i < end; i += n_warps) {
    const T* row = base + static_cast<long long>(i) * fp;
    const int local = bf16 ? static_cast<int>(to_f32(row[f_dim + 2 * nc]))
                           : static_cast<int>(to_f32(row[f_dim + nc])) - win * w_window;
    const int r = local - band_lo;
    if (r < 0 || r >= rows) continue;  // warp-uniform: one sample per warp
    bool nonzero = false;
    for (int col = lane; col < f_dim; col += 32) nonzero |= to_f32(row[col]) != 0.0f;
    if (!__any_sync(0xffffffffu, nonzero)) continue;  // adds nothing
    any_sample = 1;
    float wk[kMaxCorners];
#pragma unroll
    for (int k = 0; k < kMaxCorners; ++k) {
      wk[k] = 0.0f;
      if (k < nc) {
        wk[k] = bf16 ? to_f32(row[f_dim + k]) + to_f32(row[f_dim + nc + k])
                     : to_f32(row[f_dim + k]);
      }
    }
    float* dst = band + r * width;
    for (int col = lane; col < f_dim; col += 32) {
      const float gv = to_f32(row[col]);
#pragma unroll
      for (int k = 0; k < kMaxCorners; ++k) {
        if (k < nc) atomicAdd(dst + k * f_dim + col, wk[k] * gv);
      }
    }
  }
  __syncthreads();
  if (!any_sample) return;  // the band stays 0

  const long long cell0 = static_cast<long long>(win) * w_window + band_lo;
  float* dst = out + (static_cast<long long>(p) * n_windows * w_window + cell0) * width;
  if (split) {
    for (int t = threadIdx.x; t < rows * width; t += blockDim.x) {
      if (band[t] != 0.0f) atomicAdd(dst + t, band[t]);
    }
  } else {
    for (int t = threadIdx.x; t < rows * width; t += blockDim.x) dst[t] = band[t];
  }
}

// Largest power-of-two band of cells (dividing the window) whose f32 tile
// fits `budget` bytes of shared memory.
int band_rows(int w_window, int width, int budget) {
  int rows = w_window;
  while (rows > 1 && static_cast<long long>(rows) * width * 4 > budget) rows >>= 1;
  return rows;
}

template <typename T>
int launch(const void* packed, const void* offsets, const void* chunk_start,
           int max_chunks, int chunk, int n_proj, int m_rows, int fp, int f_dim, int nc,
           int n_windows, int w_window, void* out, cudaStream_t stream) {
  const int width = nc * f_dim;
  const int rows = band_rows(w_window, width, 96 * 1024);
  const int smem = rows * width * 4;
  if (nc < 1 || nc > kMaxCorners || smem > 227 * 1024 || max_chunks <= 0 || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(windowed_accumulate_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(max_chunks, w_window / rows);
  windowed_accumulate_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(packed), static_cast<const int*>(offsets),
      static_cast<const int*>(chunk_start), chunk, n_proj, m_rows, fp, f_dim, nc, n_windows,
      w_window, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [n_proj, n_windows * w_window, nc * f_dim] f32, zeroed by the caller;
// packed [n_proj, m_rows, fp], f32 (bf16_payload = 0) or bf16 (= 1);
// chunk_start [n_proj * n_windows + 1] int32, the exclusive scan of each
// window's ceil(count / chunk); max_chunks >= chunk_start[last] (the grid).
// w_window must be a power of two.
int tn_windowed_accumulate(const void* packed, const void* offsets,
                           const void* chunk_start, int max_chunks, int chunk, int n_proj,
                           int m_rows, int fp, int f_dim, int nc, int n_windows,
                           int w_window, int bf16_payload, void* out, void* stream) {
  if (n_proj <= 0 || n_windows <= 0) return 0;
  if (w_window < 1 || (w_window & (w_window - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_payload) {
    return launch<__nv_bfloat16>(packed, offsets, chunk_start, max_chunks, chunk, n_proj, m_rows,
                                 fp, f_dim, nc, n_windows, w_window, out, st);
  }
  return launch<float>(packed, offsets, chunk_start, max_chunks, chunk, n_proj, m_rows, fp, f_dim,
                       nc, n_windows, w_window, out, st);
}

}  // extern "C"
