// Windowed table-gradient accumulation over window-sorted samples.
//
// Replaces tinynerf_tpu/ops/table_grad.py:_accum_kernel, the Pallas TPU
// kernel that, per (projection p, window of W cells), sums the sorted
// samples' rows concat_c(w_c * g) into the window's [W, nc*F] slice of the
// cell-packed gradient table.  The TPU kernel scatters with one-hot bf16
// hi/lo matmuls on its matrix unit, its way around a row-serial scatter.
// They are not carried over: on this card three wgmma passes (for f32
// accuracy) over 256-wide one-hot tiles would cost about as much as the
// whole memory bound, while shared-memory f32 atomic adds scatter directly.
//
// Payload rows [P, M, fp] (the encodings of table_grad.py, keyed on dtype):
//   f32:  [g(F) | w(nc) | cell | pad], the cell id an exact f32 integer;
//   bf16: [g(F) | w_hi(nc) | w_lo(nc) | cell % W | pad], w = hi + lo.
// offsets [P, NW + 1]: the sorted samples of window v of projection p are
// rows [offsets[p, v], offsets[p, v + 1]).
//
// What bounds it on an H100: memory.  At the training default (P = 3,
// 819,200 samples each, F = 96, nc = 4, 262,144 cells) it reads 0.63 GB of
// bf16 payload (1.26 GB f32) and writes the 1.2 GB f32 table: 0.55 ms (0.74)
// at the published 3.35 TB/s (700 W).  What held the first version at six
// times that: every warp began each sample with a dependent device-memory
// load, four blocks walked every sample, and the output was written twice.
//
// Design.  A work item is a chunk of at most `chunk` samples of one window
// (every window has at least one item, so an empty window's zeros are
// written too and the output needs no fill).  The work list is made on the
// device: windowed_chunk_scan_kernel writes chunk_start, the exclusive scan
// of max(1, ceil(count / chunk)) over the windows; windowed_item_table_kernel
// each item's window, first row and rows, and a zero base for the windows
// that are split into several items (their sums are added to it with global
// atomics; an unsplit window's are stored).  An item's rows are one
// contiguous run: both kernels below stage it in shared memory with 1-D bulk
// asynchronous copies (cp.async.bulk) that complete on an mbarrier per
// stage, so that no device-memory round trip is left in a warp's loop, each
// sample is read once, and a row whose cotangent is all zero (the packed
// buffer's pad tail: up to half the samples, all in one cell) is skipped on
// the staged row.
//   * windowed_accumulate_owner_kernel, for windows of up to 64 cells x 4
//     corners x 96 values (the training shape: the caller sorts by windows
//     of 64 cells).  Nothing is summed in shared memory: each of a block's
//     32 warps owns two cells of the window and keeps their sums in
//     registers, so there is no atomic, no tile to zero and no second copy
//     of the sums.  One resident block per SM walks its share of the items;
//     the ring of stages runs across item boundaries.
//   * windowed_accumulate_kernel, for every other shape: one block holds
//     the window's f32 tile [W, nc*F] in shared memory (or, if it does not
//     fit, one of n_split = (nc / corners) * (W / rows) blocks holds
//     `corners` whole corners of `rows` cells and skips the other cells'
//     samples); a producer warp feeds the ring, the consumer warps add a row
//     each at a time with shared-memory f32 atomics (a compare-and-swap loop
//     in hardware, ATOMS.CAST.SPIN: its rate bounds this kernel).
// Tried on the card and dropped, all slower: a thread block cluster per item
// with one multicast copy for its blocks (the remote mbarrier arrives cost
// more than the second read, which L2 serves); owner warps adding into the
// shared tile without atomics; resident blocks for the tile kernel.
// A wait on an mbarrier that lasts two seconds traps (a lost copy reports a
// launch failure, not a hang).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxStages = 8;
constexpr int kMaxCorners = 8;
constexpr int kPerLane = 3;  // values of g a lane keeps in registers: rows of up to 96 whole
constexpr int kScanThreads = 1024;
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- PTX: mbarriers and bulk copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t"
      "}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// With -DTN_ACCUM_CLOCKS the accumulation kernel sums, over its blocks, the
// nanoseconds thread 0 (a consumer) spends in each phase, for
// tools/profile_table_grad_torch.py --clocks; tn_accum_clocks reads them.
#ifdef TN_ACCUM_CLOCKS
// the tile kernel: start, zero fill, first copy, rows, other warps, write-out;
// the register kernel: start, classify + barrier, copies, adds, feed, write-out
constexpr int kClockPhases = 6;
__device__ unsigned long long accum_clocks[kClockPhases + 1];  // and the blocks counted
#define TN_CLOCK(phase)                                                 \
  if (threadIdx.x == 0) {                                               \
    const unsigned long long now = global_ns();                         \
    atomicAdd(&accum_clocks[phase], now - clock_at);                    \
    clock_at = now;                                                     \
  }
#else
#define TN_CLOCK(phase)
#endif

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- the work list

// chunk_start [n_items + 1]: the exclusive scan over the windows (p, v) of
// max(1, ceil(count / chunk)).  One block.
__global__ void __launch_bounds__(kScanThreads)
windowed_chunk_scan_kernel(const int* __restrict__ offsets, int n_items, int n_windows, int chunk,
                  int* __restrict__ chunk_start) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n_items; base += kScanThreads) {
    const int i = base + threadIdx.x;
    int v = 0;
    if (i < n_items) {
      const int* off = offsets + (i / n_windows) * (n_windows + 1) + i % n_windows;
      v = max(1, (off[1] - off[0] + chunk - 1) / chunk);
    }
    int incl = v;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, k);
      if (lane >= k) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sums[lane];
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int u = __shfl_up_sync(kFull, s, k);
        if (lane >= k) s += u;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    if (i < n_items) chunk_start[i + 1] = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + incl;
    carry += warp_sums[31];
    __syncthreads();
  }
  if (threadIdx.x == 0) chunk_start[0] = 0;
}

// Block pw lists window pw's chunks in `items`: per chunk (pw, its first
// row in the projection's sorted samples, its rows, whether the window has
// other chunks); and zeroes the window's output tile if it has.
__global__ void windowed_item_table_kernel(const int* __restrict__ offsets,
                                           const int* __restrict__ chunk_start, int n_windows,
                                           int chunk, int4* __restrict__ items,
                                           float* __restrict__ out, int window_floats) {
  const int pw = blockIdx.x;
  const int first = chunk_start[pw], n_chunks = chunk_start[pw + 1] - first;
  const int* off = offsets + (pw / n_windows) * (n_windows + 1) + pw % n_windows;
  const int begin = off[0], end = off[1];
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    const int start = begin + c * chunk;
    items[first + c] = make_int4(pw, start, min(end, start + chunk) - start, n_chunks > 1);
  }
  if (n_chunks <= 1) return;
  float* dst = out + static_cast<long long>(pw) * window_floats;
  if (window_floats % 4 == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int t = threadIdx.x; t < window_floats / 4; t += blockDim.x) {
      dst4[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int t = threadIdx.x; t < window_floats; t += blockDim.x) dst[t] = 0.0f;
  }
}

// ---- the accumulation

struct Args {
  const void* packed;
  const int* chunk_start;
  const int4* items;
  float* out;
  int chunk, n_items, m_rows, fp, f_dim, nc, n_windows, w_window;
  int corners;  // corners of a block's tile
  int rows;     // cells of a block's tile
  int n_split;  // blocks per item: (nc / corners) * (w_window / rows)
  int n_stages, stage_rows;
};

enum class Write { kStore, kZeros, kAdd };

// The block's tile [rows, cols] (in shared memory, or zeros) into the
// output rows of `width` floats, 16 bytes a thread where f_dim allows.
template <Write MODE>
__device__ __forceinline__ void write_tile(const float* tile, float* dst, int rows, int cols,
                                           int width, bool vector) {
  if (MODE != Write::kAdd && vector) {
    const int per_row = cols / 4;
    for (int t = threadIdx.x; t < rows * per_row; t += blockDim.x) {
      const int r = t / per_row, c = 4 * (t % per_row);
      const float4 v = MODE == Write::kStore ? *reinterpret_cast<const float4*>(tile + r * cols + c)
                                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * width + c) = v;
    }
    return;
  }
  for (int t = threadIdx.x; t < rows * cols; t += blockDim.x) {
    float* at = dst + static_cast<long long>(t / cols) * width + t % cols;
    if (MODE == Write::kAdd) {
      if (tile[t] != 0.0f) atomicAdd(at, tile[t]);
    } else {
      *at = MODE == Write::kStore ? tile[t] : 0.0f;
    }
  }
}

// 56 registers: two blocks of 544 threads, or one of 1024, fit an SM's 65,536.
template <typename T>
__global__ void __maxnreg__(56) windowed_accumulate_kernel(const Args a) {
  // [ring: n_stages x stage_rows rows | tile: rows x corners*f_dim f32 | mbarriers]
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int any_sample;
#ifdef TN_ACCUM_CLOCKS
  unsigned long long clock_at = global_ns();
#endif
  const int item = blockIdx.x / a.n_split, part = blockIdx.x % a.n_split;
  if (item >= a.chunk_start[a.n_items]) return;  // past the last chunk: uniform over the block
  const int4 it = a.items[item];
  const int pw = it.x, start = it.y, count = it.z;  // its (projection, window) and rows
  const bool split = it.w != 0;
  const int p = pw / a.n_windows, win = pw % a.n_windows;

  const bool bf16 = sizeof(T) == 2;
  const int f_dim = a.f_dim, nc = a.nc, rows = a.rows, width = nc * f_dim;
  const int corner_parts = nc / a.corners;
  const int corner0 = (part % corner_parts) * a.corners;  // the tile's first corner
  const int band_lo = (part / corner_parts) * rows;       // and first cell, window-local
  const int cols = a.corners * f_dim;
  const bool vector = f_dim % 4 == 0;
  float* dst = a.out + (static_cast<long long>(pw) * a.w_window + band_lo) * width + corner0 * f_dim;
  if (count <= 0) {  // a window without samples (one item): its zeros
    write_tile<Write::kZeros>(nullptr, dst, rows, cols, width, vector);
    return;
  }

  const int stage_bytes = a.stage_rows * a.fp * static_cast<int>(sizeof(T));
  const int tile_floats = (rows * cols + 3) & ~3;
  float* tile = reinterpret_cast<float*>(smem + a.n_stages * stage_bytes);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = smem_u32(tile + tile_floats), empty = full + 8 * kMaxStages;
  const int n_consumers = (blockDim.x >> 5) - 1;  // warps; the last warp is the producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.n_stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, n_consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    any_sample = 0;
  }
  __syncthreads();
  TN_CLOCK(0)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int s = 0;
  if (warp == n_consumers) {
    // producer: one lane re-fills each stage as soon as every consumer warp
    // has released it
    if (lane == 0) {
      const T* src = static_cast<const T*>(a.packed) +
                     (static_cast<long long>(p) * a.m_rows + start) * a.fp;
      uint32_t parity = 1;  // of the stage's previous round; the first round waits for nothing
      for (int done = 0; done < count; done += a.stage_rows) {
        const uint32_t bytes =
            static_cast<uint32_t>(min(a.stage_rows, count - done)) * a.fp * sizeof(T);
        mbar_wait(empty + 8 * s, parity);
        mbar_arrive_expect_tx(full + 8 * s, bytes);
        bulk_copy(ring + s * stage_bytes, src + static_cast<long long>(done) * a.fp, bytes,
                  full + 8 * s);
        if (++s == a.n_stages) {
          s = 0;
          parity ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // the consumer warps zero the tile while the first copies are in flight
    const int n_threads = 32 * n_consumers;
    for (int t = threadIdx.x; t < tile_floats / 4; t += n_threads) {
      reinterpret_cast<float4*>(tile)[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    asm volatile("bar.sync 1, %0;" ::"r"(n_threads) : "memory");
    TN_CLOCK(1)
    bool any = false;
    uint32_t parity = 0;
    int mine = warp;  // row i of the item goes to consumer warp i % n_consumers
    for (int done = 0; done < count; done += a.stage_rows) {
      mbar_wait(full + 8 * s, parity);
      if (done == 0) {
        TN_CLOCK(2)
      }
      const T* staged = reinterpret_cast<const T*>(smem + s * stage_bytes);
      const int stage_end = min(done + a.stage_rows, count);
      for (; mine < stage_end; mine += n_consumers) {
        const T* row = staged + (mine - done) * a.fp;
        const int local = bf16 ? static_cast<int>(to_f32(row[f_dim + 2 * nc]))
                               : static_cast<int>(to_f32(row[f_dim + nc])) - win * a.w_window;
        const int r = local - band_lo;
        if (r < 0 || r >= rows) continue;  // another block's cell (warp-uniform)
        // a lane's values of g, in registers for rows of up to 32 * kPerLane
        float gv[kPerLane];
        bool nonzero = false;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int col = lane + 32 * k;
          gv[k] = col < f_dim ? to_f32(row[col]) : 0.0f;
          nonzero |= gv[k] != 0.0f;
        }
        for (int col = lane + 32 * kPerLane; col < f_dim; col += 32) nonzero |= to_f32(row[col]) != 0.0f;
        if (!__any_sync(kFull, nonzero)) continue;  // a zero cotangent adds nothing
        any = true;
        float wk[kMaxCorners];
#pragma unroll
        for (int k = 0; k < kMaxCorners; ++k) {
          wk[k] = 0.0f;
          if (k < a.corners) {
            const T* wp = row + f_dim + corner0 + k;
            wk[k] = bf16 ? to_f32(wp[0]) + to_f32(wp[nc]) : to_f32(wp[0]);
          }
        }
        float* cell = tile + r * cols;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int col = lane + 32 * j;
          if (col < f_dim) {
#pragma unroll
            for (int k = 0; k < kMaxCorners; ++k) {
              if (k < a.corners) atomicAdd(cell + k * f_dim + col, wk[k] * gv[j]);
            }
          }
        }
        for (int col = lane + 32 * kPerLane; col < f_dim; col += 32) {
          const float g = to_f32(row[col]);
#pragma unroll
          for (int k = 0; k < kMaxCorners; ++k) {
            if (k < a.corners) atomicAdd(cell + k * f_dim + col, wk[k] * g);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == a.n_stages) {
        s = 0;
        parity ^= 1;
      }
    }
    if (any && lane == 0) any_sample = 1;
    TN_CLOCK(3)
  }
  __syncthreads();
  TN_CLOCK(4)

  if (!split) {
    write_tile<Write::kStore>(tile, dst, rows, cols, width, vector);
  } else if (any_sample) {
    write_tile<Write::kAdd>(tile, dst, rows, cols, width, vector);
  }
  TN_CLOCK(5)
#ifdef TN_ACCUM_CLOCKS
  if (threadIdx.x == 0) atomicAdd(&accum_clocks[kClockPhases], 1ull);
#endif
}

// ---- the accumulation in registers, for windows of up to 64 cells

constexpr int kOwnerWarps = 32;   // warp w owns cells w and w + 32 of the window
constexpr int kOwnerCorners = 4;  // corners a lane's registers hold
constexpr int kOwnerPerLane = 3;  // values of g per lane: rows of up to 96
constexpr int kLast = 1;          // a stage's flags: the last of its work item
constexpr int kSplit = 2;         // the item's window has other items

// What thread 0 tells the block about one staged run of rows.
struct OwnerStage {
  int pw;         // the (projection, window) of the rows' work item; -1: no more work
  int n_rows;     // rows staged (0 for a window without samples)
  int flags;
  int pad;  // to 16 bytes
};

// Thread 0's place in its stream of stages (in shared memory: no registers).
struct OwnerFeed {
  int4 item;           // the current work item: pw, first row, rows, split
  int4 next_item;      // the next one, prefetched with cp.async
  long long src_row;   // the current item's first row in `packed`
  int u;               // the current item's index; the next is u + gridDim.x
  int k;               // the next stage of the current item; -1: the stream has ended
  int slot;            // the ring slot of the next stage
  int n_total;         // work items of the launch
};

// As many blocks of 32 warps as the card has SMs; block b takes the work
// items b, b + gridDim.x, ...  Nothing is summed in shared memory: every
// warp keeps the sums of its two cells in registers (2 x nc x 3 per lane)
// and stores them once per item, so no atomic and no tile are left.  The
// items' rows pass through one ring of stages of 32 * ROUNDS rows, across
// item boundaries, so an item's first rows land while the last item's are
// summed.  Per stage: warp w classifies rows w, w + 32, .. (the window-local
// cell, or -1 if the cotangent is all zero) into a list; after one block
// barrier every warp picks its cells' rows out of the list with ballots and
// adds them.  Thread 0 feeds the ring: the barrier of stage i frees the slot
// of stage i - 1.
template <typename T, int ROUNDS>
__global__ void __launch_bounds__(32 * kOwnerWarps, 1) windowed_accumulate_owner_kernel(const Args a) {
  constexpr int kStageRows = 32 * ROUNDS;
  // [ring: n_stages x kStageRows rows | mbarriers | OwnerStage x n_stages | OwnerFeed | lists]
  extern __shared__ __align__(128) unsigned char smem[];
#ifdef TN_ACCUM_CLOCKS
  unsigned long long clock_at = global_ns();
#endif
  const bool bf16 = sizeof(T) == 2;
  const int f_dim = a.f_dim, nc = a.nc, n_stages = a.n_stages;
  const int stage_bytes = kStageRows * a.fp * static_cast<int>(sizeof(T));
  unsigned char* after = smem + n_stages * stage_bytes;
  const uint32_t ring = smem_u32(smem), full = smem_u32(after);
  OwnerStage* stages = reinterpret_cast<OwnerStage*>(after + 8 * kMaxStages);
  OwnerFeed* fd = reinterpret_cast<OwnerFeed*>(stages + kMaxStages);
  int* lists = reinterpret_cast<int*>(fd + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // thread 0: item fd->u, whose entry is `it`, becomes the current one, and
  // the entry of the one after it is prefetched
  auto enter = [&](const int4 it) {
    fd->item = it;
    fd->src_row = static_cast<long long>(it.x / a.n_windows) * a.m_rows + it.y;
    if (fd->u + static_cast<int>(gridDim.x) < fd->n_total) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(smem_u32(&fd->next_item)),
                   "l"(a.items + fd->u + gridDim.x)
                   : "memory");
    }
  };
  // thread 0: start the copy of the stream's next stage into its slot
  auto feed = [&]() {
    if (fd->k < 0) return;
    const int slot = fd->slot;
    fd->slot = slot + 1 == n_stages ? 0 : slot + 1;
    if (fd->u >= fd->n_total) {  // the end of the stream
      stages[slot].pw = -1;
      mbar_arrive(full + 8 * slot);
      fd->k = -1;
      return;
    }
    const int4 it = fd->item;
    const int row0 = fd->k * kStageRows;
    const int n = max(0, min(kStageRows, it.z - row0));
    const bool last = row0 + n >= it.z;
    OwnerStage d;
    d.pw = it.x;
    d.n_rows = n;
    d.flags = (last ? kLast : 0) | (it.w != 0 ? kSplit : 0);
    d.pad = 0;
    stages[slot] = d;
    const uint32_t bytes = static_cast<uint32_t>(n) * a.fp * sizeof(T);
    if (bytes > 0) {
      mbar_arrive_expect_tx(full + 8 * slot, bytes);
      bulk_copy(ring + slot * stage_bytes,
                static_cast<const T*>(a.packed) + (fd->src_row + row0) * a.fp, bytes, full + 8 * slot);
    } else {  // a window without samples: its zeros are written
      mbar_arrive(full + 8 * slot);
    }
    if (!last) {
      ++fd->k;
      return;
    }
    // on to the next item: its entry was prefetched an item ago
    fd->u += gridDim.x;
    fd->k = 0;
    if (fd->u >= fd->n_total) return;
    asm volatile("cp.async.wait_all;" ::: "memory");
    enter(fd->next_item);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fd->n_total = a.chunk_start[a.n_items];
    fd->u = blockIdx.x;
    fd->k = 0;
    fd->slot = 0;
    if (fd->u < fd->n_total) enter(a.items[fd->u]);
    for (int s = 0; s < n_stages; ++s) feed();
  }
  __syncthreads();
  TN_CLOCK(0)

  float acc[2][kOwnerCorners][kOwnerPerLane];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int k = 0; k < kOwnerCorners; ++k)
#pragma unroll
      for (int j = 0; j < kOwnerPerLane; ++j) acc[c][k][j] = 0.0f;

  int slot = 0;
  uint32_t parity = 0;
  for (int i = 0;; ++i) {
    mbar_wait(full + 8 * slot, parity);
    TN_CLOCK(2)
    const OwnerStage d = stages[slot];
    if (d.pw < 0) break;
    const T* staged = reinterpret_cast<const T*>(smem + slot * stage_bytes);
    int* list = lists + slot * kStageRows;
#pragma unroll
    for (int h = 0; h < ROUNDS; ++h) {  // classify rows warp, warp + 32, ..
      const int r = warp + 32 * h;
      int local = -1;
      if (r < d.n_rows) {
        const T* row = staged + r * a.fp;
        bool nonzero = false;
#pragma unroll
        for (int j = 0; j < kOwnerPerLane; ++j) {
          const int col = lane + 32 * j;
          nonzero |= col < f_dim && to_f32(row[col]) != 0.0f;
        }
        if (__any_sync(kFull, nonzero)) {  // a zero cotangent adds nothing
          // windows are aligned powers of two: the cell's low bits are window-local
          local = static_cast<int>(to_f32(row[f_dim + (bf16 ? 2 : 1) * nc])) & (a.w_window - 1);
        }
      }
      if (lane == 0) list[r] = local;
    }
    __syncthreads();  // the list is whole; and every warp is done with stage i - 1
    TN_CLOCK(1)
    if (threadIdx.x == 0 && i >= 1) feed();
    TN_CLOCK(4)
#pragma unroll
    for (int h = 0; h < ROUNDS; ++h) {
      const int listed = list[32 * h + lane];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        unsigned mine = __ballot_sync(kFull, listed == warp + 32 * c);
        while (mine != 0) {
          const T* row = staged + (32 * h + __ffs(mine) - 1) * a.fp;
          mine &= mine - 1;
          float wk[kOwnerCorners];
#pragma unroll
          for (int k = 0; k < kOwnerCorners; ++k) {
            wk[k] = 0.0f;
            if (k < nc) {
              const T* wp = row + f_dim + k;
              wk[k] = bf16 ? to_f32(wp[0]) + to_f32(wp[nc]) : to_f32(wp[0]);
            }
          }
#pragma unroll
          for (int j = 0; j < kOwnerPerLane; ++j) {
            const int col = lane + 32 * j;
            const float g = col < f_dim ? to_f32(row[col]) : 0.0f;
#pragma unroll
            for (int k = 0; k < kOwnerCorners; ++k) acc[c][k][j] += wk[k] * g;
          }
        }
      }
    }
    TN_CLOCK(3)
    if (d.flags & kLast) {
      // every cell of the window has one owner: its sums (or zeros) are
      // stored once; a split window's are added to the zero base where they
      // are not zero
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cell = warp + 32 * c;
        float* dst = a.out + (static_cast<long long>(d.pw) * a.w_window + cell) * (nc * f_dim);
#pragma unroll
        for (int k = 0; k < kOwnerCorners; ++k) {
#pragma unroll
          for (int j = 0; j < kOwnerPerLane; ++j) {
            const int col = lane + 32 * j;
            if (cell < a.w_window && k < nc && col < f_dim) {
              if (!(d.flags & kSplit)) {
                dst[k * f_dim + col] = acc[c][k][j];
              } else if (acc[c][k][j] != 0.0f) {
                atomicAdd(dst + k * f_dim + col, acc[c][k][j]);
              }
            }
            acc[c][k][j] = 0.0f;
          }
        }
      }
      TN_CLOCK(5)
#ifdef TN_ACCUM_CLOCKS
      if (threadIdx.x == 0) atomicAdd(&accum_clocks[kClockPhases], 1ull);
#endif
    }
    if (++slot == n_stages) {
      slot = 0;
      parity ^= 1;
    }
  }
}

template <typename T, int ROUNDS>
cudaError_t launch_owner(Args a, int max_items, cudaStream_t stream) {
  const int row_bytes = a.fp * static_cast<int>(sizeof(T));
  const long long smem = static_cast<long long>(a.n_stages) * 32 * ROUNDS * row_bytes + 8 * kMaxStages +
                         sizeof(OwnerStage) * kMaxStages + sizeof(OwnerFeed) +
                         4LL * kMaxStages * 32 * ROUNDS;
  if (smem > 227 * 1024 || row_bytes % 16 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(windowed_accumulate_owner_kernel<T, ROUNDS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, n_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = max_items < n_sm ? max_items : n_sm;  // one block per SM
  windowed_accumulate_owner_kernel<T, ROUNDS>
      <<<grid, 32 * kOwnerWarps, static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Args a, int max_items, int threads, cudaStream_t stream) {
  const int row_bytes = a.fp * static_cast<int>(sizeof(T));
  const long long smem = static_cast<long long>(a.n_stages) * a.stage_rows * row_bytes +
                         ((a.rows * a.corners * a.f_dim + 3) & ~3) * 4LL + 2 * 8 * kMaxStages;
  if (smem > 227 * 1024 || row_bytes % 16 != 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(windowed_accumulate_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  windowed_accumulate_kernel<T>
      <<<static_cast<unsigned>(max_items) * a.n_split, threads, static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [n_proj, n_windows * w_window, nc * f_dim] f32, uninitialized: every
// element is written.  packed [n_proj, m_rows, fp], f32 (bf16_payload = 0)
// or bf16 (= 1), rows of a multiple of 16 bytes; chunk_start [n_proj *
// n_windows + 4 + 4 * max_items] int32 scratch (the scan, then, 16-byte
// aligned, the item table);
// max_items >= the number of chunks, sum over the windows of max(1,
// ceil(count / chunk)) (the grid).  w_window must be
// a power of two.  A block's tile takes at most tile_bytes of shared memory
// (as many whole corners of the window as fit, else one corner of fewer
// cells), its ring n_stages (<= 8) stages of stage_rows rows; it runs
// `threads` threads (a multiple of 32, 64..1024: the last warp stages).
// With owner_stages > 0, windows of up to 64 cells x up to 4 corners x up to
// 96 values go to the kernel that sums in registers, its ring owner_stages
// (2..8) stages of 32 * owner_rounds (1, 2 or 4) rows.
int tn_windowed_accumulate(const void* packed, const void* offsets, void* chunk_start,
                           int max_items, int chunk, int n_proj, int m_rows, int fp, int f_dim,
                           int nc, int n_windows, int w_window, int bf16_payload, int tile_bytes,
                           int n_stages, int stage_rows, int threads, int owner_stages,
                           int owner_rounds, void* out, void* stream) {
  if (n_proj <= 0 || n_windows <= 0) return 0;
  if (w_window < 1 || (w_window & (w_window - 1)) != 0 || nc < 1 || nc > kMaxCorners ||
      f_dim < 1 || max_items <= 0 || chunk <= 0 || n_stages < 1 || n_stages > kMaxStages ||
      stage_rows < 1 || threads < 64 || threads > kMaxThreads || threads % 32 != 0 ||
      owner_stages < 0 || owner_stages == 1 || owner_stages > kMaxStages || owner_rounds < 1 ||
      (owner_rounds != 1 && owner_rounds != 2 && owner_rounds != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.packed = packed;
  a.chunk_start = static_cast<const int*>(chunk_start);
  // the item table follows the scan, 16-byte aligned
  int4* items = reinterpret_cast<int4*>(static_cast<int*>(chunk_start) + ((n_proj * n_windows + 4) & ~3));
  a.items = items;
  a.out = static_cast<float*>(out);
  a.chunk = chunk;
  a.n_items = n_proj * n_windows;
  a.m_rows = m_rows;
  a.fp = fp;
  a.f_dim = f_dim;
  a.nc = nc;
  a.n_windows = n_windows;
  a.w_window = w_window;
  // the tile: all cells of the window x the most corners (a divisor of nc)
  // that fit; if one corner does not fit, fewer cells of it
  const long long corner_bytes = static_cast<long long>(w_window) * f_dim * 4;
  a.corners = nc;
  while (a.corners > 1 && (nc % a.corners != 0 || a.corners * corner_bytes > tile_bytes)) --a.corners;
  a.rows = w_window;
  while (a.rows > 1 && static_cast<long long>(a.rows) * a.corners * f_dim * 4 > tile_bytes) a.rows >>= 1;
  a.n_split = (nc / a.corners) * (w_window / a.rows);
  a.n_stages = n_stages;
  a.stage_rows = stage_rows;

  const int* off = static_cast<const int*>(offsets);
  windowed_chunk_scan_kernel<<<1, kScanThreads, 0, st>>>(off, a.n_items, n_windows, chunk,
                                                         static_cast<int*>(chunk_start));
  windowed_item_table_kernel<<<a.n_items, 256, 0, st>>>(off, a.chunk_start, n_windows, chunk, items,
                                                        a.out, w_window * nc * f_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (owner_stages > 0 && w_window <= 2 * kOwnerWarps && nc <= kOwnerCorners &&
      f_dim <= 32 * kOwnerPerLane) {  // the sums fit the owner kernel's registers
    a.n_stages = owner_stages;
    if (owner_rounds == 1) {
      err = bf16_payload ? launch_owner<__nv_bfloat16, 1>(a, max_items, st)
                         : launch_owner<float, 1>(a, max_items, st);
    } else if (owner_rounds == 2) {
      err = bf16_payload ? launch_owner<__nv_bfloat16, 2>(a, max_items, st)
                         : launch_owner<float, 2>(a, max_items, st);
    } else {
      err = bf16_payload ? launch_owner<__nv_bfloat16, 4>(a, max_items, st)
                         : launch_owner<float, 4>(a, max_items, st);
    }
  } else {
    err = bf16_payload ? launch<__nv_bfloat16>(a, max_items, threads, st)
                       : launch<float>(a, max_items, threads, st);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef TN_ACCUM_CLOCKS
// out [7] uint64 on the host: the nanoseconds summed per phase since the last
// call, then the blocks counted; the counters are set to 0.
int tn_accum_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, accum_clocks, sizeof(accum_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zeros[kClockPhases + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(accum_clocks, zeros, sizeof(zeros)));
}
#endif

}  // extern "C"
