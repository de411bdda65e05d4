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
// each item's window, first row and rows, and its place in its window.  No
// sum depends on the order in which blocks run, so two runs give the same
// bits: an unsplit window's sums, and the first item's of a window that is
// split into several, are stored into the output; each later item of a
// split window stores its partial sums into a slot of scratch of its own
// (item u of window pw: slot u - pw - 1), with a flag per owner of cells
// that says whether they are not all zero; windowed_combine_kernel then adds
// the flagged partials to the output in item order.  An item whose rows all
// have a zero cotangent (the pad tail's) flags nothing and costs the
// combine nothing.  An item's rows are one
// contiguous run: both kernels below stage it in shared memory with 1-D bulk
// asynchronous copies (cp.async.bulk) that complete on an mbarrier per
// stage, so that no device-memory round trip is left in a warp's loop, each
// sample is read once, and a row whose cotangent is all zero (the packed
// buffer's pad tail: up to half the samples, all in one cell) is skipped on
// the staged row.
//   * windowed_accumulate_owner_kernel, for windows of up to 64 cells x 4
//     corners x 96 values (K-Planes: the caller sorts by windows of 64
//     cells), or x 8 corners of up to 64 values in all (Cobafa's oct
//     rows, 8 corners x F = 8, 6 or 4: a lane holds two of the row's flat
//     columns).  Nothing is summed in shared memory: each of a block's
//     32 warps owns two cells of the window and keeps their sums in
//     registers, so there is no atomic, no tile to zero and no second copy
//     of the sums, and each cell's sum runs in sample order.  One resident
//     block per SM walks its share of the items; the ring of stages runs
//     across item boundaries.
//   * windowed_accumulate_kernel, for every other shape: one block holds
//     the window's f32 tile [W, nc*F] in shared memory (or, if it does not
//     fit, one of n_split = (nc / corners) * (W / rows) blocks holds
//     `corners` whole corners of `rows` cells and skips the other cells'
//     samples); a producer warp feeds the ring, the consumer warps add a row
//     each at a time with shared-memory f32 atomics (a compare-and-swap loop
//     in hardware, ATOMS.CAST.SPIN: its rate bounds this kernel).  Those
//     atomics sum a cell's rows in an order that can change from run to
//     run; no training path of the three fields takes this kernel (windows
//     of more than 64 cells, or rows too wide for the owner kernel).
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
                  int* __restrict__ chunk_start, int* __restrict__ split) {
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
  if (threadIdx.x == 0) {
    chunk_start[0] = 0;
    split[0] = 0;  // the split windows' count, for the item table kernel
  }
}

// Block pw lists window pw's chunks in `items`: per chunk (pw, its first
// row in the projection's sorted samples, its rows, its tag: 0 if it is the
// window's only chunk, else its index in the window + 1); and a split window
// appends pw to `split` (split[0] the count; the list's order is the blocks',
// which no sum depends on).
__global__ void windowed_item_table_kernel(const int* __restrict__ offsets,
                                           const int* __restrict__ chunk_start, int n_windows,
                                           int chunk, int4* __restrict__ items, int* __restrict__ split) {
  const int pw = blockIdx.x;
  const int first = chunk_start[pw], n_chunks = chunk_start[pw + 1] - first;
  if (threadIdx.x == 0 && n_chunks > 1) split[1 + atomicAdd(split, 1)] = pw;
  const int* off = offsets + (pw / n_windows) * (n_windows + 1) + pw % n_windows;
  const int begin = off[0], end = off[1];
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    const int start = begin + c * chunk;
    items[first + c] = make_int4(pw, start, min(end, start + chunk) - start, n_chunks > 1 ? c + 1 : 0);
  }
}

// The partial-sum slot of work item `item` of window pw with tag `tag`: -1
// for the items whose sums are stored into the output (an unsplit window's,
// a split window's first), else item - pw - 1 (a window of k items has k - 1
// slots, and the items before window pw have chunk_start[pw] - pw).
__device__ __forceinline__ int partial_slot(int item, int pw, int tag, int max_slots) {
  if (tag < 2) return -1;
  const int slot = item - pw - 1;
  if (slot >= max_slots) __trap();  // the wrapper's bound was wrong
  return slot;
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
  float* partials;  // [max_slots, w_window, nc * f_dim]: the later items' partial sums
  int* flags;       // [max_slots, flag_stride]: which owners' partials are not all zero
  int max_slots, flag_stride;
};

enum class Write { kStore, kZeros };

// The block's tile [rows, cols] (in shared memory, or zeros) into the
// output rows of `width` floats, 16 bytes a thread where f_dim allows.
template <Write MODE>
__device__ __forceinline__ void write_tile(const float* tile, float* dst, int rows, int cols,
                                           int width, bool vector) {
  if (vector) {
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
    dst[static_cast<long long>(t / cols) * width + t % cols] = MODE == Write::kStore ? tile[t] : 0.0f;
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
  const int slot = partial_slot(item, pw, it.w, a.max_slots);
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

  if (slot < 0) {
    write_tile<Write::kStore>(tile, dst, rows, cols, width, vector);
  } else {
    // a later item of a split window: its partial sums, flagged, into its slot
    if (threadIdx.x == 0) a.flags[static_cast<long long>(slot) * a.flag_stride + part] = any_sample;
    if (any_sample) {
      const long long off = dst - (a.out + static_cast<long long>(pw) * a.w_window * width);
      write_tile<Write::kStore>(tile, a.partials + static_cast<long long>(slot) * a.w_window * width + off,
                                rows, cols, width, vector);
    }
  }
  TN_CLOCK(5)
#ifdef TN_ACCUM_CLOCKS
  if (threadIdx.x == 0) atomicAdd(&accum_clocks[kClockPhases], 1ull);
#endif
}

// ---- the accumulation in registers, for windows of up to 64 cells

constexpr int kOwnerWarps = 32;   // warp w owns cells w and w + 32 of the window
constexpr int kOwnerCorners = 4;  // corners a lane's registers hold (by-value layout)
constexpr int kOwnerPerLane = 3;  // values of g per lane: rows of up to 96
constexpr int kFlatPerLane = 2;   // flat columns per lane (flat layout): rows of up to 64 values
constexpr int kLast = 1;          // a stage's flags: the last of its work item

// What thread 0 tells the block about one staged run of rows.
struct OwnerStage {
  int pw;         // the (projection, window) of the rows' work item; -1: no more work
  int n_rows;     // rows staged (0 for a window without samples)
  int flags;
  int slot;       // the item's partial-sum slot, -1: its sums go to the output
};

// Thread 0's place in its stream of stages (in shared memory: no registers).
struct OwnerFeed {
  int4 item;           // the current work item: pw, first row, rows, tag
  int4 next_item;      // the next one, prefetched with cp.async
  long long src_row;   // the current item's first row in `packed`
  int u;               // the current item's index; the next is u + gridDim.x
  int k;               // the next stage of the current item; -1: the stream has ended
  int slot;            // the ring slot of the next stage
  int n_total;         // work items of the launch
};

// As many blocks of 32 warps as the card has SMs; block b takes the work
// items b, b + gridDim.x, ...  Nothing is summed in shared memory: every
// warp keeps the sums of its two cells in registers and stores them once
// per item, so no atomic and no tile are left.  Two layouts of a lane's
// registers: by value (FLAT false: a lane holds values lane, lane + 32,
// lane + 64 of g for each of up to 4 corners, 2 x 4 x 3 sums: K-Planes'
// rows of 4 corners x up to 96) or flat (FLAT true: a lane holds the row's
// flat columns lane and lane + 32, corner c / F, value c % F, 2 x 2 sums:
// Cobafa's oct rows of 8 corners x F <= 8).  The items' rows pass through
// one ring of stages of 32 * ROUNDS rows, across item boundaries, so an
// item's first rows land while the last item's are summed.  Per stage:
// warp w classifies rows w, w + 32, .. (the window-local cell, or -1 if
// the cotangent is all zero) into a list; after one block barrier every
// warp picks its cells' rows out of the list with ballots, in row order,
// and adds them.  Thread 0 feeds the ring: the barrier of stage i frees the
// slot of stage i - 1.
template <typename T, int ROUNDS, bool FLAT>
__global__ void __launch_bounds__(32 * kOwnerWarps, 1) windowed_accumulate_owner_kernel(const Args a) {
  constexpr int kStageRows = 32 * ROUNDS;
  constexpr int kSums = FLAT ? kFlatPerLane : kOwnerCorners * kOwnerPerLane;  // per cell
  // [ring: n_stages x kStageRows rows | mbarriers | OwnerStage x n_stages | OwnerFeed | lists]
  extern __shared__ __align__(128) unsigned char smem[];
#ifdef TN_ACCUM_CLOCKS
  unsigned long long clock_at = global_ns();
#endif
  const bool bf16 = sizeof(T) == 2;
  const int f_dim = a.f_dim, nc = a.nc, n_stages = a.n_stages, width = nc * f_dim;
  const int stage_bytes = kStageRows * a.fp * static_cast<int>(sizeof(T));
  unsigned char* after = smem + n_stages * stage_bytes;
  const uint32_t ring = smem_u32(smem), full = smem_u32(after);
  OwnerStage* stages = reinterpret_cast<OwnerStage*>(after + 8 * kMaxStages);
  OwnerFeed* fd = reinterpret_cast<OwnerFeed*>(stages + kMaxStages);
  int* lists = reinterpret_cast<int*>(fd + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the flat layout's corner and value of each of a lane's columns (the
  // by-value layout's are constants of the unrolled loops)
  int corner_of[FLAT ? kSums : 1], value_of[FLAT ? kSums : 1];
  if constexpr (FLAT) {
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      const int col = lane + 32 * q;
      corner_of[q] = col < width ? col / f_dim : 0;
      value_of[q] = col < width ? col % f_dim : 0;
    }
  }
  // the output column of a lane's sum q in the row of nc * f_dim values, or
  // -1 past the row
  auto col_of = [&](int q) {
    if constexpr (FLAT) {
      const int col = lane + 32 * q;
      return col < width ? col : -1;
    } else {
      const int k = q / kOwnerPerLane, j = lane + 32 * (q % kOwnerPerLane);
      return k < nc && j < f_dim ? k * f_dim + j : -1;
    }
  };

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
    d.flags = last ? kLast : 0;
    d.slot = partial_slot(fd->u, it.x, it.w, a.max_slots);
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

  float acc[2][kSums];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[c][q] = 0.0f;

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
        while (mine != 0) {  // the warp's rows for cell c, in row order
          const T* row = staged + (32 * h + __ffs(mine) - 1) * a.fp;
          mine &= mine - 1;
          if constexpr (FLAT) {
#pragma unroll
            for (int q = 0; q < kSums; ++q) {
              if (col_of(q) >= 0) {
                const T* wp = row + f_dim + corner_of[q];
                const float w = bf16 ? to_f32(wp[0]) + to_f32(wp[nc]) : to_f32(wp[0]);
                acc[c][q] += w * to_f32(row[value_of[q]]);
              }
            }
          } else {
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
              for (int k = 0; k < kOwnerCorners; ++k) acc[c][k * kOwnerPerLane + j] += wk[k] * g;
            }
          }
        }
      }
    }
    TN_CLOCK(3)
    if (d.flags & kLast) {
      // every cell of the window has one owner: its sums (or zeros) are
      // stored once, into the output, or a split window's later item's into
      // its slot, flagged, where the warp's are not all zero
      bool store = true;
      float* base = a.out + static_cast<long long>(d.pw) * a.w_window * width;
      if (d.slot >= 0) {
        bool any = false;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < kSums; ++q) any |= acc[c][q] != 0.0f;
        store = __any_sync(kFull, any);
        if (lane == 0) a.flags[static_cast<long long>(d.slot) * a.flag_stride + warp] = store;
        base = a.partials + static_cast<long long>(d.slot) * a.w_window * width;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cell = warp + 32 * c;
#pragma unroll
        for (int q = 0; q < kSums; ++q) {
          const int col = col_of(q);
          if (store && cell < a.w_window && col >= 0) base[cell * width + col] = acc[c][q];
          acc[c][q] = 0.0f;
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

// ---- the split windows' later items, added to the output in item order

constexpr int kCombineThreads = 256;
constexpr int kCombinePerThread = 8;  // output values a thread holds
constexpr int kCombineTile = kCombineThreads * kCombinePerThread;  // values of a window per work unit
constexpr int kCombineSlots = 1024;  // slots whose flags one pass reads
constexpr int kCombineBatch = 4;     // live slots whose values a thread loads before adding them

// Whether slot `flag`'s owners flagged anything: the register kernel's 32
// flags by eight 16-byte loads in flight together.
__device__ __forceinline__ bool slot_live(const int* flag, bool owner, int n_flags) {
  int any = 0;
  if (owner) {
    const int4* f4 = reinterpret_cast<const int4*>(flag);
#pragma unroll
    for (int q = 0; q < kOwnerWarps / 4; ++q) {
      const int4 f = f4[q];
      any |= f.x | f.y | f.z | f.w;
    }
  } else {
    for (int t = 0; t < n_flags; ++t) any |= flag[t];
  }
  return any != 0;
}

// A work unit is one tile of kCombineTile values of one split window (the
// list `split` of the item table kernel); block b takes units b, b +
// gridDim.x, ...  The block reads every slot's flags at once (a thread per
// slot) and lists the live slots in item order in shared memory; then each
// thread adds them to the values the window's first item stored, which it
// holds in registers, kCombineBatch slots' values loaded at a time and
// added one slot after the other, so every sum has one order.  A slot none
// of whose owners is flagged (the pad tail's) costs its flags' read.  A
// value's owner is its cell's warp (cell % 32) for the register kernel, its
// block's part for the tile kernel.
__global__ void __launch_bounds__(kCombineThreads)
windowed_combine_kernel(const Args a, bool owner, const int* __restrict__ split) {
  __shared__ int live_list[kCombineSlots];
  __shared__ int warp_live[kCombineThreads / 32];
  const int width = a.nc * a.f_dim, window_floats = a.w_window * width;
  const int corner_parts = a.nc / a.corners, cols = a.corners * a.f_dim;
  const int n_flags = owner ? kOwnerWarps : a.n_split;
  const int tiles = (window_floats + kCombineTile - 1) / kCombineTile;
  const int n_units = split[0] * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {  // block-uniform
    const int pw = split[1 + u / tiles], e0 = (u % tiles) * kCombineTile;
    const int first = a.chunk_start[pw], n_chunks = a.chunk_start[pw + 1] - first;
    const long long slot0 = first - pw;  // the slot of the window's second item
    float* dst = a.out + static_cast<long long>(pw) * window_floats;
    float v[kCombinePerThread];
    int who[kCombinePerThread];
#pragma unroll
    for (int k = 0; k < kCombinePerThread; ++k) {
      const int t = e0 + threadIdx.x + k * kCombineThreads;
      v[k] = t < window_floats ? dst[t] : 0.0f;
      const int cell = t / width, col = t % width;
      who[k] = t >= window_floats ? -1
               : owner ? cell & (kOwnerWarps - 1) : (cell / a.rows) * corner_parts + col / cols;
    }
    for (int base = 1; base < n_chunks; base += kCombineSlots) {
      const int n_here = min(kCombineSlots, n_chunks - base);
      // the live slots of this pass, listed in item order
      int n_live = 0;
      for (int r = 0; r < kCombineSlots; r += kCombineThreads) {  // block-uniform
        const int i = r + threadIdx.x;
        const bool live =
            i < n_here && slot_live(a.flags + (slot0 + base - 1 + i) * a.flag_stride, owner, n_flags);
        const unsigned ballot = __ballot_sync(kFull, live);
        if (lane == 0) warp_live[warp] = __popc(ballot);
        __syncthreads();
        int before = n_live;
        for (int w = 0; w < warp; ++w) before += warp_live[w];
        if (live) live_list[before + __popc(ballot & ((1u << lane) - 1u))] = i;
        for (int w = 0; w < kCombineThreads / 32; ++w) n_live += warp_live[w];
        __syncthreads();
      }
      for (int j = 0; j < n_live; j += kCombineBatch) {
        float add[kCombineBatch][kCombinePerThread];
        bool use[kCombineBatch][kCombinePerThread];
#pragma unroll
        for (int q = 0; q < kCombineBatch; ++q) {
          const bool in = j + q < n_live;
          const long long slot = slot0 + base - 1 + (in ? live_list[j + q] : 0);
          const int* flag = a.flags + slot * a.flag_stride;
          const float* src = a.partials + slot * window_floats;
#pragma unroll
          for (int k = 0; k < kCombinePerThread; ++k) {
            use[q][k] = in && who[k] >= 0 && flag[who[k]] != 0;
            add[q][k] = use[q][k] ? src[e0 + threadIdx.x + k * kCombineThreads] : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kCombineBatch; ++q)
#pragma unroll
          for (int k = 0; k < kCombinePerThread; ++k)
            if (use[q][k]) v[k] += add[q][k];
      }
      __syncthreads();  // before `live_list` is written again
    }
#pragma unroll
    for (int k = 0; k < kCombinePerThread; ++k) {
      if (who[k] >= 0) dst[e0 + threadIdx.x + k * kCombineThreads] = v[k];
    }
  }
}

template <typename T, int ROUNDS, bool FLAT>
cudaError_t launch_owner(Args a, int max_items, cudaStream_t stream) {
  const int row_bytes = a.fp * static_cast<int>(sizeof(T));
  const long long smem = static_cast<long long>(a.n_stages) * 32 * ROUNDS * row_bytes + 8 * kMaxStages +
                         sizeof(OwnerStage) * kMaxStages + sizeof(OwnerFeed) +
                         4LL * kMaxStages * 32 * ROUNDS;
  if (smem > 227 * 1024 || row_bytes % 16 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(windowed_accumulate_owner_kernel<T, ROUNDS, FLAT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, n_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = max_items < n_sm ? max_items : n_sm;  // one block per SM
  windowed_accumulate_owner_kernel<T, ROUNDS, FLAT>
      <<<grid, 32 * kOwnerWarps, static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool FLAT>
cudaError_t launch_owner_rounds(Args a, int max_items, int rounds, cudaStream_t stream) {
  if (rounds == 1) return launch_owner<T, 1, FLAT>(a, max_items, stream);
  if (rounds == 2) return launch_owner<T, 2, FLAT>(a, max_items, stream);
  return launch_owner<T, 4, FLAT>(a, max_items, stream);
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
// n_windows + 4 + 4 * max_items + n_proj * n_windows + 1] int32 scratch
// (the scan, then, 16-byte aligned, the item table, then the list of split
// windows);
// max_items >= the number of chunks, sum over the windows of max(1,
// ceil(count / chunk)) (the grid), then n_proj * n_windows + 1 more (the
// split windows' list).  partials [max_slots, w_window, nc *
// f_dim] f32 and flags [flag_capacity] int32, scratch for the split
// windows' later items: max_slots >= n_proj * (m_rows / chunk) bounds them
// (a window of c > chunk samples has ceil(c / chunk) - 1 < c / chunk), and
// flag_capacity >= max_slots * max(32, nc * w_window).  w_window must be
// a power of two.  A block's tile takes at most tile_bytes of shared memory
// (as many whole corners of the window as fit, else one corner of fewer
// cells), its ring n_stages (<= 8) stages of stage_rows rows; it runs
// `threads` threads (a multiple of 32, 64..1024: the last warp stages).
// With owner_stages > 0, windows of up to 64 cells x up to 4 corners x up to
// 96 values, or x up to 8 corners of up to 64 values in all, go to the
// kernel that sums in registers, its ring owner_stages (2..8) stages of 32 *
// owner_rounds (1, 2 or 4) rows.
int tn_windowed_accumulate(const void* packed, const void* offsets, void* chunk_start,
                           int max_items, int chunk, int n_proj, int m_rows, int fp, int f_dim,
                           int nc, int n_windows, int w_window, int bf16_payload, int tile_bytes,
                           int n_stages, int stage_rows, int threads, int owner_stages,
                           int owner_rounds, void* partials, int max_slots, void* flags,
                           long long flag_capacity, void* out, void* stream) {
  if (n_proj <= 0 || n_windows <= 0) return 0;
  if (w_window < 1 || (w_window & (w_window - 1)) != 0 || nc < 1 || nc > kMaxCorners ||
      f_dim < 1 || max_items <= 0 || chunk <= 0 || n_stages < 1 || n_stages > kMaxStages ||
      stage_rows < 1 || threads < 64 || threads > kMaxThreads || threads % 32 != 0 ||
      owner_stages < 0 || owner_stages == 1 || owner_stages > kMaxStages || owner_rounds < 1 ||
      (owner_rounds != 1 && owner_rounds != 2 && owner_rounds != 4) ||
      max_slots < n_proj * (m_rows / chunk) ||
      flag_capacity < static_cast<long long>(max_slots) * (nc * w_window > 32 ? nc * w_window : 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.packed = packed;
  a.chunk_start = static_cast<const int*>(chunk_start);
  // the item table follows the scan, 16-byte aligned
  int4* items = reinterpret_cast<int4*>(static_cast<int*>(chunk_start) + ((n_proj * n_windows + 4) & ~3));
  int* split = reinterpret_cast<int*>(items + max_items);
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
  a.partials = static_cast<float*>(partials);
  a.flags = static_cast<int*>(flags);
  a.max_slots = max_slots;

  const int* off = static_cast<const int*>(offsets);
  windowed_chunk_scan_kernel<<<1, kScanThreads, 0, st>>>(off, a.n_items, n_windows, chunk,
                                                         static_cast<int*>(chunk_start), split);
  windowed_item_table_kernel<<<a.n_items, 256, 0, st>>>(off, a.chunk_start, n_windows, chunk, items, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the sums fit the owner kernel's registers, by value or flat
  const bool by_value = nc <= kOwnerCorners && f_dim <= 32 * kOwnerPerLane;
  const bool flat = nc * f_dim <= 32 * kFlatPerLane;
  const bool owner = owner_stages > 0 && w_window <= 2 * kOwnerWarps && (by_value || flat);
  a.flag_stride = owner ? kOwnerWarps : (a.n_split > 32 ? a.n_split : 32);
  if (owner) {
    a.n_stages = owner_stages;
    if (by_value) {
      err = bf16_payload ? launch_owner_rounds<__nv_bfloat16, false>(a, max_items, owner_rounds, st)
                         : launch_owner_rounds<float, false>(a, max_items, owner_rounds, st);
    } else {
      err = bf16_payload ? launch_owner_rounds<__nv_bfloat16, true>(a, max_items, owner_rounds, st)
                         : launch_owner_rounds<float, true>(a, max_items, owner_rounds, st);
    }
  } else {
    err = bf16_payload ? launch<__nv_bfloat16>(a, max_items, threads, st)
                       : launch<float>(a, max_items, threads, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_slots > 0) {  // two blocks per SM walk the split windows' tiles
    int device = 0, n_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    windowed_combine_kernel<<<2 * n_sm, kCombineThreads, 0, st>>>(a, owner, split);
  }
  return static_cast<int>(cudaGetLastError());
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
