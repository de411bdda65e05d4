// Cell-packed table builds, in bf16 or f32 (the quad build also in
// float8_e4m3fn), and the oct build's transpose:
//   oct:  [r0, r1, r2, F] f32 -> [(r0-1)(r1-1)(r2-1), 8F]  (Cobafa's grids)
//   quad: [r0, r1, F] f32     -> [(r0-1)(r1-1), 4F]         (K-Planes' planes)
//   fold: [(r0-1)(r1-1)(r2-1), 8F] f32 -> [r0, r1, r2, F]  (Cobafa's grid gradients)
//
// The oct build replaces tinynerf_tpu/ops/octbuild.py:_oct_kernel_mxu, the
// Pallas TPU kernel behind build_oct_pallas: row (i, j, k) of the cell grid
// holds the cell's eight corner rows table[i+dx, j+dy, k+dz, :] in corner
// order (dx, dy, dz) with dz fastest, then dy, then dx, each value rounded
// once to the output type (bf16 by __float2bfloat16_rn, round to nearest
// even, as torch's Tensor.to(torch.bfloat16) rounds), so the result is
// bit-equal to the plain version (ops/octbuild.py:build_oct_plain).
//
// What bounds it on an H100: memory, by the output write.  It is a pure
// relayout: each table value is read once and written eight times.  Over
// the Cobafa field's seven grids (bases 32..128^3 with 8 or 4 channels,
// coefficients 64^3 x 6) that is ~426 MB of bf16 output and ~88 MB of f32
// input per field call, ~0.15 ms at an H100 SXM's published 3.35 TB/s (700 W
// limit).  A kernel that gathers each output value on its own (a scalar
// load, 64-bit address arithmetic and five integer divisions for every 16
// bytes stored, every table value loaded and rounded eight times) is held
// by its instructions, not by those bytes: with its stores taken out it
// ran no faster, and its index arithmetic alone took more than the bytes'
// time (PERF.md has the measured times of both designs, on an NVIDIA H100
// 80GB HBM3 at 700 W).
//
// Design.  The TPU kernel dilates lanes with one-hot MXU matmuls because its
// vector unit wastes 124 of 128 lanes on a 4-channel minor axis; nothing
// here needs that.  What the layout offers instead: for a fixed (i, j) the
// output rows k = 0 .. r2-2 are ONE contiguous run of (r2-1) 8F values made
// from FOUR contiguous table lines table[i+dx, j+dy, :, :] of r2 F values,
// and within row k the corner pair (dx, dy) is the 2F contiguous values
// line[dx][dy][k F : k F + 2F] (dz = 0, 1).  So:
//   * a block takes one i and a band of j.  It stages the band's lines of
//     slabs i and i+1 in shared memory (the band's lines of a slab are one
//     contiguous run of the table: 16-byte loads), rounding each value to
//     the output type ONCE on the way in.  Neighbouring blocks stage the
//     same lines again, from L2: measured, small blocks that overlap each
//     other's two phases beat a block that walks over i and keeps a slab
//     (a band of 2 cells and no walk was the fastest shape);
//   * a thread then assembles whole 16-byte output chunks from shared memory
//     with the widest loads the channel count allows (F = 8, or 4 in f32:
//     one 16-byte load; F = 4 in bf16: two of 8 bytes; F = 6: 4- or 8-byte
//     loads, since chunks cross a corner pair there; any other F: value by
//     value) and stores them coalesced.  The only division left per chunk
//     is by the channel count, a compile-time constant for F = 4, 6, 8; the
//     row's (j, k) comes from a multiplication by a host-made reciprocal;
//   * lines and slabs are padded in shared memory so that the four corner
//     pairs of a row fall into different banks.
// A row of 8F values is always a whole number of 16-byte chunks (16F bytes
// in bf16, 32F in f32), so any F and any grid shape works, as long as two
// slabs of two lines fit in shared memory.

// The quad build replaces tinynerf_tpu/ops/octbuild.py:_quad_kernel, the
// Pallas TPU kernel behind build_quad_pallas: row (i, j) holds the four
// corner rows table[i+dx, j+dy, :] in corner order (dx, dy) with dy fastest,
// each value rounded once to bf16, f32 or float8_e4m3fn (the K-Planes
// field's gather_dtype), bit-equal to ops/octbuild.py:build_quad_plain.
// Memory bounds it: each value is read once and written four times.  The
// K-Planes field builds nine planes per call (129, 257 and 513^2 x 32, three
// projections): 132.8 MB read and 264.2 MB of bf16 written (528.4 MB of f32,
// 132.1 MB of float8), ~0.119 ms (0.197, 0.079) at 3.35 TB/s.
//
// Design.  The TPU kernel stores four lane-offset slices of two table rows
// per grid step.  Here the layout does the work: the corner pair dx of row
// (i, j) is one contiguous run of 2F table values, table[i+dx, j : j+2, :],
// so the rows of cells (i, j0 .. j0+band-1) are read from lines i and i+1
// from cell j0 on, and written as one contiguous run of the output.
//   * vector path (F = 32, 64 or 96 and the table on a 16-byte boundary, which the
//     wrapper checks and the entry point enforces): a block takes
//     `lines` cells of i (blockIdx.y) by `band` cells of j (blockIdx.x), so
//     no division finds a row.  It stages its lines + 1 table lines' runs
//     of (band + 1) F values in shared memory by coalesced float4 loads,
//     rounding each value once on the way in (bf16 two at a time, float8 by
//     JAX's rule below: a cast per staged value, about 1.3 per table value
//     at the default shape, where reading straight from global memory cast
//     each value four times), then copies whole 16-byte chunks (8 bf16, 4
//     f32 or 16 float8 values) to the output, each one 16-byte read of one
//     corner pair's run.  It is written for F a compile-time constant (the
//     row and chunk splits are then shifts or multiplications): 32, every
//     K-Planes plane, and 96, the fused fine table of fwd_mode="fusedfine"
//     (three scales of 32 upsampled to 513^2, one table per projection:
//     101 MB of f32 read, 201 MB of bf16 written, ~0.09 ms at 3.35 TB/s),
//     and 64 between them;
//   * generic path (any other F, or a table off a 16-byte boundary such as
//     a view with a storage offset): value by value, a thread writing 4
//     values (4, 8 or 16 bytes); a row of 4F values is F such chunks.
// Measured on the nine planes (device ms, NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py phase 2 and tools/profile_weights_oct_torch.py, PERF.md):
// bf16 0.1505, f32 0.2418, float8 0.1163, 79%, 82% and 68% of the bytes'
// bound, 89%, 92% and 79% of the card's own contiguous copy of as many
// bytes; the first design (a thread per 4-value chunk, a scalar load per
// value) took 0.2158, 0.2607 and 0.2425.  Reading the runs straight from
// global memory with float4 loads (tools/quadbuild_probe_torch.cu) gave
// bf16 and f32 times within 3% of these but float8 0.135: its cast, four
// per table value there, held it.
// The float8 cast is JAX's rule (to_bits(float, uint8_t) below, bit-equal to
// ops/octbuild.py:to_float8_e4m3fn), not __nv_cvt_float_to_fp8: JAX rounds
// |x| > 464 and +-inf to NaN and 464 to 448, which neither of that
// intrinsic's saturation modes gives.

// The fold replaces the eight pad-adds of tinynerf_tpu/ops/interp.py:474
// (`_trilinear_oct_bwd`), the transpose of the oct build: the cell gradient
// gq [(r0-1)(r1-1)(r2-1), 8F] f32 back onto the grid [r0, r1, r2, F],
// grad[x, y, z, v] = 0 + the sum over the corners (dx, dy, dz) in
// CORNERS_3D order of gq[(x-dx, y-dy, z-dz), c F + v], a term outside the
// cell grid left out.  Each f32 add is rounded once, in that order, so the
// result is bit-equal to the plain version (ops/octbuild.py:oct_fold_plain)
// and to the JAX loop (whose pads add +0: a sum that starts at +0 is never
// -0, so adding +0 changes nothing).
// What bounds it on an H100: memory.  gq is read once (0.68 GB over the
// Cobafa field's seven grids) and the grids written once (0.085 GB): ~0.23
// ms at 3.35 TB/s, in one launch per grid where the plain version makes a
// zero fill and eight strided read-modify-write passes.  Design: a block
// takes a run of one grid line (x, y), a thread one value (z, v); its eight
// corners' loads are issued together, then added in order.  A warp's loads
// of one corner touch half of each 32-byte sector of consecutive cell rows:
// the next corner (dz) reads the other half from L1, and the rows that the
// lines x+1 and y+1 read again come from L2, where the neighbouring blocks
// left them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint16_t to_bits(float v, uint16_t) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t to_bits(float v, uint32_t) { return __float_as_uint(v); }

// f32 -> float8_e4m3fn (1 sign, 4 exponent bits of bias 7, 3 mantissa bits;
// 0x7F is NaN) as JAX casts: nearest even, as if the code above 448 were
// 480, and that code is NaN.  Normals: the f32 bits' low 20 mantissa bits
// rounded away (a carry moves the exponent), the exponent rebiased from 127
// to 7; subnormals (|x| < 2^-6) count steps of 2^-9, rounded to even by the
// f32 add of 2^23 (exact product, one rounding to an integer: no conversion
// unit).  The tests repeat this arithmetic in numpy (tests/test_torch_quad.py).
__device__ __forceinline__ uint8_t to_bits(float v, uint8_t) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t mag = bits & 0x7FFFFFFFu;
  uint32_t code;
  if (mag > 0x43E80000u) {  // |x| > 464 (0x43E80000), +-inf and NaN
    code = 0x7Fu;
  } else if (mag < 0x3C800000u) {  // |x| < 2^-6: 0 .. 8 steps of 2^-9
    code = __float_as_uint(__fmaf_rn(__uint_as_float(mag), 512.0f, 0x1p23f)) - 0x4B000000u;
  } else {
    code = (mag + 0x7FFFFu + ((mag >> 20) & 1u) - (960u << 20)) >> 20;  // 960 = (127 - 7) << 3
  }
  return static_cast<uint8_t>(code | ((bits >> 24) & 0x80u));
}

// ---------------------------------------------------------------- oct build

constexpr int kSmemMax = 232448;           // what a block can have on an H100
constexpr int kSmemShrink = kSmemMax / 2;  // shrink the band above this: two blocks fit an SM

struct OctGeom {
  int r1, f;               // the table's j extent and channels
  int m1, m2;              // cells along j and k
  int band, n_bands;       // cells of j that one block takes; bands along j
  unsigned line;           // r2 * f, the values of one table line
  unsigned line_stride;    // the same in shared memory, padded
  unsigned slab_stride;    // band + 1 lines in shared memory, padded
  unsigned chunks_per_row; // 16-byte chunks in a row of 8 f values
  uint64_t magic_m2;       // x / m2 == x * magic >> 32 while x * m2 < 2^32
  uint64_t magic_line4;    // the same for line / 4
  bool vec;                // the table takes 16-byte loads
};

__host__ __device__ constexpr int unit_bytes(int corner_bytes) {
  return corner_bytes % 16 == 0 ? 16 : corner_bytes % 8 == 0 ? 8 : corner_bytes % 4 == 0 ? 4 : 2;
}
template <int BYTES> struct Unit;
template <> struct Unit<16> { using type = uint4; };
template <> struct Unit<8> { using type = uint2; };
template <> struct Unit<4> { using type = uint32_t; };
template <> struct Unit<2> { using type = uint16_t; };

__device__ __forceinline__ unsigned fast_div(unsigned x, uint64_t magic) {
  return static_cast<unsigned>((x * magic) >> 32);
}

__device__ __forceinline__ void store4(uint16_t* dst, float4 v) {
  uint2 p;
  p.x = to_bits(v.x, uint16_t{}) | static_cast<uint32_t>(to_bits(v.y, uint16_t{})) << 16;
  p.y = to_bits(v.z, uint16_t{}) | static_cast<uint32_t>(to_bits(v.w, uint16_t{})) << 16;
  *reinterpret_cast<uint2*>(dst) = p;
}
__device__ __forceinline__ void store4(uint32_t* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// Chunk c of the row whose (dy, dz) = (0, 0) corner sits at `at` in both
// slabs (s0: dx = 0, s1: dx = 1), F known at compile time: loads of the
// widest unit that divides a corner's F values, so that no unit crosses a
// corner pair or loses its alignment.
template <typename Bits, int F>
__device__ __forceinline__ uint4 gather_chunk(const Bits* s0, const Bits* s1, unsigned at,
                                              unsigned line_stride, unsigned c) {
  constexpr int kPerChunk = 16 / sizeof(Bits);
  constexpr int kUnitBytes = unit_bytes(F * sizeof(Bits));
  constexpr int kPerUnit = kUnitBytes / sizeof(Bits);
  using U = typename Unit<kUnitBytes>::type;
  union {
    uint4 v;
    U u[16 / kUnitBytes];
  } pack;
#pragma unroll
  for (int u = 0; u < 16 / kUnitBytes; ++u) {
    const unsigned e = c * kPerChunk + u * kPerUnit;  // within the row of 8F values
    const unsigned pair = e / (2 * F), w = e - pair * (2 * F);
    const Bits* s = (pair & 2) ? s1 : s0;
    pack.u[u] = *reinterpret_cast<const U*>(s + at + (pair & 1) * line_stride + w);
  }
  return pack.v;
}

// The same for any f, value by value.
template <typename Bits>
__device__ __forceinline__ uint4 gather_chunk_any(const Bits* s0, const Bits* s1, unsigned at,
                                                  unsigned line_stride, unsigned c, unsigned f) {
  constexpr int kPerChunk = 16 / sizeof(Bits);
  union {
    uint4 v;
    Bits e[kPerChunk];
  } pack;
  unsigned corner = c * kPerChunk / f;  // of the chunk's first value: 4 dx + 2 dy + dz
  unsigned ch = c * kPerChunk - corner * f;
#pragma unroll
  for (int e = 0; e < kPerChunk; ++e) {
    const Bits* s = (corner & 4) ? s1 : s0;
    pack.e[e] = s[at + ((corner >> 1) & 1) * line_stride + (corner & 1) * f + ch];
    if (++ch == f) {
      ch = 0;
      ++corner;
    }
  }
  return pack.v;
}

// Bits: uint16_t for bf16 output, uint32_t for f32 output.  F: the channel
// count, or 0 for any (g.f).  One block builds the rows of cells (i, j0 ..
// j0 + band - 1, all k).
template <typename Bits, int F>
__global__ void __launch_bounds__(kThreads)
    oct_build_kernel(const float* __restrict__ table, const OctGeom g, uint4* __restrict__ out) {
  extern __shared__ uint4 smem[];
  Bits* slab = reinterpret_cast<Bits*>(smem);  // two slabs: dx = 0, 1
  const unsigned f = F > 0 ? F : g.f;
  const unsigned cpr = F > 0 ? F * sizeof(Bits) / 2 : g.chunks_per_row;
  const int band_i = blockIdx.x % g.n_bands, i = blockIdx.x / g.n_bands;
  const int j0 = band_i * g.band, nj = min(g.band, g.m1 - j0);
  const unsigned n_in = (nj + 1) * g.line;  // values of one slab
  const unsigned n_out = nj * g.m2 * cpr;   // chunks of the block

  for (int dx = 0; dx < 2; ++dx) {  // the band's lines are one contiguous run of the table
    const float* src = table + (static_cast<size_t>(i + dx) * g.r1 + j0) * g.line;
    Bits* dst = slab + dx * g.slab_stride;
    if (g.vec) {
      const unsigned line4 = g.line / 4;
      for (unsigned x = threadIdx.x; x < n_in / 4; x += blockDim.x) {
        const unsigned ln = fast_div(x, g.magic_line4);
        store4(dst + ln * g.line_stride + (x - ln * line4) * 4,
               __ldg(reinterpret_cast<const float4*>(src) + x));
      }
    } else {
      for (unsigned x = threadIdx.x; x < n_in; x += blockDim.x) {
        const unsigned ln = x / g.line;
        dst[ln * g.line_stride + (x - ln * g.line)] = to_bits(__ldg(src + x), Bits{});
      }
    }
  }
  __syncthreads();
  const Bits* s0 = slab;
  const Bits* s1 = slab + g.slab_stride;
  uint4* run = out + (static_cast<size_t>(i) * g.m1 + j0) * g.m2 * cpr;
  for (unsigned q = threadIdx.x; q < n_out; q += blockDim.x) {
    const unsigned r = q / cpr, c = q - r * cpr;  // the band's row jj * m2 + k, the chunk in it
    const unsigned jj = fast_div(r, g.magic_m2), k = r - jj * g.m2;
    const unsigned at = jj * g.line_stride + k * f;
    if constexpr (F > 0) {
      run[q] = gather_chunk<Bits, F>(s0, s1, at, g.line_stride, c);
    } else {
      run[q] = gather_chunk_any<Bits>(s0, s1, at, g.line_stride, c, f);
    }
  }
}

unsigned round_up(unsigned x, unsigned to) { return (x + to - 1) / to * to; }

template <typename Bits, int F>
cudaError_t launch_oct(const float* table, const OctGeom& g, int blocks, int threads, size_t smem,
                       uint4* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        oct_build_kernel<Bits, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
  }
  oct_build_kernel<Bits, F><<<blocks, threads, smem, stream>>>(table, g, out);
  return cudaGetLastError();
}

template <typename Bits>
cudaError_t build_oct(const float* table, int r0, int r1, int r2, int f, int band, int threads,
                      uint4* out, cudaStream_t stream) {
  OctGeom g;
  g.r1 = r1, g.f = f, g.m1 = r1 - 1, g.m2 = r2 - 1;
  g.line = static_cast<unsigned>(r2) * f;
  g.chunks_per_row = f * sizeof(Bits) / 2;
  g.vec = g.line % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  // lines 32 bytes apart in the banks, the two slabs 64: a row's four
  // corner pairs then read four different quarters of the 128 bytes of banks
  unsigned line_bytes = round_up(g.line * sizeof(Bits), 16);
  if (line_bytes % 128 == 0) line_bytes += 32;
  g.line_stride = line_bytes / sizeof(Bits);
  size_t smem;
  for (g.band = band < g.m1 ? band : g.m1;; g.band /= 2) {
    unsigned slab_bytes = (g.band + 1) * line_bytes;
    slab_bytes += (64 + 128 - slab_bytes % 128) % 128;
    g.slab_stride = slab_bytes / sizeof(Bits);
    smem = 2 * static_cast<size_t>(slab_bytes);
    if (g.band == 1 || smem <= kSmemShrink) break;
  }
  if (smem > kSmemMax) return cudaErrorInvalidValue;  // a line too long for shared memory
  g.n_bands = (g.m1 + g.band - 1) / g.band;
  // fast_div's ranges
  if (static_cast<uint64_t>(g.band) * g.m2 * g.m2 >= (1ull << 32) ||
      static_cast<uint64_t>(g.band + 1) * g.line * g.line >= (1ull << 32))
    return cudaErrorInvalidValue;
  g.magic_m2 = (1ull << 32) / g.m2 + 1;
  g.magic_line4 = g.vec ? (1ull << 32) / (g.line / 4) + 1 : 0;
  const int blocks = g.n_bands * (r0 - 1);
  switch (f) {
    case 4: return launch_oct<Bits, 4>(table, g, blocks, threads, smem, out, stream);
    case 6: return launch_oct<Bits, 6>(table, g, blocks, threads, smem, out, stream);
    case 8: return launch_oct<Bits, 8>(table, g, blocks, threads, smem, out, stream);
    default: return launch_oct<Bits, 0>(table, g, blocks, threads, smem, out, stream);
  }
}

// --------------------------------------------------------------- quad build

constexpr int kQuadMaxThreads = 512;

struct QuadGeom {
  unsigned r1, f;        // the table's j extent and channels
  unsigned m0, m1;       // cells along i and j
  unsigned band, lines;  // cells of j and of i that one block takes
  unsigned run4;         // float4 of a staged run: (band + 1) f / 4
  unsigned stride;       // values from one staged run to the next, padded
  uint64_t magic_run4;   // x / run4 == fast_div(x, magic_run4) in range
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __float22bfloat162_rn(make_float2(lo, hi));
  return static_cast<uint32_t>(__bfloat16_as_ushort(p.x)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(p.y)) << 16;
}
__device__ __forceinline__ uint32_t fp8x4(float4 v) {
  return static_cast<uint32_t>(to_bits(v.x, uint8_t{})) |
         static_cast<uint32_t>(to_bits(v.y, uint8_t{})) << 8 |
         static_cast<uint32_t>(to_bits(v.z, uint8_t{})) << 16 |
         static_cast<uint32_t>(to_bits(v.w, uint8_t{})) << 24;
}

// 4 values rounded once and stored together: float8 by to_bits, bf16 two at
// a time (__float22bfloat162_rn: the same nearest-even bits as
// __float2bfloat16_rn), f32 as they are.
__device__ __forceinline__ void put4(uint8_t* dst, float4 v) {
  *reinterpret_cast<uint32_t*>(dst) = fp8x4(v);
}
__device__ __forceinline__ void put4(uint16_t* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
}
__device__ __forceinline__ void put4(uint32_t* dst, float4 v) { *reinterpret_cast<float4*>(dst) = v; }

// The vector path, F = 32, 64 or 96 channels.  Bits: uint8_t
// (float8), uint16_t (bf16) or uint32_t (f32) output.  The table starts on
// a 16-byte boundary, so every 4 values of a line are one aligned float4.
// One block writes the rows of cells (i0 .. i0 + lines - 1, j0 .. j0 +
// band - 1): it stages lines i0 .. i0 + lines of the table from cell j0 on
// (contiguous runs of (band + 1) F values) in shared memory, each value
// rounded once, then copies whole 16-byte chunks from there, each one
// 16-byte read of one corner pair's run (2F values are a whole number of
// chunks); each (i, j) row's chunks are one contiguous run of the output.
template <typename Bits, unsigned F>
__global__ void __launch_bounds__(kQuadMaxThreads)
    quad_build_kernel(const float* __restrict__ table, const QuadGeom g, uint4* __restrict__ out) {
  extern __shared__ uint4 smem[];
  constexpr unsigned kPer = 16 / sizeof(Bits);      // values of a chunk
  constexpr unsigned cpr = F * sizeof(Bits) / 4;    // chunks in a row of 4F values
  static_assert((2 * F) % kPer == 0, "a chunk lies in one corner pair's run");
  Bits* runs = reinterpret_cast<Bits*>(smem);
  const unsigned j0 = blockIdx.x * g.band, nj = min(g.band, g.m1 - j0);
  const unsigned i0 = blockIdx.y * g.lines, ni = min(g.lines, g.m0 - i0);
  const unsigned n4 = (nj + 1) * F / 4;  // float4 of this block's runs
  const float4* src =
      reinterpret_cast<const float4*>(table + (static_cast<size_t>(i0) * g.r1 + j0) * F);
  const size_t pitch4 = static_cast<size_t>(g.r1) * F / 4;  // float4 of a table line
  for (unsigned x = threadIdx.x; x < (ni + 1) * g.run4; x += blockDim.x) {
    const unsigned l = fast_div(x, g.magic_run4), at = x - l * g.run4;
    if (at < n4) put4(runs + l * g.stride + at * 4, __ldg(src + l * pitch4 + at));
  }
  __syncthreads();
  for (unsigned li = 0; li < ni; ++li) {
    const Bits* s0 = runs + li * g.stride;  // line i0 + li (dx = 0); + stride: dx = 1
    uint4* dst = out + (static_cast<size_t>(i0 + li) * g.m1 + j0) * cpr;
    for (unsigned q = threadIdx.x; q < nj * cpr; q += blockDim.x) {
      // row (i0 + li, j0 + r) from its value e on: corner pair dx = e / 2F,
      // the run table[i + dx, j : j + 2, :] of 2F values
      const unsigned r = q / cpr, e = (q - r * cpr) * kPer;
      const bool dx = e >= 2 * F;
      dst[q] = *reinterpret_cast<const uint4*>(s0 + dx * g.stride + r * F + (dx ? e - 2 * F : e));
    }
  }
}

// The generic path: any f, any alignment of the table, value by value.  One
// block writes the rows of cells (i = blockIdx.y, j0 .. j0 + band - 1); one
// thread writes a chunk of 4 output values (Store: uint32_t for float8,
// uint2 for bf16, uint4 for f32); a row of 4f values is f such chunks.
template <typename Bits, typename Store>
__global__ void __launch_bounds__(kQuadMaxThreads)
    quad_build_any_kernel(const float* __restrict__ table, const QuadGeom g,
                          Store* __restrict__ out) {
  static_assert(sizeof(Store) == 4 * sizeof(Bits), "a chunk is 4 values");
  const unsigned f = g.f;
  const unsigned j0 = blockIdx.x * g.band, nj = min(g.band, g.m1 - j0);
  const float* line0 = table + (static_cast<size_t>(blockIdx.y) * g.r1 + j0) * f;
  const size_t sx = static_cast<size_t>(g.r1) * f;
  Store* run = out + (static_cast<size_t>(blockIdx.y) * g.m1 + j0) * f;
  for (unsigned q = threadIdx.x; q < nj * f; q += blockDim.x) {
    const unsigned r = q / f, start = (q - r * f) * 4;  // the block's row, the chunk's first value
    unsigned corner = start / f;                          // 2 dx + dy
    unsigned ch = start - corner * f;
    union {
      Store v;
      Bits e[4];
    } pack;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pack.e[e] = to_bits(__ldg(line0 + (corner >> 1) * sx + (r + (corner & 1)) * f + ch), Bits{});
      if (++ch == f) {
        ch = 0;
        ++corner;
      }
    }
    run[q] = pack.v;
  }
}

template <typename Bits, unsigned F>
cudaError_t launch_quad(const float* table, QuadGeom g, int threads, void* out, cudaStream_t stream) {
  g.run4 = (g.band + 1) * F / 4;
  // runs 64 bytes apart in the banks (mod 128): a float8 row's two corner
  // pairs then read different banks
  unsigned bytes = g.run4 * 4 * sizeof(Bits);
  bytes += (64 + 128 - bytes % 128) % 128;
  g.stride = bytes / sizeof(Bits);
  const size_t smem = static_cast<size_t>(g.lines + 1) * bytes;
  if (smem > kSmemMax || static_cast<uint64_t>(g.lines + 1) * g.run4 * g.run4 >= (1ull << 32))
    return cudaErrorInvalidValue;  // a block too large for shared memory, or for fast_div
  g.magic_run4 = (1ull << 32) / g.run4 + 1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quad_build_kernel<Bits, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((g.m1 + g.band - 1) / g.band, (g.m0 + g.lines - 1) / g.lines);
  quad_build_kernel<Bits, F><<<grid, threads, smem, stream>>>(table, g, static_cast<uint4*>(out));
  return cudaGetLastError();
}

// vec: the table takes 16-byte loads (on 16 bytes, f % 4 == 0); with f = 32,
// 64 or 96 the vector path, else the generic one.
template <typename Bits>
cudaError_t build_quad(const float* table, QuadGeom g, int threads, bool vec, void* out,
                       cudaStream_t stream) {
  if (vec) {
    switch (g.f) {
      case 32: return launch_quad<Bits, 32>(table, g, threads, out, stream);
      case 64: return launch_quad<Bits, 64>(table, g, threads, out, stream);
      case 96: return launch_quad<Bits, 96>(table, g, threads, out, stream);
      default: break;
    }
  }
  using Store = typename Unit<4 * sizeof(Bits)>::type;
  const dim3 grid((g.m1 + g.band - 1) / g.band, g.m0);
  quad_build_any_kernel<Bits, Store><<<grid, threads, 0, stream>>>(table, g, static_cast<Store*>(out));
  return cudaGetLastError();
}

// ---- the fold (tn_oct_fold)

constexpr int kFoldThreads = 256;
constexpr int kFoldMaxLines = 65535;  // blocks along the grid's lines: blockIdx.y

// F > 0: the channel count as a constant; 0: f_rt.
template <int F>
__global__ void __launch_bounds__(kFoldThreads)
oct_fold_kernel(const float* __restrict__ gq, int r0, int r1, int r2, int f_rt, float* __restrict__ out) {
  const int f = F > 0 ? F : f_rt;
  const int m0 = r0 - 1, m1 = r1 - 1, m2 = r2 - 1;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // (z, v) of the line
  if (e >= r2 * f) return;
  const int z = e / f, v = e - z * f;
  for (int line = blockIdx.y; line < r0 * r1; line += gridDim.y) {
    const int x = line / r1, y = line - x * r1;
    float term[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // CORNERS_3D: dz fastest, then dy, then dx
      const int cx = x - (c >> 2), cy = y - ((c >> 1) & 1), cz = z - (c & 1);
      const bool in = cx >= 0 && cx < m0 && cy >= 0 && cy < m1 && cz >= 0 && cz < m2;
      term[c] = in ? gq[((static_cast<long long>(cx) * m1 + cy) * m2 + cz) * (8 * f) + c * f + v] : 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) s = __fadd_rn(s, term[c]);
    out[static_cast<long long>(line) * r2 * f + e] = s;
  }
}

}  // namespace

extern "C" {

// table: [r0, r1, r2, f] f32, contiguous; out: [(r0-1)(r1-1)(r2-1), 8f] of
// bf16 (out_bf16 != 0) or f32, contiguous and 16-byte aligned.  A block of
// `threads` threads (32 .. 256) takes up to `band` cells of j (fewer where
// the lines are too long for shared memory).
int tn_build_oct(const void* table, int r0, int r1, int r2, int f, int out_bf16, int band,
                 int threads, void* out, void* stream) {
  if (r0 < 2 || r1 < 2 || r2 < 2 || f < 1 || band < 1 || threads < 32 || threads > kThreads ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(r0 - 1) * (r1 - 1) * (r2 - 1);
  const long long n_chunks = rows * (out_bf16 ? f : 2 * f);  // 16f or 32f bytes per row
  if (n_chunks > INT_MAX || static_cast<long long>(r0) * r1 * r2 * f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  uint4* o = static_cast<uint4*>(out);
  return static_cast<int>(out_bf16 ? build_oct<uint16_t>(t, r0, r1, r2, f, band, threads, o, s)
                                   : build_oct<uint32_t>(t, r0, r1, r2, f, band, threads, o, s));
}

// table: [r0, r1, f] f32, contiguous; out: [(r0-1)(r1-1), 4f] of
// float8_e4m3fn (out_bytes 1), bf16 (2) or f32 (4), contiguous and aligned to
// 16 bytes.  vec != 0 says the table takes 16-byte loads: f % 4 == 0 and the
// table on a 16-byte boundary (refused otherwise: nothing reads misaligned);
// with f = 32, 64 or 96 that is the vector path, else, and for vec == 0, the generic
// path.  A block of `threads` threads (32 .. 512) writes the rows of up to
// `lines` cells of i (the vector path; the generic path one) by `band`
// cells of j.
int tn_build_quad(const void* table, int r0, int r1, int f, int out_bytes, int vec, int band,
                  int lines, int threads, void* out, void* stream) {
  if (r0 < 2 || r1 < 2 || f < 1 || (out_bytes != 1 && out_bytes != 2 && out_bytes != 4) ||
      band < 1 || lines < 1 || threads < 32 || threads > kQuadMaxThreads || threads % 32 != 0 ||
      r0 - 1 > 65535)  // blocks along i: blockIdx.y
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(r1) * f * 4 > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if ((vec && (f % 4 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0)) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  QuadGeom g = {};
  g.r1 = r1, g.f = f, g.m0 = r0 - 1, g.m1 = r1 - 1;
  g.band = band < r1 - 1 ? band : r1 - 1;
  g.lines = lines < r0 - 1 ? lines : r0 - 1;
  auto s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  cudaError_t err;
  switch (out_bytes) {
    case 1: err = build_quad<uint8_t>(t, g, threads, vec != 0, out, s); break;
    case 2: err = build_quad<uint16_t>(t, g, threads, vec != 0, out, s); break;
    default: err = build_quad<uint32_t>(t, g, threads, vec != 0, out, s); break;
  }
  return static_cast<int>(err);
}

// gq: [(r0-1)(r1-1)(r2-1), 8f] f32, contiguous (not read where a side is 1);
// out: [r0, r1, r2, f] f32, contiguous, every element written.
int tn_oct_fold(const void* gq, int r0, int r1, int r2, int f, void* out, void* stream) {
  if (r0 < 1 || r1 < 1 || r2 < 1 || f < 1 || static_cast<long long>(r2) * f > INT_MAX ||
      static_cast<long long>(r0) * r1 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lines = r0 * r1;
  const dim3 grid((r2 * f + kFoldThreads - 1) / kFoldThreads, lines < kFoldMaxLines ? lines : kFoldMaxLines);
  auto s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gq);
  float* o = static_cast<float*>(out);
  switch (f) {
    case 4: oct_fold_kernel<4><<<grid, kFoldThreads, 0, s>>>(g, r0, r1, r2, f, o); break;
    case 6: oct_fold_kernel<6><<<grid, kFoldThreads, 0, s>>>(g, r0, r1, r2, f, o); break;
    case 8: oct_fold_kernel<8><<<grid, kFoldThreads, 0, s>>>(g, r0, r1, r2, f, o); break;
    default: oct_fold_kernel<0><<<grid, kFoldThreads, 0, s>>>(g, r0, r1, r2, f, o); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
