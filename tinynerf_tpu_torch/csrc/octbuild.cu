// Cell-packed table builds, in bf16 or f32 (the quad build also in
// float8_e4m3fn):
//   oct:  [r0, r1, r2, F] f32 -> [(r0-1)(r1-1)(r2-1), 8F]  (Cobafa's grids)
//   quad: [r0, r1, F] f32     -> [(r0-1)(r1-1), 4F]         (K-Planes' planes)
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
// each value rounded once as above, bit-equal to ops/octbuild.py:
// build_quad_plain.  Memory bounds it as well: each value is read once and
// written four times.  The K-Planes field builds nine planes per call (129,
// 257 and 513^2 x 32, three projections): 132.8 MB read and 264.2 MB of bf16
// written, ~0.119 ms at 3.35 TB/s.  Design: the TPU kernel stores four
// lane-offset slices of two table rows per grid step; here one thread
// writes one chunk of 4 output values (8 bytes in bf16, 16 in f32).  A row
// of 4F values is always F whole chunks, so a chunk never straddles two
// cells and any F works (a 16-byte bf16 chunk would need an even F here: a
// bf16 quad row is 8F bytes).  Stores are coalesced; the four corner reads
// of neighbouring cells overlap and come from L1/L2.
//
// The quad build's float8_e4m3fn output (the K-Planes field's
// gather_dtype="float8", the JAX Pallas kernel's out_dtype=float8_e4m3fn) is
// the same copy with 1-byte values, 4F bytes a row (128 bytes at F = 32).
// Where F is a multiple of 4 a row is F / 4 whole 16-byte chunks, and one
// thread writes a chunk of 16 values (which may span two corners); else a
// thread writes 4 values, 4 bytes.  (The 4-byte chunk alone was slower than
// the bf16 build's 8-byte one on the nine planes: PERF.md has both times.)
// It reads f32 and writes a quarter of the f32 output's bytes, so at the
// field's nine planes its bound is 132.8 MB read and 132.1 MB written,
// ~0.079 ms at 3.35 TB/s.  The cast is JAX's rule (to_bits(float, uint8_t)
// below, bit-equal to ops/octbuild.py:to_float8_e4m3fn), not
// __nv_cvt_float_to_fp8: JAX rounds |x| > 464 and +-inf to NaN and 464 to
// 448, which neither of that intrinsic's saturation modes gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;  // the quad build strides beyond this

__device__ __forceinline__ uint16_t to_bits(float v, uint16_t) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t to_bits(float v, uint32_t) { return __float_as_uint(v); }

// f32 -> float8_e4m3fn (1 sign, 4 exponent bits of bias 7, 3 mantissa bits;
// 0x7F is NaN) as JAX casts: nearest even, as if the code above 448 were
// 480, and that code is NaN.  Normals: the f32 bits' low 20 mantissa bits
// rounded away (a carry moves the exponent), the exponent rebiased from 127
// to 7; subnormals (|x| < 2^-6) count steps of 2^-9, rounded to even.
__device__ __forceinline__ uint8_t to_bits(float v, uint8_t) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t mag = bits & 0x7FFFFFFFu;
  const float a = __uint_as_float(mag);
  uint32_t code;
  if (!(a <= 464.0f)) {  // |x| > 464, inf and NaN
    code = 0x7Fu;
  } else if (a < 0x1p-6f) {
    code = static_cast<uint32_t>(__float2int_rn(a * 512.0f));  // exact product; 0 .. 8
  } else {
    code = ((mag + 0x7FFFFu + ((mag >> 20) & 1u)) >> 20) - (120u << 3);
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

// One chunk = sizeof(Store) / sizeof(Bits) output values: Store is uint4 (16
// x fp8 or 4 x f32), uint32_t (4 x fp8) or uint2 (4 x bf16).
template <typename Bits, typename Store>
__global__ void quad_build_kernel(const float* __restrict__ table, int r1, int f, unsigned m1,
                                  unsigned chunks_per_row, unsigned n_chunks,
                                  Store* __restrict__ out) {
  constexpr int kPerChunk = sizeof(Store) / sizeof(Bits);
  static_assert(kPerChunk == 4 || kPerChunk == 16, "a chunk is 4 or 16 values");
  const long long sx = static_cast<long long>(r1) * f;
  // n_chunks < 2^31 (checked by the entry point), so q + stride never wraps
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < n_chunks;
       q += gridDim.x * blockDim.x) {
    const unsigned row = q / chunks_per_row;
    const int start = static_cast<int>(q - row * chunks_per_row) * kPerChunk;  // within the 4F row
    const unsigned j = row % m1;
    const unsigned i = row / m1;
    const float* base = table + i * sx + static_cast<long long>(j) * f;
    int c = start / f;  // corner of the chunk's first value
    int ch = start - c * f;  // its channel
    union {
      Store v;
      Bits e[kPerChunk];
    } pack;
#pragma unroll
    for (int e = 0; e < kPerChunk; ++e) {
      const int dx = c >> 1, dy = c & 1;
      pack.e[e] = to_bits(__ldg(base + dx * sx + dy * f + ch), Bits{});
      if (++ch == f) {
        ch = 0;
        ++c;
      }
    }
    out[q] = pack.v;
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
// 16 bytes.
int tn_build_quad(const void* table, int r0, int r1, int f, int out_bytes, void* out, void* stream) {
  if (r0 < 2 || r1 < 2 || f < 1 || (out_bytes != 1 && out_bytes != 2 && out_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int m1 = r1 - 1;
  const bool wide = out_bytes == 1 && f % 4 == 0;  // fp8 rows of whole 16-value chunks
  const int chunks_per_row = wide ? f / 4 : f;       // else f chunks of 4 per row
  const long long n_chunks = static_cast<long long>(r0 - 1) * m1 * chunks_per_row;
  if (n_chunks > INT_MAX || static_cast<long long>(r0) * r1 * f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n_chunks + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  if (wide) {
    quad_build_kernel<uint8_t, uint4><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, f, m1, chunks_per_row, static_cast<unsigned>(n_chunks), static_cast<uint4*>(out));
  } else if (out_bytes == 1) {
    quad_build_kernel<uint8_t, uint32_t><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, f, m1, f, static_cast<unsigned>(n_chunks), static_cast<uint32_t*>(out));
  } else if (out_bytes == 2) {
    quad_build_kernel<uint16_t, uint2><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, f, m1, f, static_cast<unsigned>(n_chunks), static_cast<uint2*>(out));
  } else {
    quad_build_kernel<uint32_t, uint4><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, f, m1, f, static_cast<unsigned>(n_chunks), static_cast<uint4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
