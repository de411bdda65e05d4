// Cell-packed table builds, in bf16 or f32:
//   oct:  [r0, r1, r2, F] f32 -> [(r0-1)(r1-1)(r2-1), 8F]  (Cobafa's grids)
//   quad: [r0, r1, F] f32     -> [(r0-1)(r1-1), 4F]         (K-Planes' planes)
//
// Replaces tinynerf_tpu/ops/octbuild.py:_oct_kernel_mxu, the Pallas TPU
// kernel behind build_oct_pallas: row (i, j, k) of the cell grid holds the
// cell's eight corner rows table[i+dx, j+dy, k+dz, :] in corner order
// (dx, dy, dz) with dz fastest, then dy, then dx, each value rounded once to
// the output type (bf16 by __float2bfloat16_rn, round to nearest even, as
// torch's Tensor.to(torch.bfloat16) rounds), so the result is bit-equal to
// the plain version (ops/octbuild.py:build_oct_plain).
//
// What bounds it on an H100: memory.  It is a pure relayout with no
// arithmetic: each table value is read once and written eight times, so the
// output write dominates.  Over the Cobafa field's seven grids (bases
// 32..128^3 with 8 or 4 channels, coefficients 64^3 x 6) that is ~426 MB of
// bf16 output and ~88 MB of f32 input per field call, ~0.15 ms at an H100
// SXM's published 3.35 TB/s (700 W limit).
//
// Design.  The TPU kernel dilates lanes with one-hot MXU matmuls because its
// vector unit wastes 124 of 128 lanes on a 4-channel minor axis; nothing
// here needs that.  One thread writes one 16-byte chunk of the output (8
// bf16 or 4 f32 values): a row of 8F values is always a whole number of such
// chunks (16F bytes in bf16, 32F in f32), so a chunk never straddles two
// cells and any F works (F = 3 or 6 gives 12- or 24-byte corners that a
// chunk crosses mid-corner).  Neighbouring threads write neighbouring
// chunks, so every store is a full coalesced 16-byte store.  The reads are
// 4-byte gathers of eight shifted copies of the table: neighbouring cells
// share corners, so a warp's reads fall on a few cache lines, and each table
// (at most 34 MB, the 128^3 x 4 grid) stays resident in the 50 MB L2 while
// it is rebuilt.

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
// cells and any F works (the oct kernel's 16-byte bf16 chunk would need an
// even F here: a bf16 quad row is 8F bytes).  Stores are coalesced; the
// four corner reads of neighbouring cells overlap and come from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;  // grid-stride beyond this

__device__ __forceinline__ uint16_t to_bits(float v, uint16_t) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t to_bits(float v, uint32_t) { return __float_as_uint(v); }

// Bits: uint16_t for bf16 output, uint32_t for f32 output.
template <typename Bits>
__global__ void oct_build_kernel(const float* __restrict__ table, int r1, int r2, int f,
                                 unsigned m1, unsigned m2, unsigned chunks_per_row,
                                 unsigned n_chunks, uint4* __restrict__ out) {
  constexpr int kPerChunk = 16 / sizeof(Bits);
  const long long sy = static_cast<long long>(r2) * f;
  const long long sx = static_cast<long long>(r1) * sy;
  // n_chunks < 2^31 (checked by the entry point), so q + stride never wraps
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < n_chunks;
       q += gridDim.x * blockDim.x) {
    const unsigned row = q / chunks_per_row;
    const int start = static_cast<int>(q - row * chunks_per_row) * kPerChunk;  // within the 8F row
    const unsigned k = row % m2;
    const unsigned ij = row / m2;
    const unsigned j = ij % m1;
    const unsigned i = ij / m1;
    const float* base = table + i * sx + j * sy + static_cast<long long>(k) * f;
    int c = start / f;  // corner of the chunk's first value
    int ch = start - c * f;  // its channel
    union {
      uint4 v;
      Bits e[kPerChunk];
    } pack;
#pragma unroll
    for (int e = 0; e < kPerChunk; ++e) {
      const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
      pack.e[e] = to_bits(__ldg(base + dx * sx + dy * sy + dz * f + ch), Bits{});
      if (++ch == f) {
        ch = 0;
        ++c;
      }
    }
    out[q] = pack.v;
  }
}

// One chunk = 4 output values; Store is uint2 (4 x bf16) or uint4 (4 x f32).
template <typename Bits, typename Store>
__global__ void quad_build_kernel(const float* __restrict__ table, int r1, int f, unsigned m1,
                                  unsigned chunks_per_row, unsigned n_chunks,
                                  Store* __restrict__ out) {
  constexpr int kPerChunk = 4;
  static_assert(sizeof(Store) == kPerChunk * sizeof(Bits), "a chunk is 4 values");
  const long long sx = static_cast<long long>(r1) * f;
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
// bf16 (out_bf16 != 0) or f32, contiguous and 16-byte aligned.
int tn_build_oct(const void* table, int r0, int r1, int r2, int f, int out_bf16, void* out,
                 void* stream) {
  if (r0 < 2 || r1 < 2 || r2 < 2 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int m1 = r1 - 1, m2 = r2 - 1;
  const long long rows = static_cast<long long>(r0 - 1) * m1 * m2;
  const int chunks_per_row = out_bf16 ? f : 2 * f;  // 16f or 32f bytes per row
  const long long n_chunks = rows * chunks_per_row;
  if (n_chunks > INT_MAX || static_cast<long long>(r0) * r1 * r2 * f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n_chunks + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  uint4* o = static_cast<uint4*>(out);
  if (out_bf16) {
    oct_build_kernel<uint16_t><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, r2, f, m1, m2, chunks_per_row, static_cast<int>(n_chunks), o);
  } else {
    oct_build_kernel<uint32_t><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, r2, f, m1, m2, chunks_per_row, static_cast<int>(n_chunks), o);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: [r0, r1, f] f32, contiguous; out: [(r0-1)(r1-1), 4f] of bf16
// (out_bf16 != 0) or f32, contiguous and 8-byte (bf16) or 16-byte (f32)
// aligned.
int tn_build_quad(const void* table, int r0, int r1, int f, int out_bf16, void* out, void* stream) {
  if (r0 < 2 || r1 < 2 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int m1 = r1 - 1;
  const long long n_chunks = static_cast<long long>(r0 - 1) * m1 * f;  // f chunks of 4 per row
  if (n_chunks > INT_MAX || static_cast<long long>(r0) * r1 * f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n_chunks + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  if (out_bf16) {
    quad_build_kernel<uint16_t, uint2><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, f, m1, f, static_cast<unsigned>(n_chunks), static_cast<uint2*>(out));
  } else {
    quad_build_kernel<uint32_t, uint4><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        t, r1, f, m1, f, static_cast<unsigned>(n_chunks), static_cast<uint4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
