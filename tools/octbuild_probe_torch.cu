// A probe, not part of the port's library: the oct cell-pack build as it was
// first written for the card (one thread gathers one 16-byte output chunk
// value by value from global memory), with its loads or its stores taken
// out, to see which of the three (loads, index arithmetic, stores) set its
// time.  tools/profile_weights_oct_torch.py --oct-probe builds and times it
// beside the library's kernel.
//
//   probe 0: the kernel as it was
//   probe 1: every load replaced by a constant made from the address
//            (index arithmetic and stores stay)
//   probe 2: every store replaced by a checksum kept in a register and
//            written once per thread (index arithmetic and loads stay)
//   probe 3: both (index arithmetic alone)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

__device__ __forceinline__ uint16_t to_bits(float v, uint16_t) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t to_bits(float v, uint32_t) { return __float_as_uint(v); }

template <typename Bits, int PROBE>
__global__ void oct_gather_kernel(const float* __restrict__ table, int r1, int r2, int f,
                                  unsigned m1, unsigned m2, unsigned chunks_per_row,
                                  unsigned n_chunks, uint4* __restrict__ out,
                                  unsigned* __restrict__ sums) {
  constexpr bool kLoads = PROBE == 0 || PROBE == 2;
  constexpr bool kStores = PROBE == 0 || PROBE == 1;
  constexpr int kPerChunk = 16 / sizeof(Bits);
  const long long sy = static_cast<long long>(r2) * f;
  const long long sx = static_cast<long long>(r1) * sy;
  unsigned sum = 0;
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < n_chunks;
       q += gridDim.x * blockDim.x) {
    const unsigned row = q / chunks_per_row;
    const int start = static_cast<int>(q - row * chunks_per_row) * kPerChunk;
    const unsigned k = row % m2;
    const unsigned ij = row / m2;
    const unsigned j = ij % m1;
    const unsigned i = ij / m1;
    const float* base = table + i * sx + j * sy + static_cast<long long>(k) * f;
    int c = start / f;
    int ch = start - c * f;
    union {
      uint4 v;
      Bits e[kPerChunk];
    } pack;
#pragma unroll
    for (int e = 0; e < kPerChunk; ++e) {
      const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
      const float* at = base + dx * sx + dy * sy + dz * f + ch;
      const float v = kLoads ? __ldg(at) : __uint_as_float(static_cast<unsigned>(at - table));
      pack.e[e] = to_bits(v, Bits{});
      if (++ch == f) {
        ch = 0;
        ++c;
      }
    }
    if (kStores) {
      out[q] = pack.v;
    } else {
      sum ^= pack.v.x ^ pack.v.y ^ pack.v.z ^ pack.v.w;
    }
  }
  if (!kStores) sums[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <typename Bits>
void launch(int probe, int blocks, cudaStream_t s, const float* t, int r1, int r2, int f, int m1,
            int m2, int cpr, unsigned n, uint4* o, unsigned* sums) {
  switch (probe) {
    case 0: oct_gather_kernel<Bits, 0><<<blocks, kThreads, 0, s>>>(t, r1, r2, f, m1, m2, cpr, n, o, sums); break;
    case 1: oct_gather_kernel<Bits, 1><<<blocks, kThreads, 0, s>>>(t, r1, r2, f, m1, m2, cpr, n, o, sums); break;
    case 2: oct_gather_kernel<Bits, 2><<<blocks, kThreads, 0, s>>>(t, r1, r2, f, m1, m2, cpr, n, o, sums); break;
    default: oct_gather_kernel<Bits, 3><<<blocks, kThreads, 0, s>>>(t, r1, r2, f, m1, m2, cpr, n, o, sums); break;
  }
}

}  // namespace

extern "C" {

// As the library's tn_build_oct; sums: kMaxBlocks * kThreads unsigned values
// of scratch for the probes without stores.
int tn_probe_oct(const void* table, int r0, int r1, int r2, int f, int out_bf16, int probe,
                 void* out, void* sums, void* stream) {
  if (r0 < 2 || r1 < 2 || r2 < 2 || f < 1 || probe < 0 || probe > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m1 = r1 - 1, m2 = r2 - 1;
  const long long rows = static_cast<long long>(r0 - 1) * m1 * m2;
  const int chunks_per_row = out_bf16 ? f : 2 * f;
  const long long n_chunks = rows * chunks_per_row;
  if (n_chunks > INT_MAX || static_cast<long long>(r0) * r1 * r2 * f > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n_chunks + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  if (out_bf16) {
    launch<uint16_t>(probe, static_cast<int>(blocks), s, t, r1, r2, f, m1, m2, chunks_per_row,
                     static_cast<unsigned>(n_chunks), static_cast<uint4*>(out),
                     static_cast<unsigned*>(sums));
  } else {
    launch<uint32_t>(probe, static_cast<int>(blocks), s, t, r1, r2, f, m1, m2, chunks_per_row,
                     static_cast<unsigned>(n_chunks), static_cast<uint4*>(out),
                     static_cast<unsigned*>(sums));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
