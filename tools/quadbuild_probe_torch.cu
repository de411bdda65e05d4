// A probe, not part of the port's library: the quad cell-pack build's direct
// design at F = 32 (a block takes one i and a band of j; a thread writes one
// 16-byte chunk from 1, 2 or 4 float4 loads of the two corner-pair runs
// straight from global memory, rounding each value once per load), which
// the library's staged design (csrc/octbuild.cu quad_build_kernel) replaced,
// with its loads, its stores or its cast taken out, to see which of them
// sets its time.  tools/profile_weights_oct_torch.py --quad-probe builds and
// times it beside the library's kernel on the K-Planes planes.
//
//   probe 0: the direct design (its output is the library's, bit for bit)
//   probe 1: every load replaced by a value made from the address
//   probe 2: every store replaced by a checksum kept in a register and
//            written once per thread
//   probe 3: both (index arithmetic and the cast alone)
//   probe 4: the cast replaced by taking each f32's high bytes (float8:
//            one byte, bf16: two; f32 is unchanged)

#include "../tinynerf_tpu_torch/csrc/octbuild.cu"

namespace {

constexpr int kProbeF = 32;

// 16 output bytes from 16 / sizeof(Bits) consecutive f32 values
__device__ __forceinline__ uint4 pack16(const float4 (&v)[1]) {
  return make_uint4(__float_as_uint(v[0].x), __float_as_uint(v[0].y), __float_as_uint(v[0].z),
                    __float_as_uint(v[0].w));
}
__device__ __forceinline__ uint4 pack16(const float4 (&v)[2]) {
  return make_uint4(bf16x2(v[0].x, v[0].y), bf16x2(v[0].z, v[0].w), bf16x2(v[1].x, v[1].y),
                    bf16x2(v[1].z, v[1].w));
}
__device__ __forceinline__ uint4 pack16(const float4 (&v)[4]) {
  return make_uint4(fp8x4(v[0]), fp8x4(v[1]), fp8x4(v[2]), fp8x4(v[3]));
}

__device__ __forceinline__ uint4 high_bytes(const float4 (&v)[1]) { return pack16(v); }
__device__ __forceinline__ uint4 high_bytes(const float4 (&v)[2]) {
  auto hi = [](float a, float b) { return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632); };
  return make_uint4(hi(v[0].x, v[0].y), hi(v[0].z, v[0].w), hi(v[1].x, v[1].y), hi(v[1].z, v[1].w));
}
__device__ __forceinline__ uint4 high_bytes(const float4 (&v)[4]) {
  auto hi = [](float4 a) {
    return __byte_perm(__byte_perm(__float_as_uint(a.x), __float_as_uint(a.y), 0x0073),
                       __byte_perm(__float_as_uint(a.z), __float_as_uint(a.w), 0x0073), 0x5410);
  };
  return make_uint4(hi(v[0]), hi(v[1]), hi(v[2]), hi(v[3]));
}

template <typename Bits, int PROBE>
__global__ void __launch_bounds__(kQuadMaxThreads)
    quad_probe_kernel(const float* __restrict__ table, const QuadGeom g, uint4* __restrict__ out,
                      unsigned* __restrict__ sums) {
  constexpr bool kLoads = PROBE != 1 && PROBE != 3;
  constexpr bool kStores = PROBE != 2 && PROBE != 3;
  constexpr int F = kProbeF, kUnits = 4 / sizeof(Bits);
  constexpr unsigned cpr = F * sizeof(Bits) / 4;
  const unsigned j0 = blockIdx.x * g.band, nj = min(g.band, g.m1 - j0);
  const float* line0 = table + (static_cast<size_t>(blockIdx.y) * g.r1 + j0) * F;
  const float* line1 = line0 + static_cast<size_t>(g.r1) * F;
  uint4* run = out + (static_cast<size_t>(blockIdx.y) * g.m1 + j0) * cpr;
  unsigned sum = 0;
  for (unsigned q = threadIdx.x; q < nj * cpr; q += blockDim.x) {
    const unsigned r = q / cpr, c = q - r * cpr;
    float4 v[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const unsigned e = (c * kUnits + u) * 4;
      const bool dx = e >= 2 * F;
      const float* src = (dx ? line1 : line0) + r * F + (dx ? e - 2 * F : e);
      if (kLoads) {
        v[u] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        const float a = __uint_as_float(static_cast<unsigned>(src - table));
        v[u] = make_float4(a, a + 1.0f, a + 2.0f, a + 3.0f);
      }
    }
    const uint4 p = PROBE == 4 ? high_bytes(v) : pack16(v);
    if (kStores) {
      run[q] = p;
    } else {
      sum ^= p.x ^ p.y ^ p.z ^ p.w;
    }
  }
  if (!kStores) sums[(blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x] = sum;
}

template <typename Bits>
cudaError_t probe_quad(int probe, const float* t, const QuadGeom& g, dim3 grid, int threads,
                       uint4* o, unsigned* sums, cudaStream_t s) {
  switch (probe) {
    case 0: quad_probe_kernel<Bits, 0><<<grid, threads, 0, s>>>(t, g, o, sums); break;
    case 1: quad_probe_kernel<Bits, 1><<<grid, threads, 0, s>>>(t, g, o, sums); break;
    case 2: quad_probe_kernel<Bits, 2><<<grid, threads, 0, s>>>(t, g, o, sums); break;
    case 3: quad_probe_kernel<Bits, 3><<<grid, threads, 0, s>>>(t, g, o, sums); break;
    default: quad_probe_kernel<Bits, 4><<<grid, threads, 0, s>>>(t, g, o, sums); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The direct design over a table of F = 32 on a 16-byte boundary, a block
// per i and `band` cells of j; sums: one unsigned per launched thread,
// scratch for the probes without stores.
int tn_probe_quad(const void* table, int r0, int r1, int f, int out_bytes, int probe, int band,
                  int threads, void* out, void* sums, void* stream) {
  if (r0 < 2 || r1 < 2 || f != kProbeF || probe < 0 || probe > 4 || band < 1 || threads < 32 ||
      threads > kQuadMaxThreads || threads % 32 != 0 || r0 - 1 > 65535 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  QuadGeom g = {};
  g.r1 = r1, g.f = f, g.m0 = r0 - 1, g.m1 = r1 - 1;
  g.band = band < r1 - 1 ? band : r1 - 1;
  const dim3 grid((g.m1 + g.band - 1) / g.band, r0 - 1);
  auto s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  uint4* o = static_cast<uint4*>(out);
  unsigned* u = static_cast<unsigned*>(sums);
  cudaError_t err;
  switch (out_bytes) {
    case 1: err = probe_quad<uint8_t>(probe, t, g, grid, threads, o, u, s); break;
    case 2: err = probe_quad<uint16_t>(probe, t, g, grid, threads, o, u, s); break;
    case 4: err = probe_quad<uint32_t>(probe, t, g, grid, threads, o, u, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
