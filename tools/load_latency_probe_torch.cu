// A probe, not part of the port's library: the latency of one dependent
// 4-byte load on the card.  One thread follows a random cycle through a
// buffer, one element per 32-byte sector, each load's address the value of
// the one before (ld.global.cg: cached in L2, not in L1, as a gather into a
// grid larger than L1 finds it).  A buffer that fits the 50 MB L2 gives an
// L2 hit's latency once warm; one far larger than the L2 gives a load from
// device memory.  tools/walk_bound_torch.py builds and times it.

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start, long long steps, int* __restrict__ end) {
  int i = start;
  for (long long s = 0; s < steps; ++s) i = __ldcg(next + i);
  *end = i;  // keeps the chain
}

}  // namespace

extern "C" {

// next: the cycle (next[i] is the element after i); steps dependent loads
// from `start`, the last index written to end[0].
int tn_chase(const void* next, int start, long long steps, void* end, void* stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(next), start, steps,
                                                             static_cast<int*>(end));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
