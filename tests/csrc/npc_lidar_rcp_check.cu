// Test-only: counts the floats x with 2^-126 <= |x| < 2^126 (exponent field
// 1..252) where the per-NPC lidar kernel's reciprocal, rcp_rn, and the IEEE
// 1.0f / x differ in any bit. Built by tests/test_torch_cuda.py with the
// package's nvcc flags; it includes the kernel's source, so it checks the
// rcp_rn that ships.
#include "../../metadrive_ped_torch/csrc/npc_lidar.cu"

namespace {

__global__ void rcp_check_kernel(unsigned long long* mismatches) {
  unsigned long long bad = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  const unsigned long long first =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (unsigned long long i = first; i < (1ull << 32); i += stride) {
    const uint32_t bits = static_cast<uint32_t>(i);
    const uint32_t exponent = (bits >> 23) & 0xffu;
    if (exponent < 1 || exponent > 252) continue;
    const float x = __uint_as_float(bits);
    bad += __float_as_uint(rcp_rn(x)) != __float_as_uint(1.0f / x);
  }
  atomicAdd(mismatches, bad);
}

}  // namespace

// Adds to mismatches[0] (uint64 on the current device, zeroed by the caller)
// the floats where rcp_rn differs from 1.0f / x; launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int npc_lidar_rcp_mismatches(void* mismatches, void* stream) {
  rcp_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}
