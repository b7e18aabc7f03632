// Ray-vs-segment min-hit sweep: the side-detector and lane-line-detector
// clouds of the state observation.
//
// Replaces the Pallas TPU kernel metadrive_ped_tpu/ops/pallas_raycast.py:52-81
// (`ray_segment_fraction_pallas`, body `_kernel`). For every env e and ray r
// it solves o + t*d = a + u*s against each of the env's B segments
// (a = p0, s = p1 - p0). A segment is hit where t >= 0, 0 <= u <= 1 and it
// is valid; a hit gives clip(t / max_dist, 0, 1) and a miss 1. Where
// |denom| < 1e-9 the denominator is set to 1e-9. The output is the min over
// B, [E, R]. The plain version is ops/ray_segment.py::ray_segment_fraction.
//
// What bounds it on the H100: every (ray, valid segment) pair costs 21
// float32 operations, two of them true divisions, while the bytes are only
// the env's segment table (read once, reused by all R rays) and the ray
// directions. The side detector (R=160, continuous lines valid) is bound
// by operations, the lane-line detector (R=12) by bytes: at E=8192, B=540
// the bounds are 0.044 ms and 0.023 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py). Two IEEE divisions per pair cost far more than one
// operation each, which the bound does not see.
//
// What the design does about it: nothing of the [E, R, B] intermediate
// reaches device memory. One block takes one env (and one block of up to
// 256 rays); it stages that env's segments (a, s, valid) in shared memory,
// in tiles of kTile when B does not fit, and each thread owns one ray and
// keeps its running min in a register. Invalid segments are skipped.
// The build uses no --use_fast_math and -fmad=false, and both divisions
// stay true divisions: a reciprocal, a fast division or a fused
// multiply-add would move the hit/miss decision at u ~ 0 and u ~ 1 away
// from the plain version's.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;       // segments staged per pass (17 KB shared)
constexpr int kMaxThreads = 256;  // rays per block

__global__ void ray_segment_kernel(const float* __restrict__ origin,
                                   const float* __restrict__ dx,
                                   const float* __restrict__ dy,
                                   float max_dist,
                                   const float2* __restrict__ p0,
                                   const float2* __restrict__ p1,
                                   const unsigned char* __restrict__ valid,
                                   float* __restrict__ out, int R, int B) {
  __shared__ float s_ax[kTile];
  __shared__ float s_ay[kTile];
  __shared__ float s_sx[kTile];
  __shared__ float s_sy[kTile];
  __shared__ unsigned char s_valid[kTile];

  const int e = blockIdx.x;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  const bool has_ray = r < R;
  const float ox = origin[2 * e];
  const float oy = origin[2 * e + 1];
  const size_t ray = static_cast<size_t>(e) * R + r;
  const float rdx = has_ray ? dx[ray] : 0.0f;
  const float rdy = has_ray ? dy[ray] : 0.0f;
  const size_t seg0 = static_cast<size_t>(e) * B;

  float best = 1.0f;
  for (int base = 0; base < B; base += kTile) {
    const int n = min(kTile, B - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float2 a = p0[seg0 + base + j];
      const float2 b = p1[seg0 + base + j];
      s_ax[j] = a.x;
      s_ay[j] = a.y;
      s_sx[j] = b.x - a.x;
      s_sy[j] = b.y - a.y;
      s_valid[j] = valid[seg0 + base + j];
    }
    __syncthreads();
    if (!has_ray) continue;
    for (int j = 0; j < n; ++j) {
      if (!s_valid[j]) continue;
      const float sx = s_sx[j];
      const float sy = s_sy[j];
      float denom = rdx * sy - rdy * sx;
      if (fabsf(denom) < 1e-9f) denom = 1e-9f;
      const float rel_x = s_ax[j] - ox;
      const float rel_y = s_ay[j] - oy;
      const float t = (rel_x * sy - rel_y * sx) / denom;
      const float u = (rel_x * rdy - rel_y * rdx) / denom;
      if (t >= 0.0f && u >= 0.0f && u <= 1.0f) {
        best = fminf(best, fminf(fmaxf(t / max_dist, 0.0f), 1.0f));
      }
    }
  }
  if (has_ray) out[ray] = best;
}

}  // namespace

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// origin [E,2], dx/dy [E,R], p0/p1 [E,B,2] float32, valid [E,B] bytes,
// out [E,R] float32, all contiguous on the current device.
extern "C" int ray_segment_launch(const void* origin, const void* dx, const void* dy,
                                  float max_dist, const void* p0, const void* p1,
                                  const void* valid, void* out, int E, int R, int B,
                                  void* stream) {
  const int rounded = (R + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  const dim3 grid(E, (R + threads - 1) / threads);
  ray_segment_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origin), static_cast<const float*>(dx),
      static_cast<const float*>(dy), max_dist, static_cast<const float2*>(p0),
      static_cast<const float2*>(p1), static_cast<const unsigned char*>(valid),
      static_cast<float*>(out), R, B);
  return static_cast<int>(cudaGetLastError());
}
