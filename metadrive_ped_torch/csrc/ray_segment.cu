// Ray-vs-segment min-hit sweep: the side-detector and lane-line-detector
// clouds of the state observation, both in one launch.
//
// Replaces the Pallas TPU kernel metadrive_ped_tpu/ops/pallas_raycast.py:52-81
// (`ray_segment_fraction_pallas`, body `_kernel`). For every env e and ray r
// it solves o + t*d = a + u*s against line segments a + u*s of the env's
// scenario. A segment is hit where t >= 0 and 0 <= u <= 1; a hit gives
// clip(t / max_dist, 0, 1) and a miss 1. Where |d x s| < 1e-9 the
// denominator is set to 1e-9. Each output is the min over the segments.
// The side detector sees the scenario's continuous lines, rows
// [0, n_cont) of its line table; the lane-line detector sees all lines,
// rows [0, n_any) (ops/ray_segment.py::build_line_table). The plain
// version is ops/ray_segment.py::detector_clouds_plain.
//
// What bounds it on the H100: 21 float32 operations per (ray, line) pair,
// two of them true divisions, against a few bytes per ray; the work sets
// the bound (about 0.05 ms a step at 8192 envs, chip_smoke.py). The kernel
// is bound by the instructions it issues: an IEEE division is a sequence
// of about ten instructions (no fast math, -fmad=false, so every decision
// matches the plain version's), so the design keeps them off most pairs.
// A culled pair still costs a dozen instructions or more (a shared-memory
// load, the two cross products and the first test; the guard and two more
// tests wherever one thread of the warp passes the first), and a warp
// runs the divisions where any of its threads keeps a pair.
//
// What the design does about it:
// - One launch for both clouds. One block takes one env: it stages its
//   scenario's rows [0, n_any) of the line table (16-byte cp.async copies,
//   tiles of kTile rows) and computes the per-(env, row) terms
//   rel = a - o and n_t = rel x s once, while the plain version computes
//   them per pair (the same rounded numbers: no FMA anywhere).
// - One thread per ray, its running min in a register: side rays over rows
//   [0, n_cont), lane-line rays over rows [0, n_any). A detector with
//   fewer rays than its threads (the lane-line detector's 12 rays get 64
//   threads) gives each ray several threads, each a stride of the rows,
//   and merges their mins through shared memory (a min is exact in any
//   order). Each thread of the side detector takes about 106 rows on the
//   main path, each of the lane-line detector about 61. (One warp per env
//   for the lane-line rays, each lane a stride of the rows for all rays,
//   was slower: its mins did not fit in registers.)
// - An exact cull rejects, without dividing, the pairs that the plain
//   version provably misses (the proof is at `pair`): every pair whose
//   line the ray does not cross in front of it, most pairs of a ray. The
//   rest divide n_t once, and n_u only near u = 0 or 1.
// - The running min is kept of t, not of clip(t / max_dist): both maps are
//   monotone, so min(clip(t / d)) = clip(min(t) / d), one scaling per ray,
//   and +inf (no hit) gives 1. The scaling is t * fl(1 / d), as PyTorch's
//   CUDA division of a tensor by a scalar computes it, so a t near d falls
//   on the same side of 1 as in the plain version on the card.
// No tensor cores: the per-pair work is a K = 2 cross product, and wgmma /
// mma take TF32 or narrower inputs for float32 data; rounding the inputs
// would move hit/miss decisions at u ~ 0, u ~ 1 and t ~ 0 away from the
// plain version's.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;           // table rows staged per pass (10 KB shared)
constexpr int kMaxRayThreads = 256;  // threads of one detector in a block
constexpr int kLaneThreads = 64;     // least threads for the lane-line detector
constexpr float kTwo126 = 0x1p126f;
constexpr float kOnePlus = 1.0f + 0x1p-22f;
constexpr float kOneMinus = 1.0f - 0x1p-22f;

// One (ray, row) pair: lowers tmin to the pair's t where the plain version
// counts a hit. Row = (rel_x, rel_y, s_x, s_y), nt = rel_x*s_y - rel_y*s_x.
//
// The plain version computes g (the guarded d x s), t = fl(nt / g) and
// u = fl(nu / g) with the same rounded nt, nu and g as here, and counts a
// hit iff t >= 0 && u >= 0 && u <= 1. Write tn = nt*sign(g) and
// un = nu*sign(g), so that the exact quotients are tn/|g| and un/|g|, with
// |g| >= 1e-9. m = sign(g) * 2^126, so fl(nt * m) = fl(tn * 2^126) and
// fl(nu * m) = fl(un * 2^126): scaling by a power of two is exact, or
// overflows to +-inf only where |tn| (|un|) >= 4 * (1 - 2^-25), which is
// more than 2^-126 * FLT_MAX >= 2^-126 |g|. fl is monotone and rounds to
// nearest; a product rounds with relative error at most 2^-24, and
// |g| >= 1e-9 keeps fl(|g| * c) out of the subnormal range. The guard
// makes |g| = max(|d x s|, 1e-9), which test 3 uses before g itself is
// formed: most pairs fail it, and a warp whose threads all do skips the
// rest.
// A pair is culled (counted a miss) only where one of these holds:
// 1. fl(nt * m) <= -|g|: then tn/|g| <= -2^-126 (exactly, or because the
//    product overflowed), so t = fl(nt/g) <= -2^-126 < 0: no hit. (A tiny
//    negative quotient rounds to -0, which passes t >= 0; the margin of
//    2^-126 keeps such pairs out of the cull.)
// 2. fl(nu * m) <= -|g|: u <= -2^-126 < 0 in the same way.
// 3. |nu| > fl(|g| * (1 + 2^-22)) >= |g| * (1 + 2^-22) * (1 - 2^-24)
//    > |g| * (1 + 2^-24). Where nu has the sign of g, un/|g| lies above
//    the midpoint between 1 and 1 + 2^-23, so u = fl(nu/g) >= 1 + 2^-23
//    > 1 (quotients up to 1 + 2^-24 round to 1, a hit; the margin keeps
//    them out). Where it has the other sign, un/|g| < -1 and u <= -1 < 0.
//    Either way no hit. If the product overflows to +inf, no cull.
// A NaN in nt, nu or g makes the tests false, so the pair is culled (or,
// where d x s is NaN and fmaxf gives 1e-9, passes test 3 and meets
// g = NaN); the plain version's t or u is then NaN, and every comparison
// with NaN is false: a miss as well.
// Pairs that stay divide nt exactly. fl(nu * m) >= 0 means un >= 0 (or
// un = -0), so u = fl(un/|g|) >= 0 or u = -0, which passes u >= 0; and
// |nu| <= fl(|g| * (1 - 2^-22)) <= |g| * (1 - 2^-22) * (1 + 2^-24) < |g|
// gives u <= 1. There the hit is t >= 0; anywhere else u is divided too
// and tested as the plain version tests it.
__device__ __forceinline__ void pair(float dx, float dy, float4 row, float nt, float& tmin) {
  const float denom = dx * row.w - dy * row.z;
  const float nu = row.x * dy - row.y * dx;
  const float ag = fmaxf(fabsf(denom), 1e-9f);
  if (!(fabsf(nu) <= ag * kOnePlus)) return;
  const float g = fabsf(denom) < 1e-9f ? 1e-9f : denom;
  const float m = __uint_as_float((__float_as_uint(g) & 0x80000000u) | __float_as_uint(kTwo126));
  const float num = nu * m;
  if (!(nt * m > -ag && num > -ag)) return;
  const float t = nt / g;
  bool hit;
  if (num >= 0.0f && fabsf(nu) <= ag * kOneMinus) {
    hit = t >= 0.0f;
  } else {
    const float u = nu / g;
    hit = t >= 0.0f && u >= 0.0f && u <= 1.0f;
  }
  if (hit) tmin = fminf(tmin, t);
}

__device__ __forceinline__ float fraction(float tmin, float max_dist) {
  return fminf(fmaxf(tmin * (1.0f / max_dist), 0.0f), 1.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// The rays of one detector in block (e, chunk): its threads t in
// [0, threads) take ray chunk * per_chunk + t % per_chunk, where
// per_chunk = min(R, threads), and slice q = t / per_chunk of the rows
// (rows q, q + slices, ...), slices = threads / per_chunk. A detector with
// few rays so spreads its rows over several threads per ray.
struct Rays {
  int per_chunk, slices, k, q;
  bool has_ray;
  __device__ Rays(int R, int threads, int t, int chunk) {
    per_chunk = R < threads ? R : threads;
    slices = per_chunk > 0 ? threads / per_chunk : 1;
    q = per_chunk > 0 ? t / per_chunk : 0;
    k = chunk * per_chunk + (per_chunk > 0 ? t % per_chunk : 0);
    has_ray = per_chunk > 0 && q < slices && k < R;
  }
};

// Block (e, chunk): threads [0, side_threads) take side rays, the rest
// lane-line rays (`Rays`).
__global__ void __launch_bounds__(2 * kMaxRayThreads)
detector_clouds_kernel(const float2* __restrict__ origin, const int* __restrict__ sidx,
                       const float* __restrict__ sdx, const float* __restrict__ sdy,
                       const float* __restrict__ ldx, const float* __restrict__ ldy,
                       float side_dist, float lane_dist, const float4* __restrict__ table,
                       const int2* __restrict__ counts, float* __restrict__ side_out,
                       float* __restrict__ lane_out, int Rs, int Rl, int S, int Bl,
                       int side_threads) {
  __shared__ __align__(16) float4 s_row[kTile];
  __shared__ float s_nt[kTile];
  __shared__ float s_min[2 * kMaxRayThreads];  // each thread's running min, to merge slices

  const int e = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const bool is_side = tid < side_threads;
  const int R = is_side ? Rs : Rl;
  const int first = is_side ? 0 : side_threads;  // this detector's first thread
  const Rays rays(R, is_side ? side_threads : blockDim.x - side_threads, tid - first, chunk);
  const size_t ray = static_cast<size_t>(e) * R + rays.k;
  float* out = is_side ? side_out : lane_out;

  const int s = sidx[e];
  if (s < 0 || s >= S) {  // the whole block leaves: no barrier is pending
    if (rays.has_ray && rays.q == 0) out[ray] = CUDART_NAN_F;
    return;
  }
  const int2 c = counts[s];
  const int n_cont = min(c.x, Bl);
  const int n_any = min(c.y, Bl);
  // rows this block stages: the lane-line detector's if it has rays here
  const Rays lane_rays(Rl, blockDim.x - side_threads, 0, chunk);
  const bool side_active = chunk * min(Rs, side_threads) < Rs;
  const int n_stage = lane_rays.has_ray ? n_any : (side_active ? n_cont : 0);
  const int n_mine = is_side ? n_cont : n_any;
  const float4* rows = table + static_cast<size_t>(s) * Bl;
  const float2 o = origin[e];

  float dx = 0.0f, dy = 0.0f;
  if (rays.has_ray) {
    dx = (is_side ? sdx : ldx)[ray];
    dy = (is_side ? sdy : ldy)[ray];
  }
  float tmin = CUDART_INF_F;

  for (int base = 0; base < n_stage; base += kTile) {
    const int n = min(kTile, n_stage - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = tid; j < n; j += blockDim.x) cp_async16(&s_row[j], &rows[base + j]);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // each thread turns the rows it copied into (rel_x, rel_y, s_x, s_y), n_t
    for (int j = tid; j < n; j += blockDim.x) {
      const float4 a = s_row[j];
      const float rel_x = a.x - o.x;
      const float rel_y = a.y - o.y;
      s_row[j] = make_float4(rel_x, rel_y, a.z, a.w);
      s_nt[j] = rel_x * a.w - rel_y * a.z;
    }
    __syncthreads();
    if (!rays.has_ray) continue;
    const int m = min(n, n_mine - base);
    if (rays.slices == 1) {  // a stride the compiler knows unrolls with fixed offsets
#pragma unroll 4
      for (int j = 0; j < m; ++j) pair(dx, dy, s_row[j], s_nt[j], tmin);
    } else {
#pragma unroll 4
      for (int j = rays.q; j < m; j += rays.slices) pair(dx, dy, s_row[j], s_nt[j], tmin);
    }
  }

  // merge the slices of each ray (a min is exact in any order)
  s_min[tid] = tmin;
  __syncthreads();
  if (!rays.has_ray || rays.q != 0) return;
  for (int q = 1; q < rays.slices; ++q) tmin = fminf(tmin, s_min[tid + q * rays.per_chunk]);
  out[ray] = fraction(tmin, is_side ? side_dist : lane_dist);
}

// threads of one detector: its rays rounded up to warps, at most kMaxRayThreads
int ray_threads(int R) {
  const int rounded = (R + 31) / 32 * 32;
  return rounded < kMaxRayThreads ? rounded : kMaxRayThreads;
}

}  // namespace

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// origin [E,2], side dx/dy [E,Rs], lane dx/dy [E,Rl], table [S,Bl,4]
// float32 (16-byte aligned), sidx [E] and counts [S,2] int32, side [E,Rs]
// and lane [E,Rl] float32 outputs, all contiguous on the current device;
// Rs + Rl > 0 and E > 0.
extern "C" int detector_clouds_launch(const void* origin, const void* sidx, const void* sdx,
                                      const void* sdy, const void* ldx, const void* ldy,
                                      float side_dist, float lane_dist, const void* table,
                                      const void* counts, void* side, void* lane, int E, int Rs,
                                      int Rl, int S, int Bl, void* stream) {
  const int side_threads = ray_threads(Rs);
  const int lane_threads = Rl == 0 ? 0 : ray_threads(Rl > kLaneThreads ? Rl : kLaneThreads);
  const int side_chunks = Rs > 0 ? (Rs + side_threads - 1) / side_threads : 1;
  const int lane_chunks = Rl > 0 ? (Rl + lane_threads - 1) / lane_threads : 1;
  const dim3 grid(E, side_chunks > lane_chunks ? side_chunks : lane_chunks);
  detector_clouds_kernel<<<grid, side_threads + lane_threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(origin), static_cast<const int*>(sidx),
      static_cast<const float*>(sdx), static_cast<const float*>(sdy),
      static_cast<const float*>(ldx), static_cast<const float*>(ldy), side_dist, lane_dist,
      static_cast<const float4*>(table), static_cast<const int2*>(counts),
      static_cast<float*>(side), static_cast<float*>(lane), Rs, Rl, S, Bl, side_threads);
  return static_cast<int>(cudaGetLastError());
}
