// The camera frame: every pixel of every env row cast as a ray against the
// ground plane and the bodies of its row, classified and shaded, in one
// launch that writes only the modalities asked for (depth, semantic, rgb,
// instance, as ops/camera.py::render_plain computes them).
//
// Replaces no TPU kernel. The JAX package computes the frame with jnp
// broadcasts (metadrive_ped_tpu/ops/camera.py), and the port's plain
// version, ops/camera.py::render_plain, is the same broadcast chain: every
// pixel against every lane ([rows, H*W, L]), every segment ([rows, H*W, B])
// and every body ([rows, H*W, T]), about 3,500 launches over float32
// temporaries of up to 2^28 elements at the benchmark's 1024 envs x 84 x 84
// pixels x 370 segments. The kernel keeps every intermediate in registers
// and writes only the frame.
//
// What bounds it on the H100: float32 instructions. Each (ground pixel,
// lane) pair is the lane's local coordinates, for a circular lane an
// atan2f, a sqrtf and four wraps to (-pi, pi]; each (ground pixel, line or
// sidewalk segment) pair a projection with one division and a sqrtf; each
// (pixel, active body) pair three slabs with two IEEE reciprocals. With no
// fast math and -fmad=false every product and sum is an instruction of its
// own, held against 33.5 T instructions/s (132 SMs x 128 float32 lanes x
// 1.98 GHz). The frame written once (10 floats a pixel, 289 MB at the
// benchmark's size) takes 0.09 ms at 3.35 TB/s: the instructions set the
// bound.
//
// What the design does about it:
// - One block per (env row, tile of kThreads pixels), one thread per pixel,
//   neighbouring threads on neighbouring pixels so that the [E, H, W, C]
//   writes coalesce. All threads of a block walk one list of lanes, one of
//   segments and one of bodies (those of their row), in step: a lane's kind
//   is the same in every thread, so a warp runs only the straight or only
//   the circular branch.
// - The per-primitive terms are formed once per block, not per pixel: warp
//   0 stages a tile of the row's lanes (the wrapped start and end phases,
//   the half width), of its segments (the direction, the clamped squared
//   length, the threshold) or of its bodies (the camera in the body's frame
//   and the slab numerators) into shared memory, with the roundings the
//   plain chain gives them, and keeps only the primitives that can decide
//   a pixel: lanes longer than 1e-3, valid sidewalk and line segments,
//   active bodies. A staged body keeps its slot index.
// - Exact short-circuits, each leaving the result the plain chain's: the
//   nearest body first, then the ground class only for pixels that show
//   the ground (a ray that meets the plane before any body and within
//   FAR / 2) and only when semantic or rgb is asked for; sidewalks before
//   lines before lanes, each loop ending at its first hit (a sidewalk
//   decides the class over a line, a line over the road); the second pass
//   over the bodies (the first slot within 1e-6 of the nearest) only for
//   pixels that show a body. A block in which no pixel needs a stage skips
//   its staging.
// - No cull by space: every staged primitive is tested against every pixel
//   that needs it, so the work stays at most what
//   benchmarks/camera_work.py counts.
// No tensor cores: the per-pair work is comparisons, a rotation, an atan2f
// and divisions, and rounding the inputs to TF32 would move class and hit
// decisions at the edges.
//
// Rounding, so that every modality equals the plain chain's on the card
// bit for bit (up to the sign of a zero):
// - every product and sum is rounded on its own (-fmad=false, set by
//   core/cuda_build.py), in the plain chain's order;
// - the cos and sin of every heading and the heading-free rays come in from
//   torch (ops/camera.py), so they are PyTorch's own bits; atan2f, sqrtf
//   and the divisions are the CUDA math library's, which PyTorch's kernels
//   call (atan2f gives PyTorch's bits with and without -fmad=false);
// - a Python number meets a float32 tensor as float32: 1e-6, 1e-9, 1e-3,
//   pi and 2 pi below are those floats, and PyTorch divides a tensor by a
//   Python number as a multiply by the float reciprocal (inv_max_dist, and
//   the instance colours' 1 / 255);
// - `x % (2 pi)` is PyTorch's float remainder: fmod, plus the divisor where
//   the signs differ (`wrap_to_pi`);
// - torch.minimum / maximum / clamp propagate NaN where fminf / fmaxf do
//   not: the body slabs never see a NaN (the proof is at `stage_boxes`),
//   and the other clamps are written as PyTorch's (`clamp_nan`).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// The launch's arguments, one struct so that the wrapper passes them by
// name (ops/camera.py::_Args mirrors it field for field). Pointers are
// device pointers to contiguous tensors; an output left null is not
// written.
struct CameraArgs {
  // env rows [E]: scenario index (int32), ego position [E, 2], the cos and
  // sin of its heading, its length
  const int* sidx;
  const float* pos;
  const float* cos_h;
  const float* sin_h;
  const float* length;
  // heading-free camera rays [P] (ops/camera.py::camera_rays)
  const float* ray_x;
  const float* ray_y;
  const float* ray_z;
  // lanes of every scenario [S, L] (p0 and dir [S, L, 2])
  const int* lane_kind;
  const float* lane_p0;
  const float* lane_dir;
  const float* lane_radius;
  const float* lane_start_phase;
  const float* lane_arc_dir;
  const float* lane_width;
  const float* lane_length;
  const float* lane_angle;
  // boundary segments of every scenario [S, B] (p0, p1 [S, B, 2]; valid bool)
  const float* seg_p0;
  const float* seg_p1;
  const int* seg_type;
  const float* seg_halfwidth;
  const uint8_t* seg_valid;
  // bodies of every row [E, T] (pos [E, T, 2], the cos and sin of their
  // headings; active bool) and the static objects' kinds [E, O] (int32)
  const float* t_pos;
  const float* t_cos;
  const float* t_sin;
  const float* t_len;
  const float* t_wid;
  const uint8_t* t_active;
  const int* obj_kind;
  // the semantic palette [9, 3]
  const float* palette;
  // outputs [E, P] and [E, P, 3]
  float* depth;
  float* semantic;
  float* rgb;
  float* instance;
  // where not null, the (pixel, body) pairs the box tests computed are
  // added to it (the tracer's camera.boxes_computed)
  unsigned long long* box_tests;
  int E, P, S, L, B, T, O;
  // the bodies' kind slices: objects [obj0, obj0 + O), pedestrians [ped0, ped1)
  int obj0, ped0, ped1;
  // the scene's codes: constants.py's LANE_CIRCULAR, SEG_SIDEWALK,
  // SEG_YELLOW_LINE, SEG_WHITE_LINE and mapgen/scene.py's OBJ_BUILDING
  int lane_circular, seg_sidewalk, seg_yellow, seg_white, obj_building;
  float cam_h;         // float32(cam_height)
  float line_probe;    // added to a segment's half width
  float inv_max_dist;  // float32(1) / float32(max_dist)
};

namespace {

constexpr int kThreads = 256;   // pixels of one block
constexpr int kLaneTile = 256;  // lanes staged per pass (9 KB of shared memory)
constexpr int kSegTile = 512;   // segments staged per pass (12 KB)
constexpr int kBoxTile = 128;   // bodies staged per pass (5 KB)

constexpr float kFar = 1e6f;
constexpr float kHalfFar = 5e5f;
// the float32 values of Python's math.pi and 2.0 * math.pi
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// semantic class ids: ops/camera.py's SEM_*
enum Sem { SKY = 0, ROAD = 1, LANE_LINE = 2, SIDEWALK = 3, TERRAIN = 4, CAR = 5,
           PEDESTRIAN = 6, OBJECT = 7, BUILDING = 8 };

struct Shared {
  // lanes: (p0x, p0y, length, half width), then (dirx, diry, -, -) for a
  // straight lane or (wrapped start phase, wrapped end phase, arc_dir,
  // radius) for a circular one
  float4 lane_a[kLaneTile];
  float4 lane_b[kLaneTile];
  int lane_circ[kLaneTile];
  // segments, sidewalks first then lines: (p0x, p0y, abx, aby), (clamped
  // squared length, threshold)
  float4 seg_a[kSegTile];
  float2 seg_b[kSegTile];
  // bodies: (cos, sin, -hx - ox, hx - ox), (-hy - oy, hy - oy, height -
  // cam_h, -), their slot index and semantic class
  float4 box_a[kBoxTile];
  float4 box_b[kBoxTile];
  int box_slot[kBoxTile];
  int box_sem[kBoxTile];
  int count[2];
};

// PyTorch's clamp(x, lo, hi) and clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// fmodf(x, y) for y > 0, with the cases the camera meets (|x| < 2y) in a
// few instructions: |x| - y is exact where y <= |x| < 2y (Sterbenz), and
// fmodf is exact, so both give the same float.
__device__ __forceinline__ float fmod_pos(float x, float y) {
  const float ax = fabsf(x);
  if (ax < y) return x;
  if (ax < 2.0f * y) return copysignf(ax - y, x);
  return fmodf(x, y);
}

// ops/math_ops.py::wrap_to_pi as PyTorch computes it in float32
__device__ __forceinline__ float wrap_to_pi(float x) {
  float m = fmod_pos(x, kTwoPi);
  if (m != 0.0f && m < 0.0f) m = m + kTwoPi;
  return m - (m > kPi ? kTwoPi : 0.0f);
}

// 1 / where(|d| < 1e-9, 1e-9, d): torch.reciprocal, an IEEE division
__device__ __forceinline__ float guarded_reciprocal(float d) {
  return 1.0f / (fabsf(d) < 1e-9f ? 1e-9f : d);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Warp 0: lanes [base, base + n) of scenario s into shared memory, those
// with length > 1e-3 (the on-road test's last term: the others can never
// put a pixel on the road), with the per-lane terms of
// ops/lane_geom.py::local_coordinates. Returns their count.
__device__ int stage_lanes(const CameraArgs& a, Shared& sm, int s, int base, int n) {
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + (threadIdx.x & 31);
    bool keep = false;
    float4 la = make_float4(0.0f, 0.0f, 0.0f, 0.0f), lb = la;
    int circ = 0;
    if (j < n) {
      const size_t i = static_cast<size_t>(s) * a.L + base + j;
      const float len = a.lane_length[i];
      keep = len > 1e-3f;
      circ = a.lane_kind[i] == a.lane_circular;
      la = make_float4(a.lane_p0[2 * i], a.lane_p0[2 * i + 1], len, a.lane_width[i] * 0.5f);
      if (circ) {
        const float sp = a.lane_start_phase[i];
        const float arc = a.lane_arc_dir[i];
        lb = make_float4(wrap_to_pi(sp), wrap_to_pi(sp + arc * a.lane_angle[i]), arc,
                         clamp_min_nan(a.lane_radius[i], 1e-6f));
      } else {
        lb = make_float4(a.lane_dir[2 * i], a.lane_dir[2 * i + 1], 0.0f, 0.0f);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int at = count + __popc(ballot & lanes_below());
      sm.lane_a[at] = la;
      sm.lane_b[at] = lb;
      sm.lane_circ[at] = circ;
    }
    count += __popc(ballot);
  }
  return count;
}

// Warp 0: the valid segments [base, base + n) of scenario s of one kind
// (sidewalks, or yellow and white lines) into shared memory from index
// `start`, with their per-segment terms. Returns start + their count. A
// segment of another kind (a broken line) decides nothing in the frame.
__device__ int stage_segments(const CameraArgs& a, Shared& sm, int s, int base, int n,
                              bool walks, int start) {
  int count = start;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + (threadIdx.x & 31);
    bool keep = false;
    float4 sa = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 sb = make_float2(0.0f, 0.0f);
    if (j < n) {
      const size_t i = static_cast<size_t>(s) * a.B + base + j;
      const int type = a.seg_type[i];
      keep = a.seg_valid[i] != 0 &&
             (walks ? type == a.seg_sidewalk : (type == a.seg_yellow || type == a.seg_white));
      const float p0x = a.seg_p0[2 * i], p0y = a.seg_p0[2 * i + 1];
      const float abx = a.seg_p1[2 * i] - p0x;
      const float aby = a.seg_p1[2 * i + 1] - p0y;
      sa = make_float4(p0x, p0y, abx, aby);
      sb = make_float2(clamp_min_nan(abx * abx + aby * aby, 1e-9f),
                       a.seg_halfwidth[i] + a.line_probe);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int at = count + __popc(ballot & lanes_below());
      sm.seg_a[at] = sa;
      sm.seg_b[at] = sb;
    }
    count += __popc(ballot);
  }
  return count;
}

// Warp 0: the bodies [base, base + n) of row e into shared memory, seen
// from the camera at (ox, oy): the active ones that can be hit, in slot
// order, each with its slot and semantic class. Returns their count.
//
// A body is left out where the plain chain cannot count a hit on it: it is
// inactive, or one of its slab numerators or its height term is NaN (then
// a slab's t1 and t2 are NaN, torch.minimum / maximum carry the NaN into
// tnear or tfar, and tfar >= tnear is false). For a body kept and a live
// pixel (its world ray not NaN, |ray| <= 2), no t of the pair is NaN: the
// cos and sin are not NaN (a NaN in either makes a numerator NaN), so the
// rotated directions are finite; the guard makes the reciprocals finite
// and not 0; a numerator that is not NaN times such a reciprocal is not
// NaN. So fminf / fmaxf take the values torch.minimum / maximum take.
__device__ int stage_boxes(const CameraArgs& a, Shared& sm, int e, float ox, float oy, int base,
                           int n) {
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + (threadIdx.x & 31);
    const int k = base + j;
    bool keep = false;
    float4 ba = make_float4(0.0f, 0.0f, 0.0f, 0.0f), bb = ba;
    int sem = CAR;
    if (j < n) {
      const size_t i = static_cast<size_t>(e) * a.T + k;
      const float c = a.t_cos[i];
      const float s = a.t_sin[i];
      const float relx = a.t_pos[2 * i] - ox;
      const float rely = a.t_pos[2 * i + 1] - oy;
      // the camera in the body's frame, relative to its centre
      const float bx = -(relx * c + rely * s);
      const float by = -((-relx) * s + rely * c);
      const float hx = a.t_len[i] * 0.5f;
      const float hy = a.t_wid[i] * 0.5f;
      float hgt = 1.5f;
      if (k >= a.ped0 && k < a.ped1) {
        hgt = 1.75f;
        sem = PEDESTRIAN;
      } else if (k >= a.obj0 && k < a.obj0 + a.O) {
        const bool building =
            a.obj_kind[static_cast<size_t>(e) * a.O + (k - a.obj0)] == a.obj_building;
        hgt = building ? 5.0f : 1.0f;
        sem = building ? BUILDING : OBJECT;
      }
      ba = make_float4(c, s, -hx - bx, hx - bx);
      bb = make_float4(-hy - by, hy - by, hgt - a.cam_h, 0.0f);
      keep = a.t_active[i] != 0 && !isnan(ba.z) && !isnan(ba.w) && !isnan(bb.x) &&
             !isnan(bb.y) && !isnan(bb.z);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int at = count + __popc(ballot & lanes_below());
      sm.box_a[at] = ba;
      sm.box_b[at] = bb;
      sm.box_slot[at] = k;
      sm.box_sem[at] = sem;
    }
    count += __popc(ballot);
  }
  return count;
}

// ops/camera.py::_box_hits for one (pixel, body) pair: the body's tval,
// tnear where the slabs overlap and kFar where they do not. z_lo = (0 -
// cam_h) * inv_z is the pixel's own.
__device__ __forceinline__ float box_t(float wx, float wy, float inv_z, float z_lo, float4 ba,
                                       float4 bb) {
  const float dx = wx * ba.x + wy * ba.y;
  const float dy = (-wx) * ba.y + wy * ba.x;
  const float inv_x = guarded_reciprocal(dx);
  const float inv_y = guarded_reciprocal(dy);
  const float x1 = ba.z * inv_x, x2 = ba.w * inv_x;
  const float y1 = bb.x * inv_y, y2 = bb.y * inv_y;
  const float z2 = bb.z * inv_z;
  const float tnear = fmaxf(fmaxf(fminf(x1, x2), fminf(y1, y2)), fmaxf(fminf(z_lo, z2), 0.0f));
  const float tfar = fminf(fminf(fmaxf(x1, x2), fmaxf(y1, y2)), fmaxf(z_lo, z2));
  return tfar >= tnear ? tnear : kFar;
}

// ops/camera.py::_ground_hit's segment test for one (ground point, segment)
// pair: its distance within the segment's threshold
__device__ __forceinline__ bool near_segment(float px, float py, float4 sa, float2 sb) {
  const float apx = px - sa.x;
  const float apy = py - sa.y;
  const float tt = clamp_nan((apx * sa.z + apy * sa.w) / sb.x, 0.0f, 1.0f);
  const float ex = px - (sa.x + tt * sa.z);
  const float ey = py - (sa.y + tt * sa.w);
  return sqrtf(ex * ex + ey * ey) <= sb.y;
}

// ops/camera.py::_ground_hit's on-road test for one (ground point, lane)
// pair: ops/lane_geom.py::local_coordinates of the lane's kind, within the
// lane's span and half width (its length > 1e-3 was the staging's test)
__device__ __forceinline__ bool on_lane(float px, float py, float4 la, float4 lb, bool circ) {
  const float dx = px - la.x;
  const float dy = py - la.y;
  float lon, lat;
  if (circ) {
    const float ap = wrap_to_pi(atan2f(dy, dx));
    const float ds = ap - lb.x;
    const float de = ap - lb.y;
    const float d_start = fabsf(wrap_to_pi(ds));
    const float d_end = fabsf(wrap_to_pi(de));
    lon = d_start > d_end ? wrap_to_pi(lb.z * de) * lb.w + la.z : wrap_to_pi(lb.z * ds) * lb.w;
    lat = lb.z * (sqrtf(dx * dx + dy * dy) - lb.w);
  } else {
    lon = dx * lb.x + dy * lb.y;
    lat = dx * lb.y - dy * lb.x;
  }
  return lon >= 0.0f && lon <= la.z && fabsf(lat) <= la.w;
}

// Block (e, tile): env row e, pixels tile * kThreads + threadIdx.x.
__global__ void __launch_bounds__(kThreads) camera_kernel(const CameraArgs a) {
  __shared__ Shared sm;
  const int e = blockIdx.x;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const bool has = p < a.P;
  const size_t q = static_cast<size_t>(e) * a.P + p;
  const bool warp0 = threadIdx.x < 32;
  const int s = a.sidx[e];
  if (s < 0 || s >= a.S) {  // the whole block: a row without a scenario reads NaN
    if (has) {
      const float nan = CUDART_NAN_F;
      if (a.depth) a.depth[q] = nan;
      for (int c = 0; c < 3; ++c) {
        if (a.semantic) a.semantic[3 * q + c] = nan;
        if (a.rgb) a.rgb[3 * q + c] = nan;
        if (a.instance) a.instance[3 * q + c] = nan;
      }
    }
    return;
  }
  const bool want_class = a.semantic != nullptr || a.rgb != nullptr;
  const bool want_slot = want_class || a.instance != nullptr;

  // the camera over the windshield, a quarter of the length ahead, and the
  // pixel's ray rotated into the world by the heading
  const float ch = a.cos_h[e], sh = a.sin_h[e];
  const float ahead = a.length[e] * 0.25f;
  const float ox = a.pos[2 * e] + ahead * ch;
  const float oy = a.pos[2 * e + 1] + ahead * sh;
  float wx = 0.0f, wy = 0.0f, wz = 0.0f;
  if (has) {
    const float rx = a.ray_x[p], ry = a.ray_y[p];
    wx = ch * rx - sh * ry;
    wy = sh * rx + ch * ry;
    wz = a.ray_z[p];
  }
  const bool live = has && !isnan(wx) && !isnan(wy) && !isnan(wz);

  // the ground plane z = 0
  const float tg = wz < -1e-6f ? (-a.cam_h) / wz : kFar;
  const float gx = ox + tg * wx;
  const float gy = oy + tg * wy;

  // the nearest body: tbest over every slot (an inactive or missed slot
  // reads kFar)
  const float inv_z = guarded_reciprocal(wz);
  const float z_lo = (-a.cam_h) * inv_z;
  const int box_tiles = (a.T + kBoxTile - 1) / kBoxTile;
  float best = kFar;
  unsigned long long tests = 0;
  for (int t = 0; t < box_tiles; ++t) {
    __syncthreads();
    if (warp0) {
      const int m = stage_boxes(a, sm, e, ox, oy, t * kBoxTile, min(kBoxTile, a.T - t * kBoxTile));
      if (threadIdx.x == 0) sm.count[0] = m;
    }
    __syncthreads();
    const int m = sm.count[0];
    if (live) {
      for (int k = 0; k < m; ++k) best = fminf(best, box_t(wx, wy, inv_z, z_lo, sm.box_a[k],
                                                           sm.box_b[k]));
      tests += m;
    }
  }
  const bool box_wins = best < tg;
  const float t_hit = box_wins ? best : tg;
  const bool hit = t_hit < kHalfFar;

  // the body a pixel shows: the first slot whose tval is within 1e-6 of
  // tbest. Where the pixel shows a body, tbest + 1e-6 < kFar, so only a
  // staged slot that is hit can be within it.
  const bool need_slot = want_slot && box_wins && hit;
  int slot = 0, box_sem = CAR;
  if (__syncthreads_or(need_slot)) {
    const float thr = best + 1e-6f;
    bool found = false;
    for (int t = 0; t < box_tiles; ++t) {
      if (box_tiles > 1) {
        __syncthreads();
        if (warp0) {
          const int m =
              stage_boxes(a, sm, e, ox, oy, t * kBoxTile, min(kBoxTile, a.T - t * kBoxTile));
          if (threadIdx.x == 0) sm.count[0] = m;
        }
        __syncthreads();
      }
      const int m = sm.count[0];
      if (need_slot && !found) {
        int k = 0;
        for (; k < m; ++k) {
          if (box_t(wx, wy, inv_z, z_lo, sm.box_a[k], sm.box_b[k]) <= thr) {
            slot = sm.box_slot[k];
            box_sem = sm.box_sem[k];
            found = true;
            break;
          }
        }
        tests += found ? k + 1 : k;
      }
    }
  }

  // the ground's class where the pixel shows the ground: sidewalk over
  // line over road over terrain
  const bool need_class = want_class && !box_wins && hit;
  int ground = TERRAIN;
  if (__syncthreads_or(need_class)) {
    bool walk = false, line = false, road = false;
    for (int base = 0; base < a.B; base += kSegTile) {
      __syncthreads();
      if (warp0) {
        const int n = min(kSegTile, a.B - base);
        const int nw = stage_segments(a, sm, s, base, n, true, 0);
        const int nl = stage_segments(a, sm, s, base, n, false, nw);
        if (threadIdx.x == 0) {
          sm.count[0] = nw;
          sm.count[1] = nl;
        }
      }
      __syncthreads();
      const int nw = sm.count[0], nl = sm.count[1];
      if (need_class && !walk) {
        for (int k = 0; k < nw; ++k) {
          if (near_segment(gx, gy, sm.seg_a[k], sm.seg_b[k])) {
            walk = true;
            break;
          }
        }
      }
      if (need_class && !walk && !line) {
        for (int k = nw; k < nl; ++k) {
          if (near_segment(gx, gy, sm.seg_a[k], sm.seg_b[k])) {
            line = true;
            break;
          }
        }
      }
    }
    const bool need_road = need_class && !walk && !line;
    if (__syncthreads_or(need_road)) {
      for (int base = 0; base < a.L; base += kLaneTile) {
        __syncthreads();
        if (warp0) {
          const int m = stage_lanes(a, sm, s, base, min(kLaneTile, a.L - base));
          if (threadIdx.x == 0) sm.count[0] = m;
        }
        __syncthreads();
        const int m = sm.count[0];
        if (need_road && !road) {
          for (int k = 0; k < m; ++k) {
            if (on_lane(gx, gy, sm.lane_a[k], sm.lane_b[k], sm.lane_circ[k] != 0)) {
              road = true;
              break;
            }
          }
        }
      }
    }
    ground = walk ? SIDEWALK : line ? LANE_LINE : road ? ROAD : TERRAIN;
  }
  if (a.box_tests) {  // a warp's sum, one atomic a warp
    for (int off = 16; off > 0; off >>= 1) tests += __shfl_down_sync(0xffffffffu, tests, off);
    if ((threadIdx.x & 31) == 0 && tests) atomicAdd(a.box_tests, tests);
  }
  if (!has) return;

  const int sem = hit ? (box_wins ? box_sem : ground) : SKY;
  if (a.depth) a.depth[q] = clamp_nan(t_hit * a.inv_max_dist, 0.0f, 1.0f);
  if (want_class) {
    // flat shading: the class colour attenuated by distance; sky unshaded
    const float shade = hit ? 1.0f / (0.02f * t_hit + 1.0f) : 1.0f;
    for (int c = 0; c < 3; ++c) {
      const float color = a.palette[3 * sem + c];
      if (a.semantic) a.semantic[3 * q + c] = color;
      if (a.rgb) a.rgb[3 * q + c] = color * shade;
    }
  }
  if (a.instance) {
    // a colour per slot, ((slot * k + b) % 255) / 255; background black
    const bool shows = box_wins && hit;
    const int mul[3] = {37, 91, 53}, add[3] = {13, 71, 29};
    for (int c = 0; c < 3; ++c) {
      a.instance[3 * q + c] =
          shows ? static_cast<float>((slot * mul[c] + add[c]) % 255) * (1.0f / 255.0f) : 0.0f;
    }
  }
}

}  // namespace

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// E >= 1 rows, 1 <= P <= 65535 * kThreads pixels.
extern "C" int camera_launch(const CameraArgs* args, void* stream) {
  const dim3 grid(static_cast<unsigned>(args->E), (args->P + kThreads - 1) / kThreads);
  camera_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
