"""Batched pinhole camera rendering (depth / semantic / instance / RGB).

The reference renders camera observations with OpenGL + GLSL shaders through
Panda3D offscreen buffers (component/sensors/base_camera.py:22-95,
rgb_camera.py, depth_cam.frag.glsl, the semantic camera through the engine's
object-id colour registry, base_engine.py:23-35). Here every pixel is an
analytic ray cast against the same scene tensors the physics uses:

  ground plane z=0   -> ROAD / LANE_LINE / SIDEWALK / TERRAIN by the
                        distance to lane centerlines and boundary segments
  target boxes       -> vehicles, traffic objects, buildings, pedestrians
                        (3D slab tests against heading-aligned boxes)
  no hit             -> SKY

It is a flat-shaded sensor renderer (semantic / depth / instance), not a
photoreal one (the reference's render_pipeline is out of scope).

`render_plain` is the broadcast chain, as the JAX package computes it
(metadrive_ped_tpu/ops/camera.py, with jnp broadcasts: no TPU kernel). Its
pixel x primitive products ([rows, P, lanes], [rows, P, segments],
[rows, P, boxes] with P = height * width) run in chunks of env rows, each
at most RENDER_CHUNK_ELEMENTS elements per temporary, which bounds the
device memory of a frame of any number of envs. Each chunk's ground hit and
box hits are the tracer's stages `camera.ground` and `camera.boxes`.
`render` computes the same frame: by `render_plain` for CPU tensors, and
for CUDA tensors in one launch of the hand-written kernel in
csrc/camera.cu over every row, or it raises. Both count the pixels and the
(pixel, target slot) pairs of the box test (core/trace.py).
"""
import collections
import ctypes
import functools
import math
import sys

import numpy as np
import torch

from metadrive_ped_torch.constants import (
    LANE_CIRCULAR, SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE,
)
from metadrive_ped_torch.core import cuda_build, launches as launch_counts, trace
from metadrive_ped_torch.mapgen.scene import OBJ_BUILDING
from metadrive_ped_torch.ops import lane_geom
from metadrive_ped_torch.ops.ray_segment import _check

# semantic class ids (palette below follows the reference's Semantics,
# constants.py:372-392)
SEM_SKY = 0
SEM_ROAD = 1
SEM_LANE_LINE = 2
SEM_SIDEWALK = 3
SEM_TERRAIN = 4
SEM_CAR = 5
SEM_PEDESTRIAN = 6
SEM_OBJECT = 7    # cones / warnings / barriers -> TRAFFIC_SIGN
SEM_BUILDING = 8  # toll booth -> FENCE colour
NUM_SEM = 9

SEMANTIC_PALETTE = np.array(
    [
        (70, 130, 180),    # SKY
        (128, 64, 128),    # ROAD
        (255, 255, 255),   # LANE_LINE
        (244, 35, 232),    # SIDEWALK
        (152, 251, 152),   # TERRAIN
        (0, 0, 142),       # CAR
        (220, 20, 60),     # PEDESTRIAN
        (220, 220, 0),     # TRAFFIC_SIGN / objects
        (190, 153, 153),   # FENCE / buildings
    ],
    np.float32,
) / 255.0

FAR = 1e6
RENDER_CHUNK_ELEMENTS = 1 << 28
MODALITIES = ("depth", "semantic", "rgb", "instance")

# launches of the kernel since the last reset (set to 0 to start counting),
# in all and by device index (clear to start counting); this module is the
# counter `core.launches.record` keeps, replays of a captured step included
launches = 0
launches_by_device = collections.Counter()


def _radians(deg):
    """float32 degrees times float32 pi / 180, as jnp.radians rounds it."""
    return np.float32(deg) * np.float32(math.pi / 180)


@functools.lru_cache(maxsize=None)
def _palette(device):
    """SEMANTIC_PALETTE on ``device``, copied there once: a frame copies
    nothing from the host (which would synchronize it)."""
    return torch.as_tensor(SEMANTIC_PALETTE).to(device)


# camera_rays's rays by (width, height, fov, pitch, device)
_kept_rays = {}


def camera_rays(width, height, fov_deg, pitch_deg, device):
    """Camera-frame unit ray directions (dx, dy, dz), each [P] with P =
    height * width in row-major pixel order: +x ahead, +y left, +z up,
    pitched down by ``pitch_deg``; the heading turns them into the world
    (`pixel_rays`). Computed once for each camera and device and kept, as
    `_palette` is, so a frame computes only what the heading turns; rays
    first computed while a CUDA graph is captured are not kept (captured
    work runs only when the graph is replayed)."""
    device = torch.device(device)
    key = (width, height, fov_deg, pitch_deg, device)
    rays = _kept_rays.get(key)
    if rays is None:
        rays = _camera_rays(width, height, fov_deg, pitch_deg, device)
        if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _kept_rays[key] = rays
    return rays


def _camera_rays(width, height, fov_deg, pitch_deg, device):
    # the camera's constants are float32 numbers computed on the host, used
    # exactly by the float32 kernels
    tan_half = float(np.tan(_radians(fov_deg) / np.float32(2)))
    p = _radians(pitch_deg)
    cos_p, sin_p = float(np.cos(p)), float(np.sin(p))
    aspect = height / width
    xs = (torch.arange(width, device=device) + 0.5) / width    # 0..1 across the image
    ys = (torch.arange(height, device=device) + 0.5) / height
    cam_y = (0.5 - xs) * 2 * tan_half                        # +y = left
    cam_z = (0.5 - ys) * 2 * tan_half * aspect               # +z = up
    yy = cam_y[None, :].expand(height, width)
    zz = cam_z[:, None].expand(height, width)
    d0 = torch.ones(height * width, device=device)
    d1, d2 = yy.reshape(-1), zz.reshape(-1)
    # pitch around the camera's y axis (down-tilt positive)
    dx = d0 * cos_p + d2 * sin_p
    dz = -d0 * sin_p + d2 * cos_p
    norm = torch.sqrt(dx * dx + d1 * d1 + dz * dz)
    return dx / norm, d1 / norm, dz / norm



def pixel_rays(heading, width, height, fov_deg, pitch_deg, cam_height):
    """World-frame ray directions [E, P, 3] of an [E] batch of cameras,
    P = height * width in row-major pixel order; +z up."""
    dx, dy, dz = camera_rays(width, height, fov_deg, pitch_deg, heading.device)
    # rotate into the world by the heading
    ch, sh = torch.cos(heading), torch.sin(heading)          # [E]
    wx = ch[:, None] * dx[None, :] - sh[:, None] * dy[None, :]
    wy = sh[:, None] * dx[None, :] + ch[:, None] * dy[None, :]
    return torch.stack([wx, wy, dz[None, :].expand_as(wx)], dim=-1)


def _ground_points(origin_xy, cam_h, dirs):
    """Ray vs the z=0 plane: (t, px, py) [E, P], t = FAR where the ray
    does not descend."""
    dz = dirs[..., 2]
    # a true division (a Python number over a tensor would multiply by the
    # reciprocal, a second rounding)
    t = torch.where(dz < -1e-6, torch.full_like(dz, -cam_h) / dz, FAR)
    px = origin_xy[:, None, 0] + t * dirs[..., 0]
    py = origin_xy[:, None, 1] + t * dirs[..., 1]
    return t, px, py


def _segment_distances(scene, sidx, px, py):
    """Distances [E, P, B] of the points (px, py) [E, P] to every segment of
    their rows' scenarios, one coordinate at a time."""
    s = sidx.long()
    p0, p1 = scene.seg_p0[s][:, None], scene.seg_p1[s][:, None]   # [E, 1, B, 2]
    abx, aby = p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1]
    apx, apy = px[..., None] - p0[..., 0], py[..., None] - p0[..., 1]
    denom = torch.clamp(abx * abx + aby * aby, min=1e-9)
    tt = torch.clamp((apx * abx + apy * aby) / denom, 0.0, 1.0)
    del apx, apy
    ex = px[..., None] - (p0[..., 0] + tt * abx)
    ey = py[..., None] - (p0[..., 1] + tt * aby)
    del tt
    return torch.sqrt(ex * ex + ey * ey)


def _ground_hit(scene, sidx, origin_xy, cam_h, dirs, line_probe_dist):
    """Ray vs the z=0 plane and the semantic class of the hit point:
    (t [E, P], sem [E, P])."""
    t, px, py = _ground_points(origin_xy, cam_h, dirs)
    p = torch.stack([px, py], dim=-1)                        # [E, P, 2]

    # on road: within half a width of some lane's centerline span
    g = lane_geom.gather_all_lanes(scene, sidx)              # fields [E, L(, 2)]
    gb = {k: v[:, None] for k, v in g.items()}               # broadcast over pixels
    long, lat = _lane_local(gb, p)
    on_road = ((long >= 0) & (long <= gb["length"]) & (torch.abs(lat) <= gb["width"] / 2)
               & (gb["length"] > 1e-3)).any(dim=-1)          # [E, P]

    # segment distances (lane lines, sidewalks)
    s = sidx.long()
    seg_type, seg_hw = scene.seg_type[s][:, None], scene.seg_halfwidth[s][:, None]
    seg_valid = scene.seg_valid[s][:, None]
    dseg = _segment_distances(scene, sidx, px, py)           # [E, P, B]
    near = (dseg <= seg_hw + line_probe_dist) & seg_valid
    is_line = (near & ((seg_type == SEG_YELLOW_LINE) | (seg_type == SEG_WHITE_LINE))).any(-1)
    is_walk = (near & (seg_type == SEG_SIDEWALK)).any(-1)

    sem = torch.where(is_walk, SEM_SIDEWALK, torch.where(
        is_line, SEM_LANE_LINE, torch.where(on_road, SEM_ROAD, SEM_TERRAIN)))
    return t, sem


def _lane_local(gb, p):
    """local_coordinates broadcast to [E, P, L]: gb fields [E, 1, L] scalars
    and [E, 1, L, 2] vectors against points p [E, P, 2]."""
    return lane_geom.local_coordinates(gb, p[:, :, None, :])


def _box_hits(origin_xy, cam_h, dirs, t_pos, t_heading, t_len, t_wid, t_hgt, t_active):
    """Nearest hit against heading-aligned 3D boxes: (t [E, P], idx [E, P]).
    idx is the first box whose t is within 1e-6 of the nearest, so two boxes
    at almost the same distance resolve to the lower index."""
    rel = t_pos - origin_xy[:, None, :]                      # [E, T, 2]
    ch, sh = torch.cos(t_heading), torch.sin(t_heading)
    # the camera in each box's frame, relative to the box centre
    ox = -(rel[..., 0] * ch + rel[..., 1] * sh)
    oy = -(-rel[..., 0] * sh + rel[..., 1] * ch)
    dx = dirs[..., None, 0] * ch[:, None] + dirs[..., None, 1] * sh[:, None]
    dy = -dirs[..., None, 0] * sh[:, None] + dirs[..., None, 1] * ch[:, None]
    dz = dirs[..., None, 2]                                  # [E, P, 1]

    def slab(o, d, lo, hi):
        inv = torch.reciprocal(torch.where(torch.abs(d) < 1e-9, 1e-9, d))
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    hx = t_len[:, None] / 2
    hy = t_wid[:, None] / 2
    n1, f1 = slab(ox[:, None], dx, -hx, hx)
    n2, f2 = slab(oy[:, None], dy, -hy, hy)
    n3, f3 = slab(torch.full_like(dz, cam_h), dz, torch.zeros_like(hx), t_hgt[:, None])
    tnear = torch.maximum(torch.maximum(n1, n2), torch.clamp(n3, min=0.0))
    tfar = torch.minimum(torch.minimum(f1, f2), f3)
    hit = (tfar >= tnear) & t_active[:, None]
    tval = torch.where(hit, tnear, FAR)                      # [E, P, T]
    tbest = tval.amin(dim=-1)
    isbest = tval <= tbest[..., None] + 1e-6
    idx = torch.argmax(isbest.to(torch.uint8), dim=-1)       # the first maximum
    return tbest, idx


def render(scene, sidx, ego, targets, slices, obj_kind, *, width=84, height=84,
           fov_deg=66.0, pitch_deg=0.0, cam_height=1.4, max_dist=50.0, modalities=MODALITIES):
    """Render the camera ``modalities`` (by default all four).

    targets (pos, heading, len, wid, active) [E, T, ...] are the env's lidar
    targets (`_lidar_targets`): every visible body; ``slices`` gives the
    target axis's "obj" and "ped" slices; obj_kind [E, O] the static
    objects' kinds. Returns a dict of the modalities asked for, of
    depth [E,H,W,1], semantic [E,H,W,3], rgb [E,H,W,3] and instance
    [E,H,W,3], all float32 in [0, 1].

    CPU tensors take `render_plain`; CUDA tensors launch the kernel once
    for all rows (none when E is 0), on their own device's current stream,
    after torch computes the cos and sin of the headings (the camera's rays
    are kept, `camera_rays`; `_render_kernel`)."""
    unknown = [m for m in modalities if m not in MODALITIES]
    if unknown:
        raise ValueError(f"unknown camera modalities {unknown}; known: {MODALITIES}")
    kw = dict(width=width, height=height, fov_deg=fov_deg, pitch_deg=pitch_deg,
              cam_height=cam_height, max_dist=max_dist, modalities=modalities)
    dev = ego.pos.device
    if dev.type == "cpu":
        return render_plain(scene, sidx, ego, targets, slices, obj_kind, **kw)
    if dev.type != "cuda":
        raise ValueError(f"the camera renders on cpu or cuda, not {dev}")
    return _render_kernel(scene, sidx, ego, targets, slices, obj_kind, **kw)


def render_plain(scene, sidx, ego, targets, slices, obj_kind, *, width=84, height=84,
                 fov_deg=66.0, pitch_deg=0.0, cam_height=1.4, max_dist=50.0,
                 modalities=MODALITIES):
    """Plain torch version of `render`, on any device: the broadcast chain,
    its env rows in chunks (RENDER_CHUNK_ELEMENTS), each chunk computing
    every modality."""
    E = ego.pos.shape[0]
    P = width * height
    widest = max(scene.lane_kind.shape[1], scene.seg_type.shape[1], targets[0].shape[1], 1)
    rows = max(1, RENDER_CHUNK_ELEMENTS // (P * widest))
    parts = []
    for a in range(0, E, rows):
        b = min(E, a + rows)
        parts.append(_render_rows(
            scene, sidx[a:b], ego.pos[a:b], ego.heading[a:b], ego.params.length[a:b],
            [x[a:b] for x in targets], slices, obj_kind[a:b],
            width, height, fov_deg, pitch_deg, cam_height, max_dist))
    if len(parts) == 1:
        return {k: parts[0][k] for k in modalities}
    return {k: torch.cat([p[k] for p in parts]) for k in modalities}


def _render_rows(scene, sidx, pos, heading, length, targets, slices, obj_kind, width, height,
                 fov_deg, pitch_deg, cam_height, max_dist):
    """`render` of the env rows of one chunk: egos at pos [E, 2], heading
    and length [E]."""
    E = pos.shape[0]
    dev = pos.device
    dirs = pixel_rays(heading, width, height, fov_deg, pitch_deg, cam_height)
    # the camera sits over the windshield: a quarter of the length ahead
    fwd = torch.stack([torch.cos(heading), torch.sin(heading)], dim=-1)
    origin_xy = pos + 0.25 * length[:, None] * fwd

    with trace.stage("camera.ground", dev):
        t_ground, ground_sem = _ground_hit(scene, sidx, origin_xy, cam_height, dirs, 0.0)

    t_pos, t_heading, t_len, t_wid, t_active = targets
    # per-target heights and semantic classes by kind slice
    T = t_pos.shape[1]
    t_hgt = torch.full((E, T), 1.5, device=dev)
    t_sem = torch.full((E, T), SEM_CAR, dtype=torch.int64, device=dev)
    is_building = obj_kind == OBJ_BUILDING
    t_hgt[:, slices["obj"]] = torch.where(is_building, 5.0, 1.0)
    t_sem[:, slices["obj"]] = torch.where(is_building, SEM_BUILDING, SEM_OBJECT)
    t_hgt[:, slices["ped"]] = 1.75
    t_sem[:, slices["ped"]] = SEM_PEDESTRIAN

    with trace.stage("camera.boxes", dev):
        t_box, box_idx = _box_hits(origin_xy, cam_height, dirs, t_pos, t_heading, t_len, t_wid,
                                   t_hgt, t_active)
    if trace.enabled:
        P = width * height
        trace.count("camera.pixels", E * P, dev)
        trace.count("camera.boxes_live", t_active.sum() * P, dev)
        trace.count("camera.boxes_computed", E * T * P, dev)

    box_wins = t_box < t_ground
    t_hit = torch.where(box_wins, t_box, t_ground)
    hit = t_hit < FAR / 2
    sem = torch.where(box_wins, torch.gather(t_sem, 1, box_idx), ground_sem)
    sem = torch.where(hit, sem, SEM_SKY)

    H, W = height, width
    depth_img = torch.clamp(t_hit / max_dist, 0.0, 1.0).reshape(E, H, W, 1)
    color = _palette(dev)[sem]                               # [E, P, 3]
    # flat shading: the semantic colour attenuated by distance; sky unshaded
    shade = torch.where(hit, 1.0 / (1.0 + 0.02 * t_hit), 1.0)
    rgb_img = (color * shade[..., None]).reshape(E, H, W, 3)

    # instance: a colour per target slot (the id -> colour registry,
    # base_engine.py:160-208); background black
    ids = torch.arange(T, device=dev)
    inst_colors = torch.stack([((ids * 37 + 13) % 255) / 255.0, ((ids * 91 + 71) % 255) / 255.0,
                               ((ids * 53 + 29) % 255) / 255.0], dim=-1)   # [T, 3]
    inst = inst_colors[box_idx] * (box_wins & hit)[..., None]
    return dict(depth=depth_img, semantic=color.reshape(E, H, W, 3), rgb=rgb_img,
                instance=inst.reshape(E, H, W, 3))


# ---- the kernel (csrc/camera.cu) ------------------------------------------

_POINTERS = ("sidx", "pos", "cos_h", "sin_h", "length", "ray_x", "ray_y", "ray_z",
             "lane_kind", "lane_p0", "lane_dir", "lane_radius", "lane_start_phase",
             "lane_arc_dir", "lane_width", "lane_length", "lane_angle",
             "seg_p0", "seg_p1", "seg_type", "seg_halfwidth", "seg_valid",
             "t_pos", "t_cos", "t_sin", "t_len", "t_wid", "t_active", "obj_kind", "palette",
             "depth", "semantic", "rgb", "instance", "box_tests")
_INTS = ("E", "P", "S", "L", "B", "T", "O", "obj0", "ped0", "ped1",
         "lane_circular", "seg_sidewalk", "seg_yellow", "seg_white", "obj_building")
_FLOATS = ("cam_h", "line_probe", "inv_max_dist")
_MAX_PIXELS = 65535 * 256  # the grid's pixel tiles (csrc/camera.cu's kThreads)


class _Args(ctypes.Structure):
    """csrc/camera.cu's CameraArgs, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS] + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


def _kernel_lib():
    fn = cuda_build.library("camera").camera_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _operand(name, t, device, dtype, shape):
    """``t`` made contiguous, checked for device, dtype and shape."""
    t = t.contiguous()
    _check(name, t, device, dtype, shape)
    return t


def _kind_range(name, sl, T, size=None):
    """(start, stop) of the target slice ``sl`` on a T-long axis, which must
    step by one (and hold ``size`` slots where given)."""
    r = range(T)[sl]
    if r.step != 1 or (size is not None and len(r) != size):
        raise ValueError(f"the {name} slice {sl} must step by 1 over {size} of {T} targets")
    return r.start, r.stop


def _render_kernel(scene, sidx, ego, targets, slices, obj_kind, *, width, height, fov_deg,
                   pitch_deg, cam_height, max_dist, modalities):
    """`render` on a CUDA device: one launch of csrc/camera.cu. Every input
    must lie on ego.pos's device; sidx and obj_kind are int32, the bool
    masks bool, the rest float32. A row whose sidx lies outside [0, S)
    reads NaN."""
    dev = ego.pos.device
    E = ego.pos.shape[0]
    W, H = int(width), int(height)
    P = W * H
    if not (1 <= P <= _MAX_PIXELS and E < 2 ** 31):
        raise ValueError(f"need 1 <= width * height <= {_MAX_PIXELS} and fewer than 2**31 "
                         f"rows; got {W} x {H} and {E} rows")
    if not max_dist > 0:
        raise ValueError(f"max_dist must be positive, not {max_dist}")
    f32 = torch.float32
    S, L = scene.lane_kind.shape
    B = scene.seg_type.shape[1]
    T = targets[0].shape[1]
    O = obj_kind.shape[1]
    ops = dict(
        sidx=_operand("sidx", sidx, dev, torch.int32, (E,)),
        pos=_operand("ego.pos", ego.pos, dev, f32, (E, 2)),
        length=_operand("ego length", ego.params.length, dev, f32, (E,)),
        lane_kind=_operand("lane_kind", scene.lane_kind, dev, torch.int32, (S, L)),
        lane_p0=_operand("lane_p0", scene.lane_p0, dev, f32, (S, L, 2)),
        lane_dir=_operand("lane_dir", scene.lane_dir, dev, f32, (S, L, 2)),
        **{k: _operand(k, getattr(scene, k), dev, f32, (S, L))
           for k in ("lane_radius", "lane_start_phase", "lane_arc_dir", "lane_width",
                     "lane_length", "lane_angle")},
        seg_p0=_operand("seg_p0", scene.seg_p0, dev, f32, (S, B, 2)),
        seg_p1=_operand("seg_p1", scene.seg_p1, dev, f32, (S, B, 2)),
        seg_type=_operand("seg_type", scene.seg_type, dev, torch.int32, (S, B)),
        seg_halfwidth=_operand("seg_halfwidth", scene.seg_halfwidth, dev, f32, (S, B)),
        seg_valid=_operand("seg_valid", scene.seg_valid, dev, torch.bool, (S, B)),
        t_pos=_operand("target pos", targets[0], dev, f32, (E, T, 2)),
        t_len=_operand("target len", targets[2], dev, f32, (E, T)),
        t_wid=_operand("target wid", targets[3], dev, f32, (E, T)),
        t_active=_operand("target active", targets[4], dev, torch.bool, (E, T)),
        obj_kind=_operand("obj_kind", obj_kind, dev, torch.int32, (E, O)),
    )
    heading = _operand("ego.heading", ego.heading, dev, f32, (E,))
    t_heading = _operand("target heading", targets[1], dev, f32, (E, T))
    obj0, _ = _kind_range("obj", slices["obj"], T, O)
    ped0, ped1 = _kind_range("ped", slices["ped"], T)
    out = {m: torch.empty((E, H, W, 1 if m == "depth" else 3), dtype=f32, device=dev)
           for m in modalities}
    if E == 0:
        return out
    ops["cos_h"], ops["sin_h"] = torch.cos(heading), torch.sin(heading)
    ops["t_cos"], ops["t_sin"] = torch.cos(t_heading), torch.sin(t_heading)
    ops["ray_x"], ops["ray_y"], ops["ray_z"] = camera_rays(W, H, fov_deg, pitch_deg, dev)
    ops["palette"] = _palette(dev)
    ptrs = {k: t.data_ptr() for k, t in ops.items()}
    ptrs.update({m: (out[m].data_ptr() if m in out else None) for m in MODALITIES})
    # the (pixel, slot) pairs the box tests compute, counted by the kernel
    # while tracing is on
    tests = torch.zeros((), dtype=torch.int64, device=dev) if trace.enabled else None
    ptrs["box_tests"] = None if tests is None else tests.data_ptr()
    args = _Args(**ptrs, E=E, P=P, S=S, L=L, B=B, T=T, O=O, obj0=obj0, ped0=ped0, ped1=ped1,
                 lane_circular=LANE_CIRCULAR, seg_sidewalk=SEG_SIDEWALK,
                 seg_yellow=SEG_YELLOW_LINE, seg_white=SEG_WHITE_LINE,
                 obj_building=OBJ_BUILDING, cam_h=cam_height, line_probe=0.0,
                 inv_max_dist=float(np.float32(1) / np.float32(max_dist)))
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"camera kernel launch failed: cudaError {err}")
    launch_counts.record(sys.modules[__name__], dev.index)
    if tests is not None:
        trace.count("camera.pixels", E * P, dev)
        trace.count("camera.boxes_live", ops["t_active"].sum() * P, dev)
        trace.count("camera.boxes_computed", tests, dev)
    return out
