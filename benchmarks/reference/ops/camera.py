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

The pixel x primitive products ([rows, P, lanes], [rows, P, segments],
[rows, P, boxes] with P = height * width) run in chunks of env rows, each
at most RENDER_CHUNK_ELEMENTS elements per temporary, which bounds the
device memory of a frame of any number of envs.
"""
import functools
import math

import numpy as np
import torch

from benchmarks.reference.constants import SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE
from benchmarks.reference.mapgen.scene import OBJ_BUILDING
from benchmarks.reference.ops import lane_geom

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


def _radians(deg):
    """float32 degrees times float32 pi / 180, as jnp.radians rounds it."""
    return np.float32(deg) * np.float32(math.pi / 180)


@functools.lru_cache(maxsize=None)
def _palette(device):
    """SEMANTIC_PALETTE on ``device``, copied there once: a frame copies
    nothing from the host (which would synchronize it)."""
    return torch.as_tensor(SEMANTIC_PALETTE).to(device)


def pixel_rays(heading, width, height, fov_deg, pitch_deg, cam_height):
    """World-frame ray directions [E, P, 3] of an [E] batch of cameras,
    P = height * width in row-major pixel order; +z up."""
    dev = heading.device
    # the camera's constants are float32 numbers computed on the host, used
    # exactly by the float32 kernels
    tan_half = float(np.tan(_radians(fov_deg) / np.float32(2)))
    p = _radians(pitch_deg)
    cos_p, sin_p = float(np.cos(p)), float(np.sin(p))
    aspect = height / width
    xs = (torch.arange(width, device=dev) + 0.5) / width    # 0..1 across the image
    ys = (torch.arange(height, device=dev) + 0.5) / height
    cam_y = (0.5 - xs) * 2 * tan_half                        # +y = left
    cam_z = (0.5 - ys) * 2 * tan_half * aspect               # +z = up
    yy = cam_y[None, :].expand(height, width)
    zz = cam_z[:, None].expand(height, width)
    d0 = torch.ones(height * width, device=dev)
    d1, d2 = yy.reshape(-1), zz.reshape(-1)
    # pitch around the camera's y axis (down-tilt positive)
    dx = d0 * cos_p + d2 * sin_p
    dz = -d0 * sin_p + d2 * cos_p
    norm = torch.sqrt(dx * dx + d1 * d1 + dz * dz)
    dx, dy, dz = dx / norm, d1 / norm, dz / norm
    # rotate into the world by the heading
    ch, sh = torch.cos(heading), torch.sin(heading)          # [E]
    wx = ch[:, None] * dx[None, :] - sh[:, None] * dy[None, :]
    wy = sh[:, None] * dx[None, :] + ch[:, None] * dy[None, :]
    return torch.stack([wx, wy, dz[None, :].expand_as(wx)], dim=-1)


def _ground_hit(scene, sidx, origin_xy, cam_h, dirs, line_probe_dist):
    """Ray vs the z=0 plane and the semantic class of the hit point:
    (t [E, P], sem [E, P])."""
    dz = dirs[..., 2]
    # a true division (a Python number over a tensor would multiply by the
    # reciprocal, a second rounding)
    t = torch.where(dz < -1e-6, torch.full_like(dz, -cam_h) / dz, FAR)
    px = origin_xy[:, None, 0] + t * dirs[..., 0]
    py = origin_xy[:, None, 1] + t * dirs[..., 1]
    p = torch.stack([px, py], dim=-1)                        # [E, P, 2]

    # on road: within half a width of some lane's centerline span
    g = lane_geom.gather_all_lanes(scene, sidx)              # fields [E, L(, 2)]
    gb = {k: v[:, None] for k, v in g.items()}               # broadcast over pixels
    long, lat = _lane_local(gb, p)
    on_road = ((long >= 0) & (long <= gb["length"]) & (torch.abs(lat) <= gb["width"] / 2)
               & (gb["length"] > 1e-3)).any(dim=-1)          # [E, P]

    # segment distances (lane lines, sidewalks), one coordinate at a time
    s = sidx.long()
    p0, p1 = scene.seg_p0[s][:, None], scene.seg_p1[s][:, None]   # [E, 1, B, 2]
    seg_type, seg_hw = scene.seg_type[s][:, None], scene.seg_halfwidth[s][:, None]
    seg_valid = scene.seg_valid[s][:, None]
    abx, aby = p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1]
    apx, apy = px[..., None] - p0[..., 0], py[..., None] - p0[..., 1]
    denom = torch.clamp(abx * abx + aby * aby, min=1e-9)
    tt = torch.clamp((apx * abx + apy * aby) / denom, 0.0, 1.0)
    del apx, apy
    ex = px[..., None] - (p0[..., 0] + tt * abx)
    ey = py[..., None] - (p0[..., 1] + tt * aby)
    del tt
    dseg = torch.sqrt(ex * ex + ey * ey)                     # [E, P, B]
    del ex, ey
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
           fov_deg=66.0, pitch_deg=0.0, cam_height=1.4, max_dist=50.0):
    """Render all camera modalities at once.

    targets (pos, heading, len, wid, active) [E, T, ...] are the env's lidar
    targets (`_lidar_targets`): every visible body; ``slices`` gives the
    target axis's "obj" and "ped" slices; obj_kind [E, O] the static
    objects' kinds. Returns dict(depth [E,H,W,1], semantic [E,H,W,3],
    rgb [E,H,W,3], instance [E,H,W,3]), all float32 in [0, 1]. The env rows
    run in chunks (RENDER_CHUNK_ELEMENTS).
    """
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
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


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

    t_box, box_idx = _box_hits(origin_xy, cam_height, dirs, t_pos, t_heading, t_len, t_wid,
                               t_hgt, t_active)

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
