"""Float64 checks of the pixels that two renderings of one state may
disagree on: the JAX package against the port (tests/test_torch_top_down.py,
test_torch_camera.py) and the card against the CPU (chip_smoke.py).

Both sides compute in float32 with the same order of operations, but a
transcendental (cos, sin, atan2) may round an ulp apart on another library
or device. A pixel may then differ only where that rounding can decide it:
a stamped pixel on a box edge, a sampled pixel whose texture coordinate
rounds apart, a camera pixel whose deciding distance lies at its
threshold. Each check below counts such pixels, raises AssertionError
unless every difference is of that kind (in float64), and returns the
count. Frames and states come as numpy arrays (`core.convert.state_to_numpy`
trees), except in `camera_margins`, which takes the env and its state.
"""
import math

import numpy as np
import torch

from metadrive_ped_torch.constants import SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE
from metadrive_ped_torch.mapgen.scene import OBJ_BUILDING
from metadrive_ped_torch.obs.top_down import BAKE_RES
from metadrive_ped_torch.ops import lane_geom

EDGE_TOL = 1e-5    # m: a box edge or a deciding distance this near may flip
SAMPLE_TOL = 1e-5


def _box_frame(fwd, side, ego, pos, heading, length, width, active):
    """Float64 box-frame coordinates of every pixel (grid fwd [H], side [W])
    against every body: |lx| - L/2 and |ly| - W/2 [E, H, W, N], and the
    body mask."""
    f = lambda x: np.asarray(x, np.float64)
    eh = f(ego["heading"])
    hv = np.stack([np.cos(eh), np.sin(eh)], -1)
    rv = np.stack([hv[:, 1], -hv[:, 0]], -1)
    rel = f(pos) - f(ego["pos"])[:, None]
    rx, ry = (rel * hv[:, None]).sum(-1), (rel * rv[:, None]).sum(-1)
    rel_h = f(heading) - eh[:, None]
    c, s = np.cos(rel_h), np.sin(rel_h)
    dxp = f(fwd)[None, :, None, None] - rx[:, None, None, :]
    dyp = f(side)[None, None, :, None] - ry[:, None, None, :]
    lx = dxp * c[:, None, None] + dyp * s[:, None, None]
    ly = -dxp * s[:, None, None] + dyp * c[:, None, None]
    return (np.abs(lx) - f(length)[:, None, None] / 2, np.abs(ly) - f(width)[:, None, None] / 2,
            np.asarray(active, bool)[:, None, None])


def stamp_mismatches(a, b, fwd, side, ego, bodies):
    """Pixels where stamped layers a and b [E, H, W] differ; each must lie
    within EDGE_TOL m of an active body's edge (and inside the other axis's
    extent to within EDGE_TOL). Returns the count."""
    bad = a != b
    if not bad.any():
        return 0
    qx, qy, active = _box_frame(fwd, side, ego, *bodies)
    near_x = (np.abs(qx) < EDGE_TOL) & (qy < EDGE_TOL)
    near_y = (np.abs(qy) < EDGE_TOL) & (qx < EDGE_TOL)
    edge = ((near_x | near_y) & active).any(-1)
    if not edge[bad].all():
        raise AssertionError(f"{int((bad & ~edge).sum())} stamped pixels differ away from an edge")
    return int(bad.sum())


def _bodies(tree, kind):
    ego, npc = tree["ego"], tree["npc"]
    E = ego["pos"].shape[0]
    if kind == "npc":
        return npc["pos"], npc["heading"], npc["params"]["length"], npc["params"]["width"], \
            npc["active"]
    if kind == "ego":
        return ego["pos"][:, None], ego["heading"][:, None], ego["params"]["length"][:, None], \
            ego["params"]["width"][:, None], np.ones((E, 1), bool)
    K = ego["past_pos"].shape[1]
    return ego["past_pos"], np.zeros((E, K)), np.ones((E, K)), np.ones((E, K)), \
        np.ones((E, K), bool)


def grid(rows, cols, max_distance, look_ahead=0.0):
    """The float32 pixel axes of `top_down._pixel_axes` (fwd [rows], side
    [cols]) on the host."""
    res = np.float32(2 * max_distance / rows)
    fwd = (rows / 2 - np.arange(rows, dtype=np.float32)) * res + np.float32(look_ahead)
    side = (np.arange(cols, dtype=np.float32) - cols / 2) * res
    return fwd, side


def sampled_mismatches(a, b, layers, tree, textures, origins, fwd, side):
    """Pixels where sampled layers a and b [E, H, W] differ by more than
    SAMPLE_TOL. Both packages compute a pixel's texture coordinate in
    float32 from the ego pose (cos and sin of the heading may round apart
    by an ulp); each such pixel must be explained by that: the difference
    is at most SAMPLE_TOL plus the steepest texel step around the pixel
    (its 4 x 4 neighbourhood in the texture ``layers`` it reads) times 8
    float32 ulps of the pixel's world coordinate (in texels) and of its
    texture coordinate. Returns the count."""
    bad = np.abs(a - b) > SAMPLE_TOL
    if not bad.any():
        return 0
    ego = tree["ego"]
    h = ego["heading"].astype(np.float64)
    hv = np.stack([np.cos(h), np.sin(h)], -1)
    rv = np.stack([hv[:, 1], -hv[:, 0]], -1)
    world = (ego["pos"].astype(np.float64)[:, None, None]
             + fwd.astype(np.float64)[None, :, None, None] * hv[:, None, None]
             + side.astype(np.float64)[None, None, :, None] * rv[:, None, None])
    sidx = tree["sidx"].astype(np.int64)
    coord = (world - origins[sidx][:, None, None]) / BAKE_RES
    Ht, Wt = textures.shape[2:]
    step = np.zeros(a.shape)
    for e, y, x in zip(*np.nonzero(bad)):
        x0, y0 = int(np.floor(coord[e, y, x, 0])), int(np.floor(coord[e, y, x, 1]))
        ys = np.clip(np.arange(y0 - 1, y0 + 3), 0, Ht - 1)
        xs = np.clip(np.arange(x0 - 1, x0 + 3), 0, Wt - 1)
        patch = textures[sidx[e]][list(layers)][:, ys][:, :, xs]
        step[e, y, x] = patch.max() - patch.min()
    ulp = lambda x: np.spacing(np.abs(x).max(-1).astype(np.float32))
    slack = 8 * (ulp(world) / BAKE_RES + ulp(coord))
    allowed = SAMPLE_TOL + step * slack
    if not (np.abs(a - b)[bad] <= allowed[bad]).all():
        raise AssertionError("a sampled pixel differs beyond rounding")
    return int(bad.sum())


# channel -> texture layers read (sampled) or bodies stamped, per frame kind
LAYOUTS = {
    "top_down": ({0: (0, 1), 1: (2,)}, {2: ("npc",), 3: ("ego",), 4: ("past",)}),
    "mini_map": ({0: (0, 1), 2: (2,)}, {1: ("npc", "ego")}),
}


def check_frame(a, b, kind, tree, textures, origins, fwd, side):
    """Reference frame a against b [E, H, W, C], a top-down or mini-map
    frame (``kind``) of the state ``tree``: sampled channels by
    `sampled_mismatches`, stamped ones by `stamp_mismatches`; returns the
    pixels counted."""
    if a.shape != b.shape or b.dtype != np.float32:
        raise AssertionError(f"frames {a.shape} and {b.shape} {b.dtype} differ in kind")
    sampled, stamped = LAYOUTS[kind]
    counted = sum(sampled_mismatches(a[..., ch], b[..., ch], layers, tree, textures, origins,
                                     fwd, side) for ch, layers in sampled.items())
    for ch, kinds in stamped.items():
        bodies = [np.concatenate(x, axis=1) for x in zip(*(_bodies(tree, k) for k in kinds))]
        counted += stamp_mismatches(a[..., ch], b[..., ch], fwd, side, tree["ego"], bodies)
    return counted


def camera_margins(env, state, width, height):
    """For each pixel [E, H * W] of the env's camera (``env.config`` camera,
    the port's state), the smallest distance in metres, in float64, between
    a quantity that decides the pixel's class and its threshold: the
    boundary of a lane's region (long in [0, length], |lat| <= width / 2),
    a line or sidewalk segment's distance against its half width, a box's
    slab entry against its exit (its silhouette), the nearest box's t
    against the ground's and against the second nearest box's (the 1e-6
    first-index rule)."""
    cam = env.config["camera"]
    f = lambda t: t.detach().cpu().double()
    heading, pos, length = f(state.ego.heading), f(state.ego.pos), f(state.ego.params.length)
    tan_half = math.tan(math.radians(cam["fov"]) / 2)
    xs = (torch.arange(width, dtype=torch.float64) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float64) + 0.5) / height
    cam_y = ((0.5 - xs) * 2 * tan_half)[None, :].expand(height, width).reshape(-1)
    cam_z = ((0.5 - ys) * 2 * tan_half * height / width)[:, None].expand(height, width).reshape(-1)
    p = math.radians(cam["pitch"])
    dx, dz = math.cos(p) + cam_z * math.sin(p), -math.sin(p) + cam_z * math.cos(p)
    norm = torch.sqrt(dx * dx + cam_y * cam_y + dz * dz)
    dx, dy, dz = dx / norm, cam_y / norm, dz / norm
    ch, sh = torch.cos(heading)[:, None], torch.sin(heading)[:, None]
    wx, wy = ch * dx - sh * dy, sh * dx + ch * dy                  # [E, P]
    wz = dz.expand_as(wx)
    origin = pos + 0.25 * length[:, None] * torch.stack([ch[:, 0], sh[:, 0]], -1)
    FAR, h = 1e6, cam["height"]
    t_ground = torch.where(wz < -1e-6, -h / wz, FAR)
    px, py = origin[:, None, 0] + t_ground * wx, origin[:, None, 1] + t_ground * wy

    g = {k: (f(v) if v.is_floating_point() else v)[:, None]
         for k, v in lane_geom.gather_all_lanes(env.scene, state.sidx).items()}
    long, lat = lane_geom.local_coordinates(g, torch.stack([px, py], -1)[:, :, None, :])
    q0 = torch.maximum(-long, long - g["length"])
    q1 = torch.abs(lat) - g["width"] / 2
    sd = (torch.hypot(q0.clamp(min=0), q1.clamp(min=0)) + torch.maximum(q0, q1).clamp(max=0))
    lane_m = torch.where(g["length"] > 1e-3, sd.abs(), math.inf).amin(-1)

    s = state.sidx.long()
    p0, p1 = f(env.scene.seg_p0[s])[:, None], f(env.scene.seg_p1[s])[:, None]
    ab = p1 - p0
    ap = torch.stack([px, py], -1)[:, :, None, :] - p0
    tt = ((ap * ab).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-9)).clamp(0, 1)
    dseg = torch.linalg.norm(ap - tt[..., None] * ab, dim=-1)
    st = env.scene.seg_type[s][:, None]
    used = env.scene.seg_valid[s][:, None] & (
        (st == SEG_YELLOW_LINE) | (st == SEG_WHITE_LINE) | (st == SEG_SIDEWALK))
    seg_m = torch.where(used, (dseg - f(env.scene.seg_halfwidth[s])[:, None]).abs(),
                        math.inf).amin(-1)

    (t_pos, t_heading, t_len, t_wid, t_active), _ = env._lidar_targets(state)
    t_pos, t_heading, t_len, t_wid = map(f, (t_pos, t_heading, t_len, t_wid))
    t_hgt = torch.full_like(t_len, 1.5)
    building = env.scene.obj_kind[s] == OBJ_BUILDING
    t_hgt[:, env._target_slices["obj"]] = torch.where(building, 5.0, 1.0).double()
    t_hgt[:, env._target_slices["ped"]] = 1.75
    rel = t_pos - origin[:, None]
    bc, bs = torch.cos(t_heading), torch.sin(t_heading)
    ox = -(rel[..., 0] * bc + rel[..., 1] * bs)
    oy = -(-rel[..., 0] * bs + rel[..., 1] * bc)
    bdx = wx[..., None] * bc[:, None] + wy[..., None] * bs[:, None]
    bdy = -wx[..., None] * bs[:, None] + wy[..., None] * bc[:, None]
    bdz = wz[..., None].expand_as(bdx)

    def slab(o, d, lo, hi):
        d = torch.where(d.abs() < 1e-12, 1e-12, d)
        t1, t2 = (lo - o) / d, (hi - o) / d
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    n1, f1 = slab(ox[:, None], bdx, -t_len[:, None] / 2, t_len[:, None] / 2)
    n2, f2 = slab(oy[:, None], bdy, -t_wid[:, None] / 2, t_wid[:, None] / 2)
    n3, f3 = slab(torch.full_like(bdz, h), bdz, torch.zeros_like(t_hgt)[:, None], t_hgt[:, None])
    tnear = torch.maximum(torch.maximum(n1, n2), n3.clamp(min=0))
    tfar = torch.minimum(torch.minimum(f1, f2), f3)
    active = t_active[:, None]
    slab_m = torch.where(active, (tfar - tnear).abs(), math.inf).amin(-1)
    tval = torch.where((tfar >= tnear) & active, tnear, FAR).sort(-1).values
    best = tval[..., 0]
    tie_m = ((tval[..., 1] - best - 1e-6).abs() if tval.shape[-1] > 1
             else torch.full_like(best, math.inf))
    bg_m = torch.where(best < FAR / 2, (best - t_ground).abs(), math.inf)
    return torch.stack([lane_m, seg_m, slab_m, tie_m, bg_m]).amin(0).numpy()


def camera_mismatches(a, b, margins, tol):
    """Pixels [E, P] where camera frames a and b [E, H, W, C] differ by more
    than ``tol``; each must have a deciding distance within EDGE_TOL of its
    threshold (``margins``, from `camera_margins`). Returns the count."""
    E, H, W, C = a.shape
    bad = (np.abs(a.astype(np.float64) - b) > tol).reshape(E, H * W, C).any(-1)
    if not (margins[bad] < EDGE_TOL).all():
        raise AssertionError(
            f"{int((bad & (margins >= EDGE_TOL)).sum())} pixels differ away from any threshold")
    return int(bad.sum())
