"""Top-down (BEV) observation.

Counterpart of the reference's pygame rasterized observation
(obs/top_down_obs.py:22 TopDownObservation, 84x84;
obs/top_down_obs_multi_channel.py:27 TopDownMultiChannel). Static map layers
(drivable area, lane lines, ego route) are baked per scenario when the env
is built, by the host rasterizer (native/td_raster.cpp), and kept on the
device. Each step samples the ego-centric window bilinearly from them and
stamps the dynamic layers (ego box, other vehicles, past ego positions)
with batched point-in-OBB tests.

Channels (mirroring the multi-channel layout):
  0 road network   1 ego route   2 other vehicles   3 ego box
  4 past ego positions
"""
import numpy as np
import torch

from metadrive_ped_torch.constants import LANE_CIRCULAR

CHANNELS = 5
BAKE_RES = 0.5  # m / texture pixel
# the largest [rows, H, W, bodies] temporary of a stamp, in elements; the
# env rows are stamped in chunks that stay under it
STAMP_CHUNK_ELEMENTS = 1 << 26


def bake_map_textures(scene_pack, num_scenarios, device):
    """Host-side bake of every scenario's static layers, returned on
    ``device``: textures [S, 3, H, W] float32 (0 drivable area, 1 continuous
    lane lines, 2 slot-0 route) and their world origins [S, 2]."""
    from metadrive_ped_torch.native import rasterize_polylines

    textures, origins = [], []
    for s in range(num_scenarios):
        valid = np.asarray(scene_pack["lane_valid"][s])
        lane_polys, widths = [], []
        for lid in np.nonzero(valid)[0]:
            lane_polys.append(_lane_centerline(scene_pack, s, lid))
            widths.append(float(scene_pack["lane_width"][s][lid]))
        allpts = np.concatenate(lane_polys) if lane_polys else np.zeros((1, 2))
        lo = allpts.min(axis=0) - 12.0
        hi = allpts.max(axis=0) + 12.0
        H = int(np.ceil((hi[1] - lo[1]) / BAKE_RES))
        W = int(np.ceil((hi[0] - lo[0]) / BAKE_RES))
        tex = np.zeros((3, H, W), np.float32)
        rasterize_polylines(tex[0], lo, BAKE_RES, lane_polys, widths)
        # continuous lines (yellow, white, sidewalk) from the segment arrays
        segs = [np.stack([scene_pack["seg_p0"][s][b], scene_pack["seg_p1"][s][b]])
                for b in range(len(scene_pack["seg_valid"][s]))
                if scene_pack["seg_valid"][s][b] and scene_pack["seg_type"][s][b] <= 2]
        rasterize_polylines(tex[1], lo, BAKE_RES, segs, [0.6] * len(segs))
        # route of spawn slot 0
        route_polys, route_widths = [], []
        for rid in scene_pack["route_roads"][s][0][: scene_pack["route_len"][s][0]]:
            lane0 = int(scene_pack["road_lane0"][s][rid])
            for lid in range(lane0, lane0 + int(scene_pack["road_nlanes"][s][rid])):
                route_polys.append(_lane_centerline(scene_pack, s, lid))
                route_widths.append(float(scene_pack["lane_width"][s][lid]))
        rasterize_polylines(tex[2], lo, BAKE_RES, route_polys, route_widths)
        textures.append(tex)
        origins.append(lo)

    Hm = max(t.shape[1] for t in textures)
    Wm = max(t.shape[2] for t in textures)
    out = np.zeros((num_scenarios, 3, Hm, Wm), np.float32)
    for s, t in enumerate(textures):
        out[s, :, : t.shape[1], : t.shape[2]] = t
    return (torch.from_numpy(out).to(device),
            torch.from_numpy(np.asarray(origins, np.float32)).to(device))


def _lane_centerline(pack, s, lid, step=3.0):
    """Polyline of lane ``lid`` of scenario ``s`` from its closed form: an
    arc sampled about every ``step`` m, or a straight lane's two ends."""
    if pack["lane_kind"][s][lid] == LANE_CIRCULAR:
        c = np.asarray(pack["lane_p0"][s][lid])
        r = float(pack["lane_radius"][s][lid])
        phi0 = float(pack["lane_start_phase"][s][lid])
        d = float(pack["lane_arc_dir"][s][lid])
        length = float(pack["lane_length"][s][lid])
        n = max(2, int(length / step))
        longs = np.linspace(0, length, n)
        phis = d * longs / r + phi0
        return (c[None] + r * np.stack([np.cos(phis), np.sin(phis)], -1)).astype(np.float32)
    p0 = np.asarray(pack["lane_p0"][s][lid])
    dirv = np.asarray(pack["lane_dir"][s][lid])
    length = float(pack["lane_length"][s][lid])
    return np.stack([p0, p0 + dirv * length]).astype(np.float32)


def _ego_grid(ego, fwd, side):
    """The ego frame of a pixel grid: (fwd_g, side_g) [H, W] distances ahead
    and to the right of the ego, the heading and right vectors hv, rv
    [E, 2], and the world point of every pixel [E, H, W, 2]."""
    fwd_g = fwd[:, None].expand(fwd.shape[0], side.shape[0])
    side_g = side[None, :].expand(fwd.shape[0], side.shape[0])
    hv = torch.stack([torch.cos(ego.heading), torch.sin(ego.heading)], -1)
    rv = torch.stack([hv[:, 1], -hv[:, 0]], -1)
    world = (ego.pos[:, None, None, :] + fwd_g[None, ..., None] * hv[:, None, None, :]
             + side_g[None, ..., None] * rv[:, None, None, :])
    return fwd_g, side_g, hv, rv, world


def _sampler(textures, origins, sidx, world):
    """sample(ch) -> [E, H, W]: channel ``ch`` of each env's texture at the
    world points ``world`` [E, H, W, 2], bilinear with zeros outside the
    texture. This is scipy's map_coordinates(order=1, mode="constant") over
    (scenario, y, x): per axis the floor and its successor with weights
    1 - f and f, a corner outside the array counting as 0; the scenario
    coordinate is an integer, so only its own texture weighs. The four
    corners are summed in map_coordinates' order."""
    S, C, H, W = textures.shape
    s = sidx.long()
    tex_xy = (world - origins[s][:, None, None, :]) / BAKE_RES
    ty, tx = tex_xy[..., 1], tex_xy[..., 0]
    y0f, x0f = torch.floor(ty), torch.floor(tx)
    wy1, wx1 = ty - y0f, tx - x0f
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0f.to(torch.int32), x0f.to(torch.int32)
    flat = textures.reshape(-1)
    base = (s * C)[:, None, None]
    corners = []
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            pix = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
            corners.append((wy * wx, valid, pix))

    def sample(ch):
        out = None
        for w, valid, pix in corners:
            v = torch.where(valid, flat[(base + ch) * (H * W) + pix], 0.0)
            out = w * v if out is None else out + w * v
        return out
    return sample


def _stamp_obbs(fwd_g, side_g, hv, rv, ego, pos, heading, length, wid, active):
    """Rasterize rotated boxes into the ego-frame pixel grid (fwd_g / side_g
    [H, W]): the occupancy layer [E, H, W] of the bodies (pos [E, N, 2],
    heading, length, wid, active [E, N]). The [rows, H, W, N] box-frame
    coordinates are built in chunks of env rows of at most
    STAMP_CHUNK_ELEMENTS elements each."""
    rel = pos - ego.pos[:, None, :]                       # [E, N, 2]
    rx = (rel * hv[:, None, :]).sum(-1)
    ry = (rel * rv[:, None, :]).sum(-1)
    rel_h = heading - ego.heading[:, None]
    c, s = torch.cos(rel_h), torch.sin(rel_h)
    # each pixel's offset from each body centre is fwd - rx ahead and
    # side - ry to the right: the [E, H, W, N] products separate into
    # [E, H, 1, N] and [E, 1, W, N] factors with the same rounding
    fwd, side = fwd_g[:, 0], side_g[0]
    E, N = rx.shape
    H, W = fwd.shape[0], side.shape[0]
    rows = max(1, STAMP_CHUNK_ELEMENTS // max(1, H * W * N))
    out = []
    for a in range(0, E, rows):
        b = min(E, a + rows)
        dxp = fwd[None, :, None, None] - rx[a:b, None, None, :]     # [C, H, 1, N]
        dyp = side[None, None, :, None] - ry[a:b, None, None, :]    # [C, 1, W, N]
        cc, ss = c[a:b, None, None, :], s[a:b, None, None, :]
        lx = dxp * cc + dyp * ss
        ly = -dxp * ss + dyp * cc
        inside = ((torch.abs(lx) <= length[a:b, None, None, :] / 2)
                  & (torch.abs(ly) <= wid[a:b, None, None, :] / 2)
                  & active[a:b, None, None, :])
        out.append(inside.any(-1).float())
    return torch.cat(out) if len(out) > 1 else out[0]


def _pixel_axes(rows, cols, res, device, look_ahead=0.0):
    """Distances ahead (row 0 furthest) and to the right of the ego of a
    rows x cols grid at ``res`` m / pixel."""
    fwd = (rows / 2 - torch.arange(rows, device=device)) * res + look_ahead
    side = (torch.arange(cols, device=device) - cols / 2) * res
    return fwd, side


def observe_top_down(textures, origins, sidx, ego, npc, past_pos,
                     resolution=84, max_distance=50.0):
    """[E, resolution, resolution, 5] ego-centric BEV, heading pointing up
    (+row towards the front, matching the reference's rotated frame)."""
    E, R = sidx.shape[0], resolution
    fwd, side = _pixel_axes(R, R, 2 * max_distance / R, sidx.device)
    fwd_g, side_g, hv, rv, world = _ego_grid(ego, fwd, side)
    sample = _sampler(textures, origins, sidx, world)
    road = torch.maximum(sample(0), sample(1) * 0.5)  # lane lines over drivable area
    route = sample(2)

    stamp = lambda *a: _stamp_obbs(fwd_g, side_g, hv, rv, ego, *a)
    others = stamp(npc.pos, npc.heading, npc.params.length, npc.params.width, npc.active)
    ones = torch.ones((E, 1), dtype=torch.bool, device=sidx.device)
    ego_layer = stamp(ego.pos[:, None, :], ego.heading[:, None], ego.params.length[:, None],
                      ego.params.width[:, None], ones)
    # past ego positions as 1 m dots (top_down_obs_multi_channel past-pos layer)
    K = past_pos.shape[1]
    unit = torch.ones((E, K), device=sidx.device)
    past = stamp(past_pos, torch.zeros_like(unit), unit, unit, unit > 0)
    return torch.stack([road, route, others, ego_layer, past], dim=-1)


def observe_mini_map(textures, origins, sidx, ego, npc, width=168, height=84,
                     max_distance=50.0, look_ahead=20.0):
    """MiniMap sensor frame [E, height, width, 3] (reference:
    component/sensors/mini_map.py, an orthographic camera above the vehicle
    aimed 20 m ahead at aspect 2:1), rendered from the baked map textures.

    Channels: road surface (+ lane lines), all vehicles (ego and others),
    navigation route: a pseudo-RGB the image observation stacks like any
    camera frame."""
    E = sidx.shape[0]
    fwd, side = _pixel_axes(height, width, 2 * max_distance / height, sidx.device, look_ahead)
    fwd_g, side_g, hv, rv, world = _ego_grid(ego, fwd, side)
    sample = _sampler(textures, origins, sidx, world)
    road = torch.maximum(sample(0), sample(1) * 0.5)
    route = sample(2)

    stamp = lambda *a: _stamp_obbs(fwd_g, side_g, hv, rv, ego, *a)
    ones = torch.ones((E, 1), dtype=torch.bool, device=sidx.device)
    cars = torch.maximum(
        stamp(npc.pos, npc.heading, npc.params.length, npc.params.width, npc.active),
        stamp(ego.pos[:, None, :], ego.heading[:, None], ego.params.length[:, None],
              ego.params.width[:, None], ones),
    )
    return torch.stack([road, cars, route], dim=-1)
