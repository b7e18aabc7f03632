"""Batched lidar and detector raycasting.

Replaces the per-ray Bullet rayTestClosest loop
(component/sensors/distance_detector.py:27-85 + lidar.py:49-73) with
batched ray-vs-body tests over [E, num_rays, num_targets]. Output matches
the reference cloud: hit fraction in [0,1] per ray, 1.0 when nothing is hit
within `distance`.

Ray i leaves at angle heading + offset + 2*pi*i/N.
"""
import math

import torch

from benchmarks.reference.ops import ray_segment


def _fan_dirs(heading, num_rays, offset=0.0):
    """Unit directions (dx, dy) [E, R] of the ray fan
    heading + offset + 2*pi*i/N, via the angle-addition identity: cos/sin of
    the heading per env against constant fan tables."""
    i = torch.arange(num_rays, dtype=torch.float32, device=heading.device)
    phi = offset + (2.0 * math.pi / num_rays) * i
    cphi, sphi = torch.cos(phi)[None, :], torch.sin(phi)[None, :]
    ch, sh = torch.cos(heading)[:, None], torch.sin(heading)[:, None]
    return ch * cphi - sh * sphi, sh * cphi + ch * sphi


def ray_obb_fraction(origin, dirs, max_dist, obb_c, obb_h, obb_len, obb_wid, obb_active):
    """Min hit fraction of each ray against a set of OBBs.

    origin [E,2]; dirs = (dx, dy) unit directions [E,R]; obb_* [E,N];
    returns [E,R] in [0,1].
    """
    dirx = dirs[0][:, :, None]                   # [E,R,1]
    diry = dirs[1][:, :, None]
    # transform ray into each OBB frame
    c, s = torch.cos(obb_h)[:, None, :], torch.sin(obb_h)[:, None, :]  # [E,1,N]
    relx = origin[:, 0][:, None, None] - obb_c[..., 0][:, None, :]
    rely = origin[:, 1][:, None, None] - obb_c[..., 1][:, None, :]
    ox = relx * c + rely * s                     # [E,R,N]
    oy = -relx * s + rely * c
    dx = dirx * c + diry * s
    dy = -dirx * s + diry * c

    hx = (obb_len / 2)[:, None, :]
    hy = (obb_wid / 2)[:, None, :]

    # slab method, branchless
    inv_dx = 1.0 / torch.where(torch.abs(dx) < 1e-9, 1e-9, dx)
    inv_dy = 1.0 / torch.where(torch.abs(dy) < 1e-9, 1e-9, dy)
    tx1, tx2 = (-hx - ox) * inv_dx, (hx - ox) * inv_dx
    ty1, ty2 = (-hy - oy) * inv_dy, (hy - oy) * inv_dy
    tmin = torch.maximum(torch.minimum(tx1, tx2), torch.minimum(ty1, ty2))
    tmax = torch.minimum(torch.maximum(tx1, tx2), torch.maximum(ty1, ty2))
    hit = (tmax >= tmin) & (tmax >= 0) & obb_active[:, None, :]
    t = torch.where(tmin >= 0, tmin, tmax)  # origin inside -> exit point
    frac = torch.where(hit, torch.clamp(t / max_dist, 0.0, 1.0), 1.0)
    return frac.amin(dim=2)


def ray_circle_fraction(origin, dirs, max_dist, c, r, active):
    """Min hit fraction of rays against circles (the reference's cylinder
    bodies: pedestrians r=0.35 pedestrian.py:12-118, cones r=0.2 /
    warnings r=0.5 traffic_object.py:43-160).

    origin [E,2]; dirs = (dx, dy) [E,R]; c [E,N,2]; r [E,N]; active [E,N]
    -> [E,R].
    """
    dirx = dirs[0][:, :, None]                       # [E,R,1]
    diry = dirs[1][:, :, None]
    relx = c[..., 0][:, None, :] - origin[:, 0][:, None, None]   # [E,R,N]
    rely = c[..., 1][:, None, :] - origin[:, 1][:, None, None]
    # |o + t d - c|^2 = r^2 with |d| = 1: t^2 - 2 b t + (|rel|^2 - r^2) = 0
    b = relx * dirx + rely * diry
    disc = b * b - (relx * relx + rely * rely - (r * r)[:, None, :])
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    t_in, t_out = b - root, b + root
    t = torch.where(t_in >= 0, t_in, t_out)  # origin inside -> exit point
    hit = (disc >= 0) & (t_out >= 0) & active[:, None, :]
    frac = torch.where(hit, torch.clamp(t / max_dist, 0.0, 1.0), 1.0)
    return frac.amin(dim=2)


def lidar_cloud(ego_pos, ego_heading, num_rays, max_dist,
                npc_pos, npc_heading, npc_len, npc_wid, npc_active,
                radius=None, circle_slice=None):
    """The lidar cloud (lidar.py:16-73): fraction of `max_dist` to the
    nearest body along each of `num_rays` fanned rays.

    ``radius`` [E,N] (optional) marks cylinder bodies: rows with
    radius > 0 ray-cast as circles of that radius; rows with radius <= 0
    stay OBBs. ``circle_slice`` bounds the target range that can hold
    cylinders, so the circle pass skips the vehicle axis."""
    dirs = _fan_dirs(ego_heading, num_rays)
    if radius is None:
        return ray_obb_fraction(ego_pos, dirs, max_dist, npc_pos, npc_heading,
                                npc_len, npc_wid, npc_active)
    circ = radius > 0
    box_frac = ray_obb_fraction(ego_pos, dirs, max_dist, npc_pos, npc_heading,
                                npc_len, npc_wid, npc_active & ~circ)
    sl = circle_slice if circle_slice is not None else slice(None)
    circ_frac = ray_circle_fraction(ego_pos, dirs, max_dist, npc_pos[:, sl],
                                    radius[:, sl], (npc_active & circ)[:, sl])
    return torch.minimum(box_frac, circ_frac)


def detector_clouds(ego_pos, ego_heading, sidx, side, lane, table, counts):
    """SideDetector and LaneLineDetector clouds (distance_detector.py:
    118-160, side variant: rays offset 90 deg fanned over the circle)
    against the lane lines of `ray_segment.build_line_table`: the side
    detector sees the continuous lines (:194), the lane-line detector all
    of them (:209). ``side`` / ``lane`` = (num_rays, max_dist); a detector
    with 0 rays gives an [E, 0] cloud. Both clouds come from one launch of
    the ray-segment kernel for CUDA tensors."""
    (rs, side_dist), (rl, lane_dist) = side, lane
    none = ego_heading.new_zeros((ego_heading.shape[0], 0))
    fan = lambda R: _fan_dirs(ego_heading, R, offset=math.pi / 2) if R > 0 else (none, none)
    return ray_segment.detector_clouds(ego_pos.contiguous(), sidx, fan(rs), fan(rl),
                                       side_dist, lane_dist, table, counts)
