"""Ray-vs-segment min-hit sweep of the side and lane-line detector clouds:
the plain version and the per-scenario line table. The reference runs the
plain version on every device: it holds no kernel.

The detector clouds reduce [E, R, B] ray-segment intersections to per-ray
min hit fractions [E, R]. `ray_segment_fraction` is the plain torch
version over per-env endpoints. `build_line_table` packs each scenario's
lane lines once, continuous lines first; `detector_clouds` computes both
clouds from that table.
"""
import torch

from benchmarks.reference.constants import SEG_BROKEN_LINE, SEG_WHITE_LINE, SEG_YELLOW_LINE


def _min_hit_fraction(origin, dx, dy, max_dist, ax, ay, sx, sy, valid):
    """Min over segments of the hit fraction: rays o + t*d [E,R] against
    segments a + u*s [E,B] masked by valid [E,B] -> [E,R]."""
    dx, dy = dx[:, :, None], dy[:, :, None]               # [E,R,1]
    ax, ay = ax[:, None, :], ay[:, None, :]               # [E,1,B]
    sx, sy = sx[:, None, :], sy[:, None, :]
    ox = origin[:, 0][:, None, None]
    oy = origin[:, 1][:, None, None]
    # solve o + t*d = a + u*s
    denom = dx * sy - dy * sx
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    rel_x = ax - ox
    rel_y = ay - oy
    t = (rel_x * sy - rel_y * sx) / denom
    u = (rel_x * dy - rel_y * dx) / denom
    hit = (t >= 0) & (u >= 0) & (u <= 1) & valid[:, None, :]
    frac = torch.where(hit, torch.clamp(t / max_dist, 0.0, 1.0), 1.0)
    return frac.amin(dim=2)


def ray_segment_fraction(origin, angles, max_dist, p0, p1, valid, dirs=None):
    """Min hit fraction of rays against 2D segments, plain torch (the
    side/lane-line detectors' rayTestClosest against lane-line ghosts,
    distance_detector.py:27-85 + SideDetector :194).

    origin [E,2]; angles [E,R] (or unit directions ``dirs`` = (dx, dy));
    p0/p1 [E,B,2]; valid [E,B] -> [E,R].
    """
    dx, dy = dirs if dirs is not None else (torch.cos(angles), torch.sin(angles))
    return _min_hit_fraction(origin, dx, dy, max_dist, p0[..., 0], p0[..., 1],
                             p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1], valid)


def build_line_table(scene, include_broken, points=None):
    """Each scenario's lane-line segments, for the detector clouds.

    Returns ``table`` [S, Bl, 4] float32, rows (ax, ay, sx, sy) with
    a = p0 and s = p1 - p0 of ``points`` = (p0, p1) [S, B, 2], by default
    the dequantized endpoints `Scene.seg_points` gives (the same ops in the
    same order, so bit-equal), and ``counts`` [S, 2] int32,
    (n_cont, n_any). Within a scenario the valid continuous lines (yellow,
    white) come first, then, with ``include_broken``, the valid broken
    lines; each group keeps its order. Rows from n_any to Bl are zero;
    Bl = max(1, max n_any). The sweep's result is a min, which no order
    changes, so the table gives the same clouds as the per-env masks."""
    S = scene.num_scenarios
    p0, p1 = points if points is not None else scene.seg_points(
        torch.arange(S, device=scene.seg_type.device))
    rows = torch.cat([p0, p1 - p0], dim=-1)                               # [S,B,4]
    typ, valid = scene.seg_type, scene.seg_valid
    cont = ((typ == SEG_YELLOW_LINE) | (typ == SEG_WHITE_LINE)) & valid
    broken = (typ == SEG_BROKEN_LINE) & valid if include_broken else torch.zeros_like(cont)
    # group 0 = continuous, 1 = broken, 2 = dropped; a stable sort keeps
    # the order within each group
    group = torch.where(cont, 0, torch.where(broken, 1, 2))
    order = torch.sort(group, dim=1, stable=True).indices
    n_cont = cont.sum(1)
    n_any = n_cont + broken.sum(1)
    Bl = max(1, int(n_any.max()))
    n = min(Bl, rows.shape[1])
    table = torch.zeros((S, Bl, 4), dtype=torch.float32, device=rows.device)
    table[:, :n] = torch.gather(rows, 1, order[:, :n, None].expand(S, n, 4))
    keep = torch.arange(Bl, device=rows.device)[None, :] < n_any[:, None]
    table = torch.where(keep[..., None], table, 0.0)
    counts = torch.stack([n_cont, n_any], dim=1).to(torch.int32)
    return table, counts


def detector_clouds_plain(origin, sidx, side_dirs, lane_dirs, side_dist, lane_dist, table, counts):
    """Plain torch version of `detector_clouds`: gathers each env's table
    rows and masks row j < n_cont (side) and j < n_any (lane-line)."""
    s = sidx.long()
    rows, c = table[s], counts[s]                                         # [E,Bl,4], [E,2]
    j = torch.arange(table.shape[1], device=table.device)[None, :]
    ax, ay, sx, sy = rows.unbind(-1)
    side = _min_hit_fraction(origin, *side_dirs, side_dist, ax, ay, sx, sy, j < c[:, 0:1])
    lane = _min_hit_fraction(origin, *lane_dirs, lane_dist, ax, ay, sx, sy, j < c[:, 1:2])
    return side, lane


def detector_clouds(origin, sidx, side_dirs, lane_dirs, side_dist, lane_dist, table, counts):
    """The side and lane-line detector clouds, (side [E,Rs], lane [E,Rl]),
    by the plain version on every device."""
    return detector_clouds_plain(origin, sidx, side_dirs, lane_dirs, side_dist, lane_dist,
                                 table, counts)
