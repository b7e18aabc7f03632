"""Batched narrow-phase collision tests.

Replaces Bullet contact/sweep tests (_state_check, base_vehicle.py:700-792;
rect_region_detection, utils/pg/utils.py:213-253) with exact 2D SAT over
fixed-size tensors:

- vehicle OBB vs boundary segments  -> crash_sidewalk / on_*_line flags
- vehicle OBB vs vehicle OBB        -> crash_vehicle

Everything broadcasts; no data-dependent shapes.
"""
import torch


def _to_frame(points, center, heading):
    """World points -> OBB-local frame (x along heading)."""
    d = points - center
    c, s = torch.cos(heading), torch.sin(heading)
    x = d[..., 0] * c + d[..., 1] * s
    y = -d[..., 0] * s + d[..., 1] * c
    return x, y


def obb_segment_overlap(center, heading, half_len, half_wid, p0, p1, inflate):
    """SAT overlap of an OBB with (possibly thick) segments.

    center [...,2], heading [...], half_len/half_wid [...] broadcast against
    p0/p1 [...,2]; inflate [...] is the segment half-thickness added to the
    box extents. Returns bool of the broadcast batch shape.
    """
    hx = half_len + inflate
    hy = half_wid + inflate
    ax, ay = _to_frame(p0, center, heading)
    bx, by = _to_frame(p1, center, heading)
    # box axes
    overlap_x = (torch.minimum(ax, bx) <= hx) & (torch.maximum(ax, bx) >= -hx)
    overlap_y = (torch.minimum(ay, by) <= hy) & (torch.maximum(ay, by) >= -hy)
    # segment-normal axis
    dx, dy = bx - ax, by - ay
    seg_len = torch.sqrt(dx * dx + dy * dy)
    safe_len = torch.clamp(seg_len, min=1e-9)
    nx = torch.where(seg_len > 1e-9, -dy / safe_len, 1.0)
    ny = torch.where(seg_len > 1e-9, dx / safe_len, 0.0)
    box_radius = hx * torch.abs(nx) + hy * torch.abs(ny)
    dist_line = torch.abs(nx * ax + ny * ay)
    overlap_n = dist_line <= box_radius
    return overlap_x & overlap_y & overlap_n


def vehicle_segment_flags(pos, heading, length, width, seg_p0, seg_p1, seg_type,
                          seg_halfwidth, seg_valid, type_ids):
    """For each type id, whether the vehicle overlaps any segment of that
    type. pos [E,2]; seg_* [E,B,...]; returns dict type_id -> [E] bool."""
    hit = obb_segment_overlap(
        pos[:, None, :], heading[:, None], (length / 2)[:, None], (width / 2)[:, None],
        seg_p0, seg_p1, seg_halfwidth
    ) & seg_valid
    return {t: (hit & (seg_type == t)).any(dim=1) for t in type_ids}


def obb_obb_overlap(c1, h1, len1, wid1, c2, h2, len2, wid2):
    """2D SAT for two OBBs; broadcasts over batch axes."""

    def axes_overlap(ca, ha, la, wa, cb, hb, lb, wb):
        """Project OBB b onto OBB a's two axes."""
        bx, by = _to_frame(cb, ca, ha)
        rel = hb - ha
        cr, sr = torch.abs(torch.cos(rel)), torch.abs(torch.sin(rel))
        # extent of b projected on a's axes
        ex = (lb / 2) * cr + (wb / 2) * sr
        ey = (lb / 2) * sr + (wb / 2) * cr
        ok_x = torch.abs(bx) <= (la / 2) + ex
        ok_y = torch.abs(by) <= (wa / 2) + ey
        return ok_x & ok_y

    return axes_overlap(c1, h1, len1, wid1, c2, h2, len2, wid2) & \
        axes_overlap(c2, h2, len2, wid2, c1, h1, len1, wid1)


def obb_circle_overlap(c1, h1, len1, wid1, c2, r2):
    """Exact 2D OBB-vs-circle test (the reference's cylinder bodies:
    pedestrians r=0.35, cones r=0.2, warnings r=0.5): the closest point of
    the box to the circle center lies within the radius."""
    bx, by = _to_frame(c2, c1, h1)
    dx = torch.clamp(torch.abs(bx) - len1 / 2, min=0.0)
    dy = torch.clamp(torch.abs(by) - wid1 / 2, min=0.0)
    return dx * dx + dy * dy <= r2 * r2


def obb_obb_mtv(c1, h1, len1, wid1, c2, h2, len2, wid2):
    """Minimum-translation vector separating OBB1 from OBB2 (2D SAT).

    Returns (depth, normal): depth [...] is the overlap along the least-
    penetrating of the 4 face axes (<= 0 means no overlap); normal [..., 2]
    is the unit direction that moves OBB1 out of OBB2 (the penetration data
    Bullet's contact solver produces per manifold point,
    engine_core.py:350-352). Of tied axes the first wins.
    """
    d = c1 - c2
    ax1 = torch.stack([torch.cos(h1), torch.sin(h1)], dim=-1)
    ay1 = torch.stack([-torch.sin(h1), torch.cos(h1)], dim=-1)
    ax2 = torch.stack([torch.cos(h2), torch.sin(h2)], dim=-1)
    ay2 = torch.stack([-torch.sin(h2), torch.cos(h2)], dim=-1)
    ax1, ay1, ax2, ay2 = torch.broadcast_tensors(ax1, ay1, ax2, ay2)
    axes = torch.stack([ax1, ay1, ax2, ay2], dim=-2)            # [...,4,2]

    def proj_radius(u, ax, ay, half_l, half_w):
        return (
            half_l[..., None] * torch.abs((u * ax[..., None, :]).sum(-1))
            + half_w[..., None] * torch.abs((u * ay[..., None, :]).sum(-1))
        )

    r1 = proj_radius(axes, ax1, ay1, len1 / 2, wid1 / 2)        # [...,4]
    r2 = proj_radius(axes, ax2, ay2, len2 / 2, wid2 / 2)
    sep = (axes * d[..., None, :]).sum(-1)                      # [...,4]
    depth4 = r1 + r2 - torch.abs(sep)
    depth = depth4.amin(dim=-1)
    first = depth4.argmin(dim=-1)   # torch.argmin returns the first minimum
    pick = lambda a: a.gather(-2, first[..., None, None].expand(*first.shape, 1, a.shape[-1]))[..., 0, :]
    normal = pick(axes * torch.sign(sep)[..., None])
    # degenerate exactly-coincident centers: push along OBB2's x axis
    normal = torch.where(torch.abs(normal).sum(-1, keepdim=True) < 1e-6, ax2, normal)
    return depth, normal


def contact_speed_scale(speed, move_dir, normal, contact):
    """Closing-velocity kill for the scalar-speed bicycle state.

    The body's velocity is speed * u(move_dir); a rigid contact removes the
    component driving into the surface (normal points away from the other
    body). Returns the scale factor in [0, 1] to apply to `speed`.
    contact [..., C] masks live contacts; normal [..., C, 2].
    """
    u = torch.stack([torch.cos(move_dir), torch.sin(move_dir)], dim=-1)
    un = (u[..., None, :] * normal).sum(-1)                     # [...,C]
    closing = contact & (speed[..., None] * un < 0)
    drop = torch.where(closing, un * un, 0.0).sum(-1)
    return torch.clamp(1.0 - drop, 0.0, 1.0)
