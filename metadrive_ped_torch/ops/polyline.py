"""Batched polyline (PointLane) geometry.

The reference's PointLane (component/lane/point_lane.py via
utils/interpolating_line.py) parametrizes recorded trajectories/scenario
lanes by arc length. Here a polyline is a fixed-size point array
[P, 2] with a valid count; all queries are nearest-segment projections,
vectorized over batch axes that broadcast against each other.

Segments are selected by plain indexing (`torch.gather`), with the values
of the JAX package's one-hot contractions.
"""
import torch


def _pick(values, best):
    """values[..., best]: values [.., P] and best [..] broadcast together."""
    batch = torch.broadcast_shapes(values.shape[:-1], best.shape)
    v = values.expand(batch + values.shape[-1:])
    return torch.gather(v, -1, best.long().expand(batch)[..., None])[..., 0]


def _pick_rows(pts, rows):
    """Rows ``rows`` [.., K] of pts [.., P, 2] -> [.., K, 2], the batch axes
    broadcast together."""
    batch = torch.broadcast_shapes(pts.shape[:-2], rows.shape[:-1])
    p = pts.expand(batch + pts.shape[-2:])
    idx = rows.long().expand(batch + rows.shape[-1:])
    return torch.gather(p, -2, idx[..., None].expand(idx.shape + (2,)))


def _pick_pair(pts, best):
    """Rows best and best+1 of pts [.., P, 2]. Requires best <= P-2."""
    ab = _pick_rows(pts, best[..., None] + torch.arange(2, device=best.device))
    return ab[..., 0, :], ab[..., 1, :]


def arc_lengths(pts, npts):
    """Cumulative arc length [.., P]; entries past npts hold the total."""
    d = torch.sqrt(((pts[..., 1:, :] - pts[..., :-1, :]) ** 2).sum(-1))  # [..,P-1]
    P = pts.shape[-2]
    idx = torch.arange(P - 1, device=pts.device)
    valid = idx < (npts[..., None] - 1)
    d = torch.where(valid, d, 0.0)
    return torch.cat([torch.zeros_like(d[..., :1]), torch.cumsum(d, dim=-1)], dim=-1)


def local_coordinates(pts, npts, pos, s=None):
    """(long, lat) of pos on the polyline; pts [..,P,2], pos [..,2].

    lat sign follows the lane convention: positive to the RIGHT of travel.
    ``s`` = precomputed arc_lengths(pts, npts) (static per scenario: pass
    it from the scene pack to skip the per-step cumsum).
    """
    a = pts[..., :-1, :]
    b = pts[..., 1:, :]
    seg = b - a
    seg_len2 = (seg ** 2).sum(-1)
    idxs = torch.arange(pts.shape[-2] - 1, device=pts.device)
    valid = idxs < (npts[..., None] - 1)
    rel = pos[..., None, :] - a
    t = torch.clamp((rel * seg).sum(-1) / torch.clamp(seg_len2, min=1e-9), 0.0, 1.0)
    proj = a + t[..., None] * seg
    d2 = ((pos[..., None, :] - proj) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.inf)
    best = torch.argmin(d2, dim=-1)

    if s is None:
        s = arc_lengths(pts, npts)
    t_b = _pick(t, best)
    a_b, b_b = _pick_pair(pts, best)
    seg_b = b_b - a_b
    s_b = _pick(s[..., :-1], best)
    seg_len = torch.sqrt(torch.clamp((seg_b ** 2).sum(-1), min=1e-12))
    long = s_b + t_b * seg_len
    rel_b = pos - a_b
    # right-hand lateral: cross(seg_dir, rel) < 0 means left -> lat negative
    cross = seg_b[..., 0] * rel_b[..., 1] - seg_b[..., 1] * rel_b[..., 0]
    perp = torch.sqrt(torch.clamp((rel_b ** 2).sum(-1) - (t_b * seg_len) ** 2, min=0.0))
    lat = torch.where(cross > 0, -perp, perp)
    return long, lat


def _containing_segment(pts, npts, long, s=None):
    """Index of the last valid segment whose start arc-length <= long."""
    if s is None:
        s = arc_lengths(pts, npts)
    P = pts.shape[-2]
    seg_start = s[..., :-1]
    idxs = torch.arange(P - 1, device=pts.device)
    valid = idxs < (npts[..., None] - 1)
    le = (seg_start <= long[..., None]) & valid
    best = torch.clamp(torch.where(le, idxs, -1).amax(dim=-1), min=0)
    return best, seg_start


def position(pts, npts, long, lat=None, s=None):
    """World position at arc length `long` (+ optional right-lateral)."""
    best, seg_start = _containing_segment(pts, npts, long, s)
    a, b = _pick_pair(pts, best)
    s_b = _pick(seg_start, best)
    seg = b - a
    seg_len = torch.sqrt(torch.clamp((seg ** 2).sum(-1), min=1e-12))
    t = torch.clamp((long - s_b) / seg_len, min=0.0)
    p = a + t[..., None] * seg
    if lat is not None:
        dirv = seg / seg_len[..., None]
        rhs = torch.stack([dirv[..., 1], -dirv[..., 0]], dim=-1)
        p = p + lat[..., None] * rhs
    return p


def heading_at(pts, npts, long, s=None):
    """Heading (radians) of the segment containing `long`."""
    best, _ = _containing_segment(pts, npts, long, s)
    a, b = _pick_pair(pts, best)
    return torch.atan2(b[..., 1] - a[..., 1], b[..., 0] - a[..., 0])


def total_length(pts, npts, s=None):
    if s is None:
        s = arc_lengths(pts, npts)
    return s[..., -1]


def _chord_index_frac(P, unpts, spacing, long, total):
    """Containing chord index + interpolation fraction on a fixed-spacing
    path, with the last (short) chord's fraction renormalized against the
    true route total so end-of-route poses land on the recorded endpoint."""
    i = torch.floor(long / spacing).to(torch.int32)
    i = torch.clamp(torch.minimum(i, unpts - 2), 0, P - 2)
    frac = torch.clamp(long / spacing - i, 0.0, 1.0)
    if total is not None:
        last_i = torch.clamp(unpts - 2, min=0)
        last_span = torch.clamp(total - last_i.to(total.dtype) * spacing, min=1e-6)
        frac = torch.where(
            i == last_i,
            torch.clamp((long - i.to(total.dtype) * spacing) / last_span, 0.0, 1.0),
            frac,
        )
    return i, frac


def uniform_pose(upath, unpts, spacing, long, total=None, scale=None, origin=None):
    """Pose at arc length `long` on a FIXED-SPACING chord path.

    With uniform chords the containing segment is floor(long/spacing), so
    the pose takes one row gather instead of the generic polyline search.
    upath [.., P, 2] (float, or int16 with ``scale`` and ``origin`` [.., 2]),
    unpts [..], long [..] -> (pos [.., 2], heading [..]).

    The FINAL chord (built with the end arc clamped to the route total) is
    shorter than `spacing`; pass `total` (the route arc length, [..]) to
    renormalize the interpolation fraction there so end-of-route poses land
    exactly on the recorded endpoint instead of under-advancing by up to one
    chord.
    """
    P = upath.shape[-2]
    i, frac = _chord_index_frac(P, unpts, spacing, long, total)
    pp = _pick_rows(upath, i[..., None] + torch.arange(2, device=i.device))
    if scale is not None:
        # int16 offsets from origin: dequantized after the gather
        pp = origin[..., None, :] + scale * pp.float()
    p0, p1 = pp[..., 0, :], pp[..., 1, :]
    pos = p0 + frac[..., None] * (p1 - p0)
    heading = torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
    return pos, heading


def uniform_pose_and_ahead(upath, unpts, spacing, long, total, deltas,
                           scale=None, origin=None):
    """uniform_pose PLUS the chord points at indices i+delta, sharing one
    chord-index/frac computation and one gather of the path's rows (i,
    i+1, and i+delta for each delta, clamped like the endpoint clamp: rows
    pad [unpts:] with the endpoint).

    Returns (pos [.., 2], heading [..], [points at i+d for d in deltas]).
    """
    P = upath.shape[-2]
    i, frac = _chord_index_frac(P, unpts, spacing, long, total)
    # the rows as i + d for each Python int d: no host-to-device copy
    rows = torch.stack([i + d for d in (0, 1) + tuple(deltas)], dim=-1)
    j = torch.clamp(torch.minimum(rows, (unpts - 1)[..., None]), 0, P - 1)
    pp = _pick_rows(upath, j)                                            # [.., K, 2]
    if scale is not None:
        pp = origin[..., None, :] + scale * pp.float()
    p0, p1 = pp[..., 0, :], pp[..., 1, :]
    pos = p0 + frac[..., None] * (p1 - p0)
    heading = torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
    return pos, heading, [pp[..., 2 + k, :] for k in range(len(deltas))]


def in_band(pts, npts, pos, half_width):
    """Whether pos lies within half_width of the polyline (clamped segment
    distance). pts [..,P,2], pos [..,2], half_width [..]."""
    a = pts[..., :-1, :]
    b = pts[..., 1:, :]
    seg = b - a
    seg_len2 = (seg ** 2).sum(-1)
    idxs = torch.arange(pts.shape[-2] - 1, device=pts.device)
    valid = idxs < (npts[..., None] - 1)
    rel = pos[..., None, :] - a
    t = torch.clamp((rel * seg).sum(-1) / torch.clamp(seg_len2, min=1e-9), 0.0, 1.0)
    proj = a + t[..., None] * seg
    d2 = ((pos[..., None, :] - proj) ** 2).sum(-1)
    return (torch.where(valid, d2, torch.inf) <= half_width[..., None] ** 2).any(-1)
