"""Batched closed-form lane geometry.

The reference computes lane coordinates per Python object
(straight_lane.py:60-74, circular_lane.py:57-121). Here the same closed
forms run as branchless batched ops over lane-parameter tensors: every
function broadcasts over leading batch axes, and the straight/circular
split is a `torch.where` select.

The circular `local_coordinates` uses a total (never-raising) version of the
reference's closest-endpoint phase disambiguation (circular_lane.py:71-121):
points in the reference's "undetermined" far region resolve to whichever
endpoint is phase-closer, which agrees with the reference everywhere the
reference is defined.
"""
import math

import torch

from benchmarks.reference.constants import LANE_CIRCULAR
from benchmarks.reference.core import structs as st
from benchmarks.reference.ops.gather import table_lookup
from benchmarks.reference.ops.math_ops import wrap_to_pi


def _toi(x):
    return torch.round(x).to(torch.int32)


def _lane_fields(vals):
    return dict(
        kind=_toi(vals[..., st.LANE_KIND]),
        p0=vals[..., st.LANE_P0X:st.LANE_P0Y + 1],
        dirv=vals[..., st.LANE_DIRX:st.LANE_DIRY + 1],
        radius=torch.clamp(vals[..., st.LANE_RADIUS], min=1e-6),  # guard /0 on padded rows
        start_phase=vals[..., st.LANE_START_PHASE],
        arc_dir=vals[..., st.LANE_ARC_DIR],
        width=vals[..., st.LANE_WIDTH],
        length=vals[..., st.LANE_LENGTH],
        angle=vals[..., st.LANE_ANGLE],
        road=_toi(vals[..., st.LANE_ROAD]),
        idx_in_road=_toi(vals[..., st.LANE_IDX_IN_ROAD]),
        succ=_toi(vals[..., st.LANE_SUCC]),
        left=_toi(vals[..., st.LANE_LEFT]),
        right=_toi(vals[..., st.LANE_RIGHT]),
        valid=vals[..., st.LANE_VALID] > 0.5,
        speed_limit=vals[..., st.LANE_SPEED_LIMIT],
        block=_toi(vals[..., st.LANE_BLOCK]),
    )


def _flat_sidx(sidx):
    return sidx.reshape(sidx.shape[0]) if sidx.dim() > 1 else sidx


def gather_lane(scene, sidx, lid):
    """Per-lane geometry params for (env scenario, lane id) pairs.

    sidx: [E] (or [E,1] to broadcast against lid [E,N]); lid: [E] or [E,N].
    Returns a dict of tensors shaped like lid; ids outside the lane table
    give zero rows.
    """
    return _lane_fields(table_lookup(scene.lane_table, _flat_sidx(sidx), lid))


def gather_lane_with_neighbors(scene, sidx, lid):
    """gather_lane plus the left/right neighbour lanes' gap-search geometry
    (and their successor ids), from one lookup into the joined
    ``lane_nbr_table`` (core/structs.py). Returns (g, g_left, g_right); the
    neighbour dicts carry kind/p0/dirv/radius/start_phase/arc_dir/width/
    length/angle/succ (zeros and succ=-1 where the neighbour does not exist
    — mask with g["left"] >= 0 etc.).
    """
    vals = table_lookup(scene.lane_nbr_table, _flat_sidx(sidx), lid)

    def nbr(off):
        v = vals[..., off:off + st.NBR_F]
        return dict(
            kind=_toi(v[..., 0]),
            p0=v[..., 1:3],
            dirv=v[..., 3:5],
            radius=torch.clamp(v[..., 5], min=1e-6),
            start_phase=v[..., 6],
            arc_dir=v[..., 7],
            width=v[..., 8],
            length=v[..., 9],
            angle=v[..., 10],
            succ=_toi(v[..., 11]),
        )

    return _lane_fields(vals), nbr(st.LANE_F), nbr(st.LANE_F + st.NBR_F)


def gather_road(scene, sidx, rid):
    """Per-road fields: dict(lane0, nlanes, negative, succ); ids outside the
    road table give zeros."""
    vals = table_lookup(scene.road_table, _flat_sidx(sidx), rid)
    return dict(
        lane0=_toi(vals[..., st.ROAD_LANE0]),
        nlanes=_toi(vals[..., st.ROAD_NLANES]),
        negative=vals[..., st.ROAD_NEGATIVE] > 0.5,
        succ=_toi(vals[..., st.ROAD_SUCC]),
    )


def gather_all_lanes(scene, sidx):
    """Per-env rows of every lane's params: each field [E, L(, 2)]."""
    take = lambda a: a[sidx.long()]
    return dict(
        kind=take(scene.lane_kind),
        p0=take(scene.lane_p0),
        dirv=take(scene.lane_dir),
        radius=torch.clamp(take(scene.lane_radius), min=1e-6),
        start_phase=take(scene.lane_start_phase),
        arc_dir=take(scene.lane_arc_dir),
        width=take(scene.lane_width),
        length=take(scene.lane_length),
        angle=take(scene.lane_angle),
    )


def local_coordinates(g, pos):
    """(longitudinal, lateral) of world points in lanes ``g``.

    g: dict from gather_lane with batch shape B; pos: [..., 2] broadcastable.
    """
    delta = pos - g["p0"]  # straight: rel start; circular: rel center
    # straight (straight_lane.py:69-74)
    long_s = delta[..., 0] * g["dirv"][..., 0] + delta[..., 1] * g["dirv"][..., 1]
    lat_s = delta[..., 0] * g["dirv"][..., 1] - delta[..., 1] * g["dirv"][..., 0]
    # circular (circular_lane.py:71-121), branchless
    abs_phase = wrap_to_pi(torch.atan2(delta[..., 1], delta[..., 0]))
    start_phase = wrap_to_pi(g["start_phase"])
    end_phase = wrap_to_pi(g["start_phase"] + g["arc_dir"] * g["angle"])
    d_start = torch.abs(wrap_to_pi(abs_phase - start_phase))
    d_end = torch.abs(wrap_to_pi(abs_phase - end_phase))
    long_from_start = wrap_to_pi(g["arc_dir"] * (abs_phase - start_phase)) * g["radius"]
    long_from_end = wrap_to_pi(g["arc_dir"] * (abs_phase - end_phase)) * g["radius"] + g["length"]
    long_c = torch.where(d_start > d_end, long_from_end, long_from_start)
    dist = torch.sqrt(delta[..., 0] ** 2 + delta[..., 1] ** 2)
    lat_c = g["arc_dir"] * (dist - g["radius"])

    is_circ = g["kind"] == LANE_CIRCULAR
    return torch.where(is_circ, long_c, long_s), torch.where(is_circ, lat_c, lat_s)


def position(g, longitudinal, lateral):
    """World position of lane-local coordinates (straight_lane.py:60-61,
    circular_lane.py:57-62)."""
    pos_s = (
        g["p0"]
        + longitudinal[..., None] * g["dirv"]
        + lateral[..., None] * torch.stack([g["dirv"][..., 1], -g["dirv"][..., 0]], dim=-1)
    )
    phi = g["arc_dir"] * longitudinal / g["radius"] + g["start_phase"]
    r = g["radius"] + lateral * g["arc_dir"]
    pos_c = g["p0"] + r[..., None] * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    return torch.where((g["kind"] == LANE_CIRCULAR)[..., None], pos_c, pos_s)


def heading_theta_at(g, longitudinal):
    """Lane heading at a longitudinal position (straight_lane.py:63-64,
    circular_lane.py:64-67)."""
    head_s = torch.atan2(g["dirv"][..., 1], g["dirv"][..., 0])
    phi = g["arc_dir"] * longitudinal / g["radius"] + g["start_phase"]
    head_c = phi + 0.5 * math.pi * g["arc_dir"]
    return torch.where(g["kind"] == LANE_CIRCULAR, head_c, head_s)


def on_lane(g, longitudinal, lateral, margin=0.0):
    """Point-in-lane-polygon equivalent (abs_lane.py point_on_lane)."""
    return (
        (longitudinal >= -margin)
        & (longitudinal <= g["length"] + margin)
        & (torch.abs(lateral) <= g["width"] / 2 + margin)
    )


def l1_distance(g, longitudinal, lateral):
    """L1 lane distance used for closest-lane ranking
    (reference GraphLookupTable.get, node_road_network.py:19-65)."""
    over = torch.clamp(longitudinal - g["length"], min=0.0) + torch.clamp(-longitudinal, min=0.0)
    return torch.abs(lateral) + over
