"""Localization + navigation.

Replaces the reference's per-step Bullet ray localization and checkpoint
bookkeeping (utils/pg/utils.py:151-211 ray_localization;
node_network_navigation.py:130-304) with a batched scan over the scene's
lane tensors: every env tests its position against every (padded) lane of
its scenario with the closed-form lane geometry, then picks the current lane
with the reference's preference order — current ref road first, next ref
road, then closest on-lane, else keep the previous lane.

Also emits the 2x5 navigation feature block
(node_network_navigation.py:243-292) and the destination/arrival and
left/right-boundary quantities consumed by reward/done/obs.
"""
import torch

from benchmarks.reference.constants import LANE_CIRCULAR
from benchmarks.reference.mapgen.spaces import CURVE_ANGLE_MAX, CURVE_RADIUS_MAX
from benchmarks.reference.ops import lane_geom
from benchmarks.reference.ops.gather import onehot_pick
from benchmarks.reference.ops.math_ops import clip01, heading_vec, rhs_vec

CKPT_UPDATE_RANGE = 5.0   # base_navigation.py:23
NAVI_POINT_DIST = 50.0    # base_navigation.py:20


def _routes(scene, sidx, slot):
    """Per-env route rows for (scenario, spawn-slot): ([E,K] roads, [E] len)."""
    SLOT = scene.route_len.shape[1]
    rid = (sidx * SLOT + slot).long()
    return scene.route_flat[rid], scene.route_len_flat[rid]


def localize(scene, sidx, slot, pos, prev_lane, route_idx):
    """Find the current lane and updated checkpoint index for each env.

    sidx, slot, prev_lane, route_idx: [E]; pos: [E,2].
    Returns dict(lane, route_idx, on_lane, long, lat, road, cur_road).
    """
    g = lane_geom.gather_all_lanes(scene, sidx)
    long, lat = lane_geom.local_coordinates(g, pos[:, None, :])
    valid = scene.lane_valid[sidx.long()]
    on = lane_geom.on_lane(g, long, lat) & valid

    on_lane_any = on.any(dim=1)

    lane_road = scene.lane_road[sidx.long()]  # [E,L]
    route_roads_e, route_len_e = _routes(scene, sidx, slot)  # [E,K], [E]
    kmax = route_roads_e.shape[1] - 1
    cur_road = onehot_pick(route_roads_e, torch.clamp(route_idx, 0, kmax))
    route_next = torch.clamp(route_idx + 1, 0, kmax)
    next_road = torch.where(
        route_idx + 1 < route_len_e, onehot_pick(route_roads_e, route_next), -1
    )

    dist = lane_geom.l1_distance(g, long, lat)
    big = 1e9
    # preference scoring (reference _get_current_lane,
    # node_network_navigation.py:219-241): current road < next road < other;
    # within a tier, smaller L1 distance wins; off-lane lanes never win
    tier = torch.where(
        lane_road == cur_road[:, None], 0.0,
        torch.where(lane_road == next_road[:, None], 1e4, 2e4),
    )
    score = torch.where(on, dist + tier, big)
    best = torch.argmin(score, dim=1).to(torch.int32)  # first index on a tie
    found = score.amin(dim=1) < big  # best lane is on-lane
    lane = torch.where(found, best, prev_lane)

    lane_long = onehot_pick(long, lane)
    lane_lat = onehot_pick(lat, lane)

    # checkpoint advance (node_network_navigation.py:181-201): when the
    # vehicle enters a later route road near its start, move the target
    # checkpoint forward.
    K = route_roads_e.shape[1]
    kk = torch.arange(K, dtype=torch.int32, device=pos.device)[None, :]
    this_road = onehot_pick(lane_road, lane)
    match = (route_roads_e == this_road[:, None]) & (kk < route_len_e[:, None])
    k_pos = torch.where(match, kk, K + 1).amin(dim=1)  # first route position of this road
    advance = (k_pos > route_idx) & (k_pos <= K) & (lane_long < CKPT_UPDATE_RANGE) & found
    new_route_idx = torch.where(advance, k_pos, route_idx)

    return dict(lane=lane, route_idx=new_route_idx, on_lane=on_lane_any,
                long=lane_long, lat=lane_lat, road=this_road, cur_road=cur_road)


def route_road_at(scene, sidx, slot, k):
    """Route road id at checkpoint position k (clipped), per env."""
    route_roads_e, _ = _routes(scene, sidx, slot)
    return onehot_pick(route_roads_e, torch.clamp(k, 0, route_roads_e.shape[1] - 1))


def _ref_lane_ids(scene, sidx, slot, route_idx):
    """(current ref road's lane0/nlanes, next ref lane0, has_next) per env."""
    route_roads_e, route_len_e = _routes(scene, sidx, slot)
    kmax = route_roads_e.shape[1] - 1
    cur_road = onehot_pick(route_roads_e, torch.clamp(route_idx, 0, kmax))
    has_next = route_idx + 1 < route_len_e
    next_road = torch.where(
        has_next, onehot_pick(route_roads_e, torch.clamp(route_idx + 1, 0, kmax)), cur_road
    )
    cur = lane_geom.gather_road(scene, sidx, cur_road)
    nxt = lane_geom.gather_road(scene, sidx, next_road)
    return cur["lane0"], cur["nlanes"], nxt["lane0"], has_next


def _checkpoint_info(g, lane_num, lane_width, pos, heading):
    """One 5-dim checkpoint block (node_network_navigation.py:243-292);
    ``g`` is the ref lane's gathered row."""
    later_middle = (lane_num.float() / 2 - 0.5) * lane_width
    ckpt = lane_geom.position(g, g["length"], later_middle)
    dir_vec = ckpt - pos
    dir_norm = torch.sqrt((dir_vec ** 2).sum(-1))
    scale = torch.where(dir_norm > NAVI_POINT_DIST,
                        NAVI_POINT_DIST / torch.clamp(dir_norm, min=1e-6), 1.0)
    dir_vec = dir_vec * scale[..., None]
    hv = heading_vec(heading)
    rv = rhs_vec(heading)
    ckpt_in_heading = (dir_vec * hv).sum(-1)
    # The reference projects with BaseVehicle.convert_to_local_coordinates
    # (base_vehicle.py:986-988), whose second component is the LEFT-hand
    # side despite the "+y is the right hand side" comment at its call site.
    ckpt_in_rhs = -(dir_vec * rv).sum(-1)

    is_circ = g["kind"] == LANE_CIRCULAR
    bendradius = torch.where(
        is_circ, g["radius"] / (CURVE_RADIUS_MAX + lane_num * lane_width), 0.0,
    )
    # reference: dir = -ref_lane.direction (+1 clockwise after negation)
    dir_flag = torch.where(is_circ, -g["arc_dir"], 0.0)
    angle_deg = torch.where(is_circ, torch.rad2deg(g["angle"]), 0.0)

    return torch.stack(
        [
            clip01((ckpt_in_heading / NAVI_POINT_DIST + 1) / 2),
            clip01((ckpt_in_rhs / NAVI_POINT_DIST + 1) / 2),
            clip01(bendradius),
            clip01((dir_flag + 1) / 2),
            clip01((angle_deg / CURVE_ANGLE_MAX + 1) / 2),
        ],
        dim=-1,
    )


def checkpoint_positions(scene, sidx, slot, route_idx):
    """World positions [E,2] of the two navigation checkpoints, the
    lane-end midpoints the 2x5 navigation block aims at
    (node_network_navigation.py:243-292 get_checkpoints); the second lane
    takes the first's lane count and width, as `navi_info` does."""
    lane0, nlanes, next_lane0, has_next = _ref_lane_ids(scene, sidx, slot, route_idx)
    g1 = lane_geom.gather_lane(scene, sidx, lane0)
    later_middle = (nlanes.float() / 2 - 0.5) * g1["width"]
    ck1 = lane_geom.position(g1, g1["length"], later_middle)
    g2 = lane_geom.gather_lane(scene, sidx, torch.where(has_next, next_lane0, lane0))
    ck2 = lane_geom.position(g2, g2["length"], later_middle)
    return ck1, ck2


def navi_info(scene, sidx, slot, route_idx, pos, heading):
    """The 10-dim navigation observation block (2 checkpoints x 5)."""
    lane0, nlanes, next_lane0, has_next = _ref_lane_ids(scene, sidx, slot, route_idx)
    g1 = lane_geom.gather_lane(scene, sidx, lane0)
    lane_width = g1["width"]
    info1 = _checkpoint_info(g1, nlanes, lane_width, pos, heading)
    ref2 = torch.where(has_next, next_lane0, lane0)
    g2 = lane_geom.gather_lane(scene, sidx, ref2)
    info2 = _checkpoint_info(g2, nlanes, lane_width, pos, heading)
    return torch.cat([info1, info2], dim=-1)


def boundary_distances(scene, sidx, slot, route_idx, pos):
    """(lateral_to_left, lateral_to_right) w.r.t. the current ref road
    (reference: base_vehicle.py:488-499 update_dist_to_left_right)."""
    lane0, nlanes, _, _ = _ref_lane_ids(scene, sidx, slot, route_idx)
    g0 = lane_geom.gather_lane(scene, sidx, lane0)
    _, lat0 = lane_geom.local_coordinates(g0, pos)
    lane_width = g0["width"]
    lateral_to_left = lat0 + lane_width / 2
    total = nlanes.float() * lane_width
    lateral_to_right = total - lateral_to_left
    return lateral_to_left, lateral_to_right


def heading_diff_ref(scene, sidx, slot, route_idx, pos, heading):
    """heading_diff vs the RIGHTMOST current ref lane
    (state_obs.py:104-108 uses current_ref_lanes[-1];
    formula base_vehicle.py:528-552)."""
    lane0, nlanes, _, _ = _ref_lane_ids(scene, sidx, slot, route_idx)
    ref_last = lane0 + nlanes - 1
    g = lane_geom.gather_lane(scene, sidx, ref_last)
    # lateral (right-hand) direction of the lane at the vehicle position
    is_circ = g["kind"] == LANE_CIRCULAR
    delta = pos - g["p0"]
    # circular: ccw -> radial outward (pos - center); cw -> inward
    radial = delta * torch.sign(g["arc_dir"])[..., None]
    straight_rhs = torch.stack([g["dirv"][..., 1], -g["dirv"][..., 0]], dim=-1)
    lateral = torch.where(is_circ[..., None], radial, straight_rhs)
    lat_norm = torch.sqrt((lateral ** 2).sum(-1))
    hv = heading_vec(heading)
    cos = (hv * lateral).sum(-1) / torch.clamp(lat_norm, min=1e-6)
    return torch.clamp(cos, -1.0, 1.0) / 2 + 0.5


def arrive_destination(scene, sidx, slot, pos):
    """_is_arrive_destination (metadrive_env.py:213-227): within a 5 m
    longitudinal window of the final lane's end, laterally inside the road."""
    route_roads_e, route_len_e = _routes(scene, sidx, slot)
    last_k = torch.clamp(route_len_e - 1, min=0)
    final_road = onehot_pick(route_roads_e, last_k)
    r = lane_geom.gather_road(scene, sidx, final_road)
    lane0, nlanes = r["lane0"], r["nlanes"]
    final_lane = lane0 + nlanes - 1  # navigation.final_lane = final_lanes[-1]
    g = lane_geom.gather_lane(scene, sidx, final_lane)
    long, lat = lane_geom.local_coordinates(g, pos)
    lane_width = g["width"]
    return (
        (long > g["length"] - 5.0) & (long < g["length"] + 5.0)
        & (lat <= lane_width / 2)
        & (lat >= (0.5 - nlanes.float()) * lane_width)
    )
