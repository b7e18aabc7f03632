"""Batched state + lidar observation assembly.

Reproduces the reference's LidarStateObservation layout
(metadrive/obs/state_obs.py):

  [0:2]    lateral distance to route left/right boundary, / ((MAX_LANE_NUM+1)
           * MAX_LANE_WIDTH) = /18 (state_obs.py:90-98; base_map.py:38-40)
  [2]      heading_diff vs rightmost current ref lane (state_obs.py:104-108)
  [3]      (speed_km_h + 1) / (max_speed_km_h + 1)        (state_obs.py:111)
  [4]      (steering/MAX_STEERING + 1) / 2, MAX_STEERING=60 (state_obs.py:114)
  [5:7]    (last action + 1)/2 — the action applied this step
           (state_obs.py:117-118 reads last_current_action[1])
  [7]      yaw rate = arccos(clip(cos<heading_t, heading_{t-1}>,0,1))/0.1
           (state_obs.py:121-127)
  [8]      (lateral*2/MAX_LANE_WIDTH + 1)/2 on the current lane
           (state_obs.py:142-149)
  [9:19]   navigation 2x5 (node_network_navigation.py:243-292)
  [19:19+num_lasers]  lidar hit fractions (state_obs.py:210-232)

The side detector's cloud replaces [0:2] and the lane-line detector's cloud
replaces [8] when they are on.
"""
import math

import torch

from metadrive_ped_torch.constants import OBS_MAX_STEERING
from metadrive_ped_torch.core import prng, trace
from metadrive_ped_torch.ops import localization, raycast
from metadrive_ped_torch.ops.gather import nearest_k_onehot
from metadrive_ped_torch.ops.math_ops import clip01, heading_vec, wrap_to_pi

TOTAL_SIDE_WIDTH = (3 + 1) * 4.5  # (MAX_LANE_NUM+1)*MAX_LANE_WIDTH = 18
MAX_LANE_WIDTH = 4.5
# BaseVehicle.MAX_LENGTH / MAX_WIDTH (base_vehicle.py:78-79), the
# random_agent_model size-feature normalizers
MAX_VEHICLE_LENGTH = 10.0
MAX_VEHICLE_WIDTH = 2.5

EGO_STATE_DIM = 9
NAVI_DIM = 10


def obs_dim(num_lasers, num_others=0, side_lasers=0, lane_line_lasers=0,
            random_agent_model=False):
    """Observation width. Mirrors StateObservation.get_line_detector_dim
    (state_obs.py:153-159): side-detector cloud replaces the 2 lateral
    road-border features, lane-line cloud replaces the 1 lateral-offset
    feature; random_agent_model prepends vehicle length/width
    (state_obs.py:69-75)."""
    ego = EGO_STATE_DIM
    if side_lasers > 0:
        ego += side_lasers - 2
    if lane_line_lasers > 0:
        ego += lane_line_lasers - 1
    if random_agent_model:
        ego += 2
    return ego + NAVI_DIM + num_others * 4 + num_lasers


def surrounding_vehicles_info(ego, npc, num_others, perceive_distance):
    """4 features per nearest-K NPC vehicle: relative position and relative
    velocity (km/h), both projected into the ego frame and normalized
    (reference: lidar.py:93-138 get_surrounding_vehicles_info)."""
    delta = npc.pos - ego.pos[:, None, :]                      # [E,N,2]
    dist = torch.sqrt((delta ** 2).sum(-1))
    dist = torch.where(npc.active, dist, torch.inf)
    k = min(num_others, dist.shape[1])  # fewer NPC slots than K -> pad below
    oh, found_k = nearest_k_onehot(dist, k)                    # [E,K,N], [E,K]
    # one-hot row sums pick exactly one element (no matmul, so no TF32)
    sel = lambda a: (oh * a[:, None, :]).sum(-1)
    sel_dist = sel(torch.where(torch.isfinite(dist), dist, 0.0))
    found = found_k & (sel_dist <= perceive_distance)

    hv = heading_vec(ego.heading)                              # [E,2]
    # lateral axis = LEFT-positive: the reference projects neighbours with
    # convert_to_local_coordinates (lidar.py:108,114 -> base_vehicle.py:
    # 986-988), whose second component is the left-hand side
    rv = torch.stack([-hv[..., 1], hv[..., 0]], dim=-1)
    dx = sel(delta[..., 0])
    dy = sel(delta[..., 1])
    rel_x = dx * hv[:, None, 0] + dy * hv[:, None, 1]
    rel_y = dx * rv[:, None, 0] + dy * rv[:, None, 1]

    move_dir = npc.heading + npc.vel_dir
    ego_move = ego.heading + ego.vel_dir
    vx = npc.speed * 3.6 * torch.cos(move_dir) - (ego.speed * 3.6 * torch.cos(ego_move))[:, None]
    vy = npc.speed * 3.6 * torch.sin(move_dir) - (ego.speed * 3.6 * torch.sin(ego_move))[:, None]
    rvx = sel(vx) * hv[:, None, 0] + sel(vy) * hv[:, None, 1]
    rvy = sel(vx) * rv[:, None, 0] + sel(vy) * rv[:, None, 1]

    vmax = ego.params.max_speed_kmh[:, None]
    feats = torch.stack(
        [
            clip01((rel_x / perceive_distance + 1) / 2),
            clip01((rel_y / perceive_distance + 1) / 2),
            clip01((rvx / vmax + 1) / 2),
            clip01((rvy / vmax + 1) / 2),
        ],
        dim=-1,
    )  # [E,K,4]
    feats = torch.where(found[..., None], feats, 0.0)
    E = feats.shape[0]
    feats = feats.reshape(E, k * 4)
    if k < num_others:
        feats = torch.cat([feats, feats.new_zeros((E, (num_others - k) * 4))], dim=-1)
    return feats


def ego_core(scene, sidx, ego):
    """The six core ego features [E,6]: heading difference to the route,
    speed, steering, the two action components and the yaw rate
    (state_obs.py:104-127)."""
    speed_kmh = ego.speed * 3.6
    f_speed = clip01((speed_kmh + 1) / (ego.params.max_speed_kmh + 1))
    f_steer = clip01((ego.steering / OBS_MAX_STEERING + 1) / 2)
    f_act0 = clip01((ego.current_action[:, 0] + 1) / 2)
    f_act1 = clip01((ego.current_action[:, 1] + 1) / 2)

    # yaw rate: arccos(clip(<h_t, h_t-1>, 0, 1)) / 0.1 (state_obs.py:121-127),
    # written as min(|wrap(dh)|, pi/2) / 0.1, which is the same function. In
    # float32 the arccos form turns a 1-ulp error of the dot product near 1
    # into up to 3.5e-3 of the feature; this form does not.
    dh = torch.abs(wrap_to_pi(ego.heading - ego.last_heading))
    f_yaw = clip01(torch.clamp(dh, max=math.pi / 2) / 0.1)

    hdiff = localization.heading_diff_ref(scene, sidx, ego.slot, ego.route_idx, ego.pos, ego.heading)
    return torch.stack([hdiff, f_speed, f_steer, f_act0, f_act1, f_yaw], dim=-1)


def observe(scene, sidx, ego, targets, ego_long, ego_lat, num_lasers=240, lidar_distance=50.0,
            num_others=0, npc=None, gaussian_noise=0.0, dropout_prob=0.0, rng=None,
            row_offset=0, side_lasers=0, side_distance=50.0,
            lane_line_lasers=0, lane_line_distance=20.0, line_table=None,
            random_agent_model=False, t_radius=None, circle_slice=None):
    """Full observation [E, obs_dim]. ego_long/ego_lat are the current-lane
    local coordinates already computed by localization; ``targets`` =
    (pos, heading, length, width, active) [E,T,...] of every lidar-visible
    body (vehicles + traffic objects + participants, the reference lidar
    mask, lidar.py:28); num_others>0 adds nearest-K vehicle features (needs
    npc). ``gaussian_noise`` / ``dropout_prob`` perturb the lidar cloud with
    draws from the key ``rng`` (LidarStateObservation
    _add_noise_to_cloud_points, state_obs.py:234-244); the rows are rows
    [row_offset, row_offset + E) of the batch, and draw that part of the
    batch's [rows, num_lasers] noise.

    side_lasers/lane_line_lasers > 0 switch the lateral features to detector
    clouds against the lane-line segments, matching the reference's
    SideDetector (ContinuousLaneLine mask, distance_detector.py:194) and
    LaneLineDetector (both line masks, :209), both from one launch;
    ``line_table`` = (table, counts) of `ray_segment.build_line_table`."""
    device = ego.pos.device
    with trace.stage("observe.features", device):
        core = ego_core(scene, sidx, ego)
        pieces = []
        if random_agent_model:
            pieces.append(torch.stack(
                [clip01(ego.params.length / MAX_VEHICLE_LENGTH),
                 clip01(ego.params.width / MAX_VEHICLE_WIDTH)], dim=-1))
        if side_lasers > 0 or lane_line_lasers > 0:
            side_cloud, lane_cloud = raycast.detector_clouds(
                ego.pos, ego.heading, sidx, (side_lasers, side_distance),
                (lane_line_lasers, lane_line_distance), *line_table)
        if side_lasers > 0:
            pieces.append(side_cloud)
        else:
            left, right = localization.boundary_distances(
                scene, sidx, ego.slot, ego.route_idx, ego.pos)
            pieces.append(torch.stack(
                [clip01(left / TOTAL_SIDE_WIDTH), clip01(right / TOTAL_SIDE_WIDTH)], dim=-1))
        pieces.append(core)
        if lane_line_lasers > 0:
            pieces.append(lane_cloud)
        else:
            pieces.append(clip01((ego_lat * 2 / MAX_LANE_WIDTH + 1) / 2)[:, None])
        ego_state = torch.cat(pieces, dim=-1)

        navi = localization.navi_info(scene, sidx, ego.slot, ego.route_idx, ego.pos, ego.heading)

        parts = [ego_state, navi]
        if num_others > 0:
            parts.append(surrounding_vehicles_info(ego, npc, num_others, lidar_distance))
    # lidar-off configs skip the cloud entirely, like the reference's
    # LidarStateObservation (state_obs.py:210-232)
    if num_lasers > 0:
        with trace.stage("observe.lidar", device):
            t_pos, t_heading, t_len, t_wid, t_active = targets
            cloud = raycast.lidar_cloud(
                ego.pos, ego.heading, num_lasers, lidar_distance,
                t_pos, t_heading, t_len, t_wid, t_active, radius=t_radius,
                circle_slice=circle_slice,
            )
            if (gaussian_noise > 0 or dropout_prob > 0) and rng is not None:
                k_noise, k_drop = prng.split(rng).unbind(-2)
                at = row_offset * num_lasers
                if gaussian_noise > 0:
                    cloud = torch.clamp(
                        cloud + gaussian_noise * prng.normal(k_noise, cloud.shape, at), 0.0, 1.0)
                if dropout_prob > 0:
                    cloud = torch.where(
                        prng.uniform(k_drop, cloud.shape, offset=at) < dropout_prob, 0.0, cloud)
        parts.append(cloud)
    return torch.cat(parts, dim=-1)
