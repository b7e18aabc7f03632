"""Expert-driven NPC traffic (MixedPGTrafficManager).

Reference: metadrive/manager/traffic_manager.py:367-418. With probability
``rl_agent_ratio`` a spawned traffic vehicle is driven by ExpertPolicy (the
released PPO checkpoint) instead of IDMPolicy (the scene pack's
``npc_expert``). The expert reads the 275-dim LidarStateObservation, so
every NPC slot gets that observation, built batched over the [E, N] slot
grid from its lane frame:

  boundary distances / lateral / heading diff  -> its current road
  navigation 2x5                               -> the end of its road's
                                                  first lane and of the
                                                  successor road's
  nearest-4 vehicle features + 240-ray lidar   -> against the other NPCs
                                                  and the ego

As in the JAX package, NPCs keep no action or heading history: the
last-action dims are a neutral 0.5 and the yaw-rate dim is 0; the NPC
lidar sees vehicles only.

Every slot runs the MLP, and `idm.step_npcs` blends the expert slots in by
the mask: no shape depends on the data. The per-NPC lidar is the heavy
part: [E*N, rays, N+1] ray-box tests, one launch of a hand-written kernel
on the card (ops/npc_lidar.py).
"""
import torch

from metadrive_ped_torch.constants import LANE_CIRCULAR
from metadrive_ped_torch.ops import lane_geom, localization
from metadrive_ped_torch.ops import npc_lidar as npc_lidar_op
from metadrive_ped_torch.ops.gather import nearest_k_index
from metadrive_ped_torch.ops.math_ops import clip01, heading_vec, rhs_vec
from metadrive_ped_torch.policies.expert import expert_action

TOTAL_SIDE_WIDTH = 18.0  # (MAX_LANE_NUM+1)*MAX_LANE_WIDTH (state_obs.py:90-98)
MAX_LANE_WIDTH = 4.5


def road_frame_features(scene, sidx, npc):
    """The 9 state features [E,N,9] and the 10 navigation features [E,N,10]
    of every NPC slot."""
    E, N = npc.lane.shape
    g = lane_geom.gather_lane(scene, sidx, npc.lane)
    road = lane_geom.gather_road(scene, sidx, g["road"])
    lane0, nlanes = road["lane0"], road["nlanes"]
    g0 = lane_geom.gather_lane(scene, sidx, lane0)
    _, lat0 = lane_geom.local_coordinates(g0, npc.pos)
    w = g0["width"]
    left = lat0 + w / 2
    right = nlanes.float() * w - left

    # heading difference to the road's rightmost lane
    # (localization.heading_diff_ref, per slot)
    gl = lane_geom.gather_lane(scene, sidx, lane0 + nlanes - 1)
    radial = (npc.pos - gl["p0"]) * torch.sign(gl["arc_dir"])[..., None]
    straight_rhs = torch.stack([gl["dirv"][..., 1], -gl["dirv"][..., 0]], dim=-1)
    lateral_dir = torch.where((gl["kind"] == LANE_CIRCULAR)[..., None], radial, straight_rhs)
    lat_norm = torch.sqrt((lateral_dir ** 2).sum(-1))
    hv = heading_vec(npc.heading)
    hdiff = torch.clamp((hv * lateral_dir).sum(-1) / torch.clamp(lat_norm, min=1e-6), -1, 1) / 2 + 0.5

    f_speed = clip01((npc.speed * 3.6 + 1) / (npc.params.max_speed_kmh + 1))
    half = torch.full((E, N), 0.5, device=npc.pos.device)
    _, lat_cur = lane_geom.local_coordinates(g, npc.pos)
    f_lat = clip01((lat_cur * 2 / MAX_LANE_WIDTH + 1) / 2)
    state = torch.stack([clip01(left / TOTAL_SIDE_WIDTH), clip01(right / TOTAL_SIDE_WIDTH), hdiff,
                         f_speed, half, half, half, torch.zeros_like(half), f_lat], dim=-1)

    # navigation: this road's end, then the successor road's end
    info1 = localization._checkpoint_info(g0, nlanes, w, npc.pos, npc.heading)
    succ_road = lane_geom.gather_lane(scene, sidx, g0["succ"])["road"]
    next_lane0 = lane_geom.gather_road(scene, sidx, succ_road)["lane0"]
    g2 = lane_geom.gather_lane(scene, sidx, torch.where(g0["succ"] >= 0, next_lane0, lane0))
    info2 = localization._checkpoint_info(g2, nlanes, w, npc.pos, npc.heading)
    return state, torch.cat([info1, info2], dim=-1)


def vehicle_candidates(npc, ego):
    """Every vehicle an NPC sees: the N NPC slots and then the ego, as
    (pos [E,C,2], heading, length, width, active, speed, moving direction)
    [E,C], C = N + 1."""
    cat = lambda a, b: torch.cat([a, b[:, None]], dim=1)
    return (cat(npc.pos, ego.pos), cat(npc.heading, ego.heading),
            cat(npc.params.length, ego.params.length), cat(npc.params.width, ego.params.width),
            cat(npc.active, torch.ones_like(ego.speed, dtype=torch.bool)),
            cat(npc.speed, ego.speed), cat(npc.heading + npc.vel_dir, ego.heading + ego.vel_dir))


def nearest_vehicle_features(npc, cand, num_others, distance):
    """4 features [E,N,num_others*4] for each of the nearest num_others
    vehicles of every slot (lidar.py:93-138): relative position and
    velocity in the slot's frame, lateral axis left-positive."""
    E, N = npc.lane.shape
    c_pos, _, _, _, c_active, c_speed, c_move = cand
    C = c_pos.shape[1]
    not_self = ~torch.eye(N, C, dtype=torch.bool, device=c_pos.device)[None]
    delta = c_pos[:, None, :, :] - npc.pos[:, :, None, :]                  # [E,N,C,2]
    dist = torch.sqrt((delta ** 2).sum(-1))
    dist = torch.where(c_active[:, None, :] & not_self, dist, torch.inf)
    K = min(num_others, C)
    idx, found = nearest_k_index(dist, K)                                # [E,N,K]
    pick = lambda a: a.gather(-1, idx)                                   # [E,N,C] -> [E,N,K]
    found = found & (pick(dist) <= distance)
    hv = heading_vec(npc.heading)[..., None, :]                          # [E,N,1,2]
    rv = -rhs_vec(npc.heading)[..., None, :]
    dx, dy = pick(delta[..., 0]), pick(delta[..., 1])
    rel_x = dx * hv[..., 0] + dy * hv[..., 1]
    rel_y = dx * rv[..., 0] + dy * rv[..., 1]
    own = lambda f: (npc.speed * 3.6 * f(npc.heading + npc.vel_dir))[..., None]
    vel = lambda f: pick((c_speed * 3.6 * f(c_move))[:, None, :].expand(E, N, C))
    dvx, dvy = vel(torch.cos) - own(torch.cos), vel(torch.sin) - own(torch.sin)
    rvx = dvx * hv[..., 0] + dvy * hv[..., 1]
    rvy = dvx * rv[..., 0] + dvy * rv[..., 1]
    vmax = npc.params.max_speed_kmh[..., None]
    feats = torch.stack([clip01((rel_x / distance + 1) / 2), clip01((rel_y / distance + 1) / 2),
                         clip01((rvx / vmax + 1) / 2), clip01((rvy / vmax + 1) / 2)], dim=-1)
    feats = torch.where(found[..., None], feats, 0.0).reshape(E, N, K * 4)
    if K < num_others:
        feats = torch.cat([feats, feats.new_zeros((E, N, (num_others - K) * 4))], dim=-1)
    return feats


def npc_lidar(npc, cand, num_lasers, distance):
    """The lidar cloud [E,N,num_lasers] of every NPC slot against the other
    vehicles: one ray fan per slot over [E*N, num_lasers, C] ray-box tests,
    one launch of the per-NPC lidar kernel on the card (ops/npc_lidar.py)."""
    return npc_lidar_op.npc_lidar(*cand[:5], npc.lane.shape[1], num_lasers, distance)


def expert_npc_actions(scene, sidx, npc, ego, params, num_lasers=240, distance=50.0,
                       num_others=4):
    """Batched ExpertPolicy actions of every NPC slot -> [E, N, 2]."""
    E, N = npc.lane.shape
    state, navi = road_frame_features(scene, sidx, npc)
    cand = vehicle_candidates(npc, ego)
    obs = torch.cat([state, navi, nearest_vehicle_features(npc, cand, num_others, distance),
                     npc_lidar(npc, cand, num_lasers, distance)], dim=-1)     # [E,N,275]
    actions = expert_action(params, obs.reshape(E * N, -1)).reshape(E, N, 2)
    return torch.clamp(actions, -1.0, 1.0)
