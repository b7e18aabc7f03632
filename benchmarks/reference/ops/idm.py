"""Vectorized IDM traffic policy + NPC advancement.

Replaces the per-NPC Python IDMPolicy loop (policy/idm_policy.py:177-402)
with batched ops over the NPC slot axis [E, N]:

- route following: an NPC whose longitudinal position passes its target
  lane's end hops to `lane_succ`; with no successor it deactivates
  (reference NPCs despawn at route end, traffic_manager.py:94-122).
- longitudinal control: IDM acceleration with the reference's constants and
  (deliberately reproduced) km/h unit mix (idm_policy.py:303-325).
- lateral control: heading PID + lateral PID onto the target lane
  (idm_policy.py:293-301; PID form PID_controller.py:10-21).
- overtake lane changes: the reference's speed-motivated change with
  left-priority and front/back safety margins (lane_change_policy,
  idm_policy.py:330-402), driven by a staggered overtake timer.
- respawn mode recycles arrived NPCs back onto their spawn slot when clear
  (traffic_manager.py:94-122).
Front/back gap search projects every other vehicle onto the candidate lane
(FrontBackObjects, idm_policy.py:10-174).
"""
import torch

from benchmarks.reference.ops import dynamics, lane_geom
from benchmarks.reference.ops.math_ops import wrap_to_pi

# reference: idm_policy.py:183-221
NORMAL_SPEED = 30.0        # km/h
ACC_FACTOR = 1.0
DEACC_FACTOR = -5.0
DELTA = 10.0
DISTANCE_WANTED = 10.0
TIME_WANTED = 1.5
MAX_LONG_DIST = 30.0
LANE_CHANGE_FREQ = 50            # idm_policy.py:208
LANE_CHANGE_SPEED_INCREASE = 10  # km/h
SAFE_LANE_CHANGE_DISTANCE = 15.0
MAX_SPEED = 100.0                # km/h, free-lane optimistic speed
CREEP_SPEED = 5.0                # km/h (idm_policy.py:218)
# PID gains (idm_policy.py:233-234)
HEADING_PID = (1.7, 0.01, 3.5)
LATERAL_PID = (0.3, 0.002, 0.05)


def _pid(gains, err, i_state, prev_err):
    """Incremental PID (PID_controller.py:10-21); returns (out, i, prev)."""
    kp, ki, kd = gains
    i_state = i_state + err
    d = err - prev_err
    out = -(kp * err + ki * i_state + kd * d)
    return out, i_state, err


def idm_acceleration(speed_kmh, front_speed_kmh, front_dist, has_front,
                     target_speed_kmh=NORMAL_SPEED):
    """IDM longitudinal model (idm_policy.py:303-325), km/h units as-is.
    target_speed drops to CREEP_SPEED while waiting for a forced lane
    change (idm_policy.py:354,367)."""
    v0 = target_speed_kmh
    acc = ACC_FACTOR * (1.0 - torch.pow(torch.clamp(speed_kmh, min=0.0) / v0, DELTA))
    ab = -ACC_FACTOR * DEACC_FACTOR
    dv = speed_kmh - front_speed_kmh
    d_star = DISTANCE_WANTED + speed_kmh * TIME_WANTED + speed_kmh * dv / (2 * ab ** 0.5)
    d = torch.clamp(front_dist, min=1e-2)
    return acc - torch.where(has_front, ACC_FACTOR * (d_star / d) ** 2, 0.0)


def _lane_gaps(g, exists, npc_pos, cand_pos, cand_speed, cand_active, not_self):
    """Front/back gap search projected on gathered lanes ``g`` [E,N]
    (FrontBackObjects, idm_policy.py:10-174); ``exists`` [E,N] masks rows
    whose lane id was < 0. Returns (front_gap, front_speed, back_gap).

    Distances are center-to-center longitudinal deltas, the reference's
    convention (idm_policy.py:110-118)."""
    long_self, _ = lane_geom.local_coordinates(g, npc_pos)
    g_b = {k: (v[:, :, None] if v.dim() == 2 else v[:, :, None, :]) for k, v in g.items()}
    long_c, lat_c = lane_geom.local_coordinates(g_b, cand_pos[:, None, :, :])  # [E,N,C]
    on_lane = torch.abs(lat_c) < (g["width"][:, :, None] / 2)
    base_valid = on_lane & cand_active[:, None, :] & not_self & exists[:, :, None]

    ahead = long_c > long_self[:, :, None]
    fgap = long_c - long_self[:, :, None]
    fgap = torch.where(base_valid & ahead & (fgap < MAX_LONG_DIST), fgap, torch.inf)
    front_gap = fgap.amin(dim=2)
    is_front = (fgap == front_gap[..., None]) & torch.isfinite(fgap)
    front_speed = torch.where(is_front, cand_speed[:, None, :], -torch.inf).amax(dim=2)
    front_speed = torch.where(torch.isfinite(front_speed), front_speed, 0.0)

    bgap = long_self[:, :, None] - long_c
    bgap = torch.where(base_valid & ~ahead & (bgap < MAX_LONG_DIST), bgap, torch.inf)
    back_gap = bgap.amin(dim=2)
    return front_gap, front_speed, back_gap


def lane_change_decision(v_kmh, front_gap, front_speed, overtake_timer,
                         succ_exists, l_exists, r_exists, l_cont, r_cont,
                         l_front, l_front_speed, l_back,
                         r_front, r_front_speed, r_back):
    """The reference's lane_change_policy decision tree
    (idm_policy.py:330-402) as a batched function; all distances are
    center-to-center longitudinal deltas (inf = no object within
    MAX_LONG_DIST), speeds in m/s.

    Returns (go_left, go_right, creep, acc_gap, acc_front_speed,
    overtake_timer') — acc_gap/speed are the (front object, distance) pair
    the acceleration model must react to after the decision.
    """
    has_front = torch.isfinite(front_gap)
    front_kmh = front_speed * 3.6

    # forced lane change on lane drop (idm_policy.py:339-374): a lane with
    # no successor while a neighbour continues. Unsafe target side => creep.
    must_change = ~succ_exists & (l_cont | r_cont)
    want_left = must_change & l_cont
    want_right = must_change & ~l_cont & r_cont
    l_clear = (l_back >= SAFE_LANE_CHANGE_DISTANCE) & (l_front >= 5.0)
    r_clear = (r_back >= SAFE_LANE_CHANGE_DISTANCE) & (r_front >= 5.0)
    forced_left = want_left & l_clear
    forced_right = want_right & r_clear
    creep = (want_left & ~l_clear) | (want_right & ~r_clear)

    # overtake lane change (idm_policy.py:377-397)
    deviate = (
        (torch.abs(v_kmh - NORMAL_SPEED) > 3.0)
        & has_front & (torch.abs(front_kmh - NORMAL_SPEED) > 3.0)
        & (overtake_timer > LANE_CHANGE_FREQ)
        & ~must_change
    )
    # never overtake onto an ending lane while the current one continues
    l_route_ok = l_cont | ~succ_exists
    r_route_ok = r_cont | ~succ_exists
    # the reference's side-speed term (idm_policy.py:380-384): an existing
    # side-front object contributes its speed with no distance safety
    # check (quirk preserved); only the no-object MAX_SPEED term requires
    # front/back > SAFE_LANE_CHANGE_DISTANCE
    l_has_front = torch.isfinite(l_front)
    r_has_front = torch.isfinite(r_front)
    l_open = l_exists & (l_front > SAFE_LANE_CHANGE_DISTANCE) & (l_back > SAFE_LANE_CHANGE_DISTANCE)
    r_open = r_exists & (r_front > SAFE_LANE_CHANGE_DISTANCE) & (r_back > SAFE_LANE_CHANGE_DISTANCE)
    l_kmh = torch.where(l_has_front, l_front_speed * 3.6,
                        torch.where(l_open, MAX_SPEED, -torch.inf))
    r_kmh = torch.where(r_has_front, r_front_speed * 3.6,
                        torch.where(r_open, MAX_SPEED, -torch.inf))
    go_left = forced_left | (
        deviate & l_exists & l_route_ok & (l_kmh - front_kmh > LANE_CHANGE_SPEED_INCREASE)
    )
    go_right = forced_right | (
        deviate & ~go_left & r_exists & r_route_ok
        & (r_kmh - front_kmh > LANE_CHANGE_SPEED_INCREASE)
    )
    go_right = go_right & ~go_left
    changed = go_left | go_right
    overtake_timer = torch.where(changed, 0, overtake_timer + 1)
    acc_gap = torch.where(go_left, l_front, torch.where(go_right, r_front, front_gap))
    acc_front_speed = torch.where(go_left, l_front_speed,
                                  torch.where(go_right, r_front_speed, front_speed))
    return go_left, go_right, creep, acc_gap, acc_front_speed, overtake_timer


def step_npcs(scene, sidx, npc, ego, dt=0.02, substeps=5, respawn_mode=False,
              expert_actions=None, expert_mask=None, light_block=None, extra_bodies=None):
    """One env-step of all NPCs: IDM + lane change + dynamics + routing.

    expert_actions [E,N,2] + expert_mask [E,N]: MixedPGTrafficManager, the
    masked slots drive with the expert's actions instead of IDM
    (traffic_manager.py:403-409; built by ops/mixed_traffic.py).

    light_block = (light_lane [E,LG], light_long [E,LG], stop [E,LG]): red
    traffic lights act as a stationary front body at the stop line of their
    lane (the reference's light is a physical air wall across the lane,
    base_traffic_light.py:45-51), so IDM traffic queues at red.

    ego may be None (multi-agent envs step traffic once per env, not per
    agent row); extra_bodies = (pos [E,X,2], speed [E,X], length [E,X],
    active [E,X]) adds further vehicles the NPCs react to (all the agents).
    Gaps are center to center, so length goes unused."""
    E, N = npc.lane.shape
    pos_l, speed_l, act_l = [npc.pos], [npc.speed], [npc.active]
    if ego is not None:
        pos_l.append(ego.pos[:, None, :])
        speed_l.append(ego.speed[:, None])
        act_l.append(torch.ones((E, 1), dtype=torch.bool, device=npc.active.device))
    if extra_bodies is not None:
        x_pos, x_speed, _, x_act = extra_bodies
        pos_l.append(x_pos)
        speed_l.append(x_speed)
        act_l.append(x_act)
    cand_pos = torch.cat(pos_l, dim=1)                                     # [E,C,2]
    cand_speed = torch.cat(speed_l, dim=1)
    cand_active = torch.cat(act_l, dim=1)
    C = cand_pos.shape[1]
    not_self = ~torch.eye(N, C, dtype=torch.bool, device=cand_pos.device)[None]

    # one joined lookup yields the NPC's own lane row and its left/right
    # neighbours' gap-search geometry + successor ids
    g, gL, gR = lane_geom.gather_lane_with_neighbors(scene, sidx[:, None], npc.lane)
    gaps = lambda geom, exists: _lane_gaps(
        geom, exists, npc.pos, cand_pos, cand_speed, cand_active, not_self,
    )
    l_exists = g["left"] >= 0
    r_exists = g["right"] >= 0
    front_gap, front_speed, _ = gaps(g, npc.lane >= 0)
    l_front, l_front_speed, l_back = gaps(gL, l_exists)
    r_front, r_front_speed, r_back = gaps(gR, r_exists)

    v_kmh = npc.speed * 3.6
    l_cont = l_exists & (gL["succ"] >= 0)
    r_cont = r_exists & (gR["succ"] >= 0)
    (go_left, go_right, creep, acc_gap, acc_front_speed,
     overtake_timer) = lane_change_decision(
        v_kmh, front_gap, front_speed, npc.overtake_timer,
        succ_exists=g["succ"] >= 0,
        l_exists=l_exists, r_exists=r_exists, l_cont=l_cont, r_cont=r_cont,
        l_front=l_front, l_front_speed=l_front_speed, l_back=l_back,
        r_front=r_front, r_front_speed=r_front_speed, r_back=r_back,
    )
    if expert_mask is not None:
        # expert slots steer themselves: no IDM lane change moves their lane
        # bookkeeping (it tracks the body, below)
        go_left = go_left & ~expert_mask
        go_right = go_right & ~expert_mask
    target = torch.where(go_left, g["left"], torch.where(go_right, g["right"], npc.lane))
    acc_has_front = torch.isfinite(acc_gap)

    gt = lane_geom.gather_lane(scene, sidx[:, None], target)
    t_long, t_lat = lane_geom.local_coordinates(gt, npc.pos)

    if light_block is not None:
        # a red light on my target lane ahead = a parked body at the stop
        # line: fold it into the front gap so IDM brakes and queues
        l_lane, l_long, l_stop = light_block
        same = (l_lane[:, None, :] == target[:, :, None]) & l_stop[:, None, :]
        dist_stop = l_long[:, None, :] - t_long[..., None]            # [E,N,LG]
        dist_stop = torch.where(same & (dist_stop > 0), dist_stop, torch.inf)
        light_gap = dist_stop.amin(dim=2) - npc.params.length / 2
        closer = light_gap < torch.where(acc_has_front, acc_gap, torch.inf)
        acc_gap = torch.where(closer, light_gap, acc_gap)
        acc_front_speed = torch.where(closer, 0.0, acc_front_speed)
        acc_has_front = acc_has_front | torch.isfinite(light_gap)

    acc = idm_acceleration(
        v_kmh, acc_front_speed * 3.6, torch.where(acc_has_front, acc_gap, 1e6), acc_has_front,
        target_speed_kmh=torch.where(creep, CREEP_SPEED, NORMAL_SPEED),
    )

    # steering PID toward the (possibly new) target lane
    lane_heading = lane_geom.heading_theta_at(gt, t_long + 1.0)
    herr = -wrap_to_pi(lane_heading - npc.heading)
    steer_h, h_i, h_e = _pid(HEADING_PID, herr, npc.heading_pid_i, npc.heading_pid_e)
    steer_l, l_i, l_e = _pid(LATERAL_PID, -t_lat, npc.lateral_pid_i, npc.lateral_pid_e)
    steering = steer_h + steer_l

    moving = npc.active & npc.released
    steering = torch.clamp(torch.where(moving, steering, 0.0), -1.0, 1.0)
    throttle = torch.clamp(torch.where(moving, acc, 0.0), -1.0, 1.0)
    if expert_actions is not None and expert_mask is not None:
        use_exp = expert_mask & moving
        steering = torch.where(use_exp, expert_actions[..., 0], steering)
        throttle = torch.where(use_exp, expert_actions[..., 1], throttle)

    pos, heading, speed, vel_dir = dynamics.step_vehicle(
        npc.pos, npc.heading, npc.speed, npc.vel_dir, steering, throttle,
        npc.params, dt=dt, substeps=substeps, enable_reverse=False,
    )
    # frozen NPCs keep their state exactly
    pos = torch.where(moving[..., None], pos, npc.pos)
    heading = torch.where(moving, heading, npc.heading)
    speed = torch.where(moving, speed, npc.speed)
    vel_dir = torch.where(moving, vel_dir, npc.vel_dir)

    # route advance / arrival (traffic_manager.py:94-122)
    long2, lat2 = lane_geom.local_coordinates(gt, pos)
    passed = long2 > gt["length"]
    succ = gt["succ"]
    new_lane = torch.where(passed & (succ >= 0), succ, target)
    at_end = passed & (succ < 0) & moving
    if expert_mask is not None:
        # expert slots change lanes on their own: the lane follows the body
        # by its lateral offset (positive = right of the centre line), like
        # the reference's per-step ray localization of every vehicle
        drift_r = (lat2 > gt["width"] / 2) & (g["right"] >= 0)
        drift_l = (lat2 < -gt["width"] / 2) & (g["left"] >= 0)
        reassign = torch.where(drift_r, g["right"], torch.where(drift_l, g["left"], target))
        new_lane = torch.where(expert_mask & ~passed & moving, reassign, new_lane)

    if respawn_mode:
        # respawn at the original spawn slot when it is clear
        # (traffic_manager.py:94-122 _create_respawn_vehicles recycling)
        s = sidx.long()
        spawn_pos = scene.npc_spawn_pos[s]
        d2 = ((spawn_pos[:, :, None, :] - cand_pos[:, None, :, :]) ** 2).sum(-1)
        clear = torch.where(cand_active[:, None, :], d2, torch.inf).amin(dim=2) > 8.0 ** 2
        do = at_end & clear
        keep_dead = at_end & ~clear
        pos = torch.where(do[..., None], spawn_pos, pos)
        heading = torch.where(do, scene.npc_spawn_heading[s], heading)
        speed = torch.where(do, 0.0, speed)
        vel_dir = torch.where(do, 0.0, vel_dir)
        new_lane = torch.where(do, scene.npc_lane[s], new_lane)
        active = npc.active & ~keep_dead
        overtake_timer = torch.where(do, 0, overtake_timer)
    else:
        active = npc.active & ~at_end

    return npc.replace(
        pos=pos, heading=heading, speed=speed, vel_dir=vel_dir,
        lane=new_lane, active=active, overtake_timer=overtake_timer,
        heading_pid_i=torch.where(moving, h_i, npc.heading_pid_i),
        heading_pid_e=torch.where(moving, h_e, npc.heading_pid_e),
        lateral_pid_i=torch.where(moving, l_i, npc.lateral_pid_i),
        lateral_pid_e=torch.where(moving, l_e, npc.lateral_pid_e),
    )
