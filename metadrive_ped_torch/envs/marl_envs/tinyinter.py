"""MultiAgentTinyInter: mixed rule-based and RL agents on a tiny intersection.

Reference: metadrive/envs/marl_envs/tinyinter.py —
- ``MultiAgentTinyInter`` (:328-415): a MultiAgentIntersectionEnv with a
  1-lane, 4 m wide, 30 m exit intersection where only ``num_RL_agents`` of
  the ``num_agents`` slots are controlled from outside; the env surface
  (obs, reward, done arrays) shows only the RL agents.
- ``TinyInterRuleBasedPolicy`` (:193-221): the other agents advance
  kinematically along their routing lane at a constant target speed
  (default 10 km/h), moved to lane.position(long + v*dt*decision_repeat,
  lat) with the lane's heading.
- ``MixedIDMAgentManager`` (:223-326): the RL-or-rule role is fixed by agent
  column here (a respawned agent keeps its column's role, the batched form
  of the reference's slot inheritance in refresh_agent_name_index_mapping).
- ``CommunicationObservation`` (:14-190): the state observation with
  ``num_others=0`` and a per-slot block spliced between the state vector
  and the lidar cloud: for every agent slot j, [slot_id=(j+1)/A, rel_pos_x,
  rel_pos_y, rel_vel_x, rel_vel_y], positions clipped to the lidar
  distance, velocities (m/s) to speed_scale=20, each mapped through
  (v/scale+1)/2; slots of dead agents stay 0. ``add_others_navi`` adds each
  slot's two navigation checkpoints (:174-186).
"""
import torch

from metadrive_ped_torch.core import trace
from metadrive_ped_torch.envs.marl_envs.marl_env import MultiAgentIntersectionEnv
from metadrive_ped_torch.ops import lane_geom, localization
from metadrive_ped_torch.ops.math_ops import clip01, heading_vec, rhs_vec

COMM_SPEED_SCALE = 20.0  # tinyinter.py:134 speed_scale


class MultiAgentTinyInter(MultiAgentIntersectionEnv):
    _ROW_AXES = dict(MultiAgentIntersectionEnv._ROW_AXES, _rule_rows=0)

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                num_agents=8,
                num_RL_agents=8,
                success_reward=10.0,
                out_of_road_penalty=10.0,
                crash_vehicle_penalty=10.0,
                crash_object_penalty=10.0,
                # remove dead vehicles at once (ignore_delay_done=True)
                delay_done=0,
                target_speed=10.0,   # km/h, rule-based agents
                use_communication_obs=False,
                map_config=dict(exit_length=30.0, lane_num=1, lane_width=4.0),
            ),
            allow_add_new_key=True,
        )
        return config

    def __init__(self, config=None, device=None):
        super().__init__(config, device)
        self.num_RL_agents = int(self.config["num_RL_agents"])
        assert 1 <= self.num_RL_agents <= self.agents_per_env
        if self.config["use_communication_obs"]:
            assert self.config["vehicle_config"]["lidar"]["num_others"] == 0, (
                "CommunicationObservation carries all agents; num_others must be 0"
            )
        # rows driven by the rule policy: the columns from num_RL_agents on
        col = torch.arange(self.num_envs, device=self.device) % self.agents_per_env
        self._rule_rows = col >= self.num_RL_agents

    # ---- rule-based rows: kinematic lane following ------------------------
    def _override_kinematics(self, state, ego, dt, rep):
        """TinyInterRuleBasedPolicy.act (tinyinter.py:199-221): advance the
        longitude by target_speed * dt * decision_repeat on the current
        routing lane, keep the lateral, snap the heading to the lane's at
        long + 1."""
        if self.num_RL_agents >= self.agents_per_env:
            return ego
        g = lane_geom.gather_lane(self.scene, state.sidx, ego.lane)
        long, lat = lane_geom.local_coordinates(g, ego.pos)
        inc = self.config["target_speed"] / 3.6 * dt * rep
        new_long = long + inc
        new_pos = lane_geom.position(g, new_long, lat)
        new_heading = lane_geom.heading_theta_at(g, new_long + 1.0)
        rule = self._rule_rows & ~self._freeze_mask(state)
        return ego.replace(
            pos=torch.where(rule[:, None], new_pos, ego.pos),
            heading=torch.where(rule, new_heading, ego.heading),
            # the reference rule policy issues [0, 0] actions, so its Bullet
            # speed decays to ~0; the effective speed is carried for the
            # relative-velocity comm features instead
            speed=torch.where(rule, inc / (dt * rep), ego.speed),
            vel_dir=torch.where(rule, 0.0, ego.vel_dir),
        )

    # ---- communication observation ---------------------------------------
    def _observe(self, state, ego_long, ego_lat):
        obs = super()._observe(state, ego_long, ego_lat)
        if not self.config["use_communication_obs"]:
            return obs
        # the communication features, beside the base observation's
        with trace.stage("observe.features", self.device):
            E, A = self.num_marl_envs, self.agents_per_env
            lidar_cfg = self.config["vehicle_config"]["lidar"]
            dist = lidar_cfg["distance"]
            EA = self._rows_to_EA
            ego = state.ego
            pos, heading = EA(ego.pos), EA(ego.heading)                        # [E,A,2], [E,A]
            move = EA(ego.heading + ego.vel_dir)
            vel = EA(ego.speed)[..., None] * torch.stack([torch.cos(move), torch.sin(move)], dim=-1)
            active = EA(state.dead_timer == 0)

            # every row against every slot of its env, in the row's frame with a
            # left-positive lateral axis (the comm slots follow lidar.py's
            # get_surrounding_vehicles_info projections, base_vehicle.py:986-988)
            hv = heading_vec(heading)[:, :, None, :]                           # [E,Aego,1,2]
            lv = -rhs_vec(heading)[:, :, None, :]

            def in_frame(rel, limit):
                return _clip_norm(torch.stack([(rel * hv).sum(-1), (rel * lv).sum(-1)], dim=-1),
                                  limit)

            rel_pos = in_frame(pos[:, None, :, :] - pos[:, :, None, :], dist)  # [E,Aego,Aother,2]
            rel_vel = in_frame(vel[:, None, :, :] - vel[:, :, None, :], COMM_SPEED_SCALE)
            slot_id = (torch.arange(A, device=self.device) + 1.0) / A
            parts = [slot_id[None, None, :, None].expand(E, A, A, 1),
                     clip01((rel_pos / dist + 1) / 2),
                     clip01((rel_vel / COMM_SPEED_SCALE + 1) / 2)]
            if lidar_cfg.get("add_others_navi"):
                # each slot also sends its two navigation checkpoints
                for ck in localization.checkpoint_positions(self.scene, state.sidx, ego.slot,
                                                            ego.route_idx):
                    rel_ck = in_frame(EA(ck)[:, None, :, :] - pos[:, :, None, :], dist)
                    parts.append(clip01((rel_ck / dist + 1) / 2))
            feats = torch.where(active[:, None, :, None], torch.cat(parts, dim=-1), 0.0)
            comm = feats.reshape(E * A, -1)

        # spliced between the state vector and the lidar cloud
        # (lidar_observe: other_v_info = global_info + cloud_points)
        cut = obs.shape[1] - lidar_cfg["num_lasers"]
        return torch.cat([obs[:, :cut], comm, obs[:, cut:]], dim=-1)

    @property
    def observation_dim(self):
        d = super().observation_dim
        if self.config["use_communication_obs"]:
            res = 9 if self.config["vehicle_config"]["lidar"].get("add_others_navi") else 5
            d += self.agents_per_env * res
        return d

    # ---- RL-only env surface (filter_RL_agents, tinyinter.py:374-395):
    #      `step` takes actions [E, num_RL_agents, 2]; the rule rows get
    #      zeros ------------------------------------------------------------
    def _reset_outputs(self, obs, info):
        obs, info = super()._reset_outputs(obs, info)
        return obs[:, :self.num_RL_agents], info

    def _step_actions(self, actions):
        E, K, A = self.num_marl_envs, self.num_RL_agents, self.agents_per_env
        full = torch.zeros((E, A, 2), device=self.device)
        full[:, :K] = self._as_tensor(actions, torch.float32).reshape(E, K, 2)
        return super()._step_actions(full)

    def _step_outputs(self, obs, reward, terminated, truncated, info):
        obs, reward, terminated, truncated, info = super()._step_outputs(
            obs, reward, terminated, truncated, info)
        E, K, A = self.num_marl_envs, self.num_RL_agents, self.agents_per_env
        rl = lambda x: x[:, :K] if torch.is_tensor(x) and x.dim() >= 2 and tuple(x.shape[:2]) == (E, A) else x
        info = {k: rl(v) for k, v in info.items()}
        info["__all__"] = (terminated[:, :K] | truncated[:, :K]).all(dim=1)
        return obs[:, :K], reward[:, :K], terminated[:, :K], truncated[:, :K], info


def _clip_norm(vec, max_norm):
    """Scale vectors longer than max_norm down to it (_process_norm,
    tinyinter.py:124-129)."""
    n = torch.sqrt((vec ** 2).sum(-1, keepdim=True))
    return torch.where(n > max_norm, vec / torch.clamp(n, min=1e-9) * max_norm, vec)
