"""Multi-agent tollgate scene.

Reference: metadrive/envs/marl_envs/marl_tollgate.py — a fixed map
FirstPGBlock(3 lanes) -> Split(to 8 lanes) -> TollGate -> Merge(back to 3),
40 agents spawning at both ends. Agents must cross the toll plaza below its
3 m/s limit and stay in it for at least ``min_pass_steps`` steps; speeding
in the plaza is penalized, rushing through ends the episode as out_of_road
(StayTimeManager semantics, marl_tollgate.py:38-63, 262-268).

Observation (TollGateObservation, marl_tollgate.py:65-110): side-detector
cloud (72) + 6 core ego dims + lane-line cloud (4) + lidar (72) + 2 toll
flags = 156 dims; no navigation block. Both detector clouds come from one
launch of the ray-segment kernel over the env's line table.

The stay time is a per-agent step counter inside the toll block rather than
entry/exit timestamps (the same observable behaviour), as in the JAX
package.
"""
import torch

from metadrive_ped_torch.core import trace
from metadrive_ped_torch.envs.marl_envs.marl_env import MultiAgentMetaDrive
from metadrive_ped_torch.obs.state_obs import ego_core
from metadrive_ped_torch.ops import lane_geom, ray_segment, raycast
from metadrive_ped_torch.ops.math_ops import clip01

TOLL_BLOCK_CODE = ord("$")
BOTTLE_LENGTH = 35.0  # MATollGateMap.BOTTLE_LENGTH


class MultiAgentTollgateEnv(MultiAgentMetaDrive):
    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                num_agents=40,
                map="$",  # informational; the map is custom_blocks, set in __init__
                map_config=dict(
                    lane_width=3.5,
                    lane_num=3,
                    exit_length=70.0,
                    toll_lane_num=8,
                    toll_length=10.0,
                    custom_blocks=None,
                ),
                # the reference's MATollConfig spawn roads: the first block
                # and the negative side of the Merge block's socket road
                spawn_roads=[(">>", ">>>"), ("-3y0_1_", "-3y0_0_")],
                cross_yellow_line_done=True,
                speed_reward=0.0,
                overspeed_penalty=0.5,
                vehicle_config=dict(
                    min_pass_steps=30,  # >= 6 s inside the plaza
                    side_detector=dict(num_lasers=72, distance=20.0),
                    lane_line_detector=dict(num_lasers=4, distance=20.0),
                    lidar=dict(num_lasers=72, distance=20.0, num_others=0,
                               gaussian_noise=0.0, dropout_prob=0.0),
                ),
            ),
            allow_add_new_key=True,
        )
        return config

    def __init__(self, config=None, device=None):
        cfg = self.default_config()
        if config:
            cfg.update(config, allow_add_new_key=True)
        mc = cfg["map_config"]
        mc["custom_blocks"] = [
            dict(id="Y", config=dict(length=2.0, lane_num=mc["toll_lane_num"] - mc["lane_num"],
                                     bottle_len=BOTTLE_LENGTH)),
            dict(id="$", config=dict(length=mc["toll_length"])),
            dict(id="y", config=dict(lane_num=mc["toll_lane_num"] - mc["lane_num"],
                                     length=mc["exit_length"], bottle_len=BOTTLE_LENGTH)),
        ]
        super().__init__(cfg, device)
        # TollGateObservation casts against the scene's float segment
        # endpoints (marl_tollgate.py:100-120 in the JAX package), not the
        # int16 ones of the PG observation: the side detector sees the
        # continuous lines, the lane-line detector the broken ones too
        scene = self.scene
        self._line_table = ray_segment.build_line_table(
            scene, include_broken=True, points=(scene.seg_p0, scene.seg_p1))

    # ---- observation (TollGateObservation) --------------------------------
    @property
    def observation_dim(self):
        vc = self.config["vehicle_config"]
        return (vc["side_detector"]["num_lasers"] + 6 + vc["lane_line_detector"]["num_lasers"]
                + vc["lidar"]["num_lasers"] + vc["lidar"]["num_others"] * 4 + 2)

    def _observe(self, state, ego_long, ego_lat):
        vc = self.config["vehicle_config"]
        ego = state.ego
        side, lane, lidar = vc["side_detector"], vc["lane_line_detector"], vc["lidar"]
        with trace.stage("observe.features", self.device):
            side_cloud, lane_cloud = raycast.detector_clouds(
                ego.pos, ego.heading, state.sidx, (side["num_lasers"], side["distance"]),
                (lane["num_lasers"], lane["distance"]), *self._line_table)
            core = ego_core(self.scene, state.sidx, ego)
            # toll flags (marl_tollgate.py:96-110): inside the plaza, and
            # inside it long enough
            in_toll = self._in_toll_block(state)
            stayed = state.aux[:, 0] > vc["min_pass_steps"]
            toll = torch.stack([in_toll.float(), (in_toll & stayed).float()], dim=-1)
        with trace.stage("observe.lidar", self.device):
            (t_pos, t_heading, t_len, t_wid, t_active), _ = self._lidar_targets(state)
            cloud = raycast.lidar_cloud(ego.pos, ego.heading, lidar["num_lasers"],
                                        lidar["distance"], t_pos, t_heading, t_len, t_wid,
                                        t_active)
        return torch.cat([side_cloud, core, lane_cloud, cloud, toll], dim=-1)

    # ---- toll bookkeeping ---------------------------------------------------
    def _in_toll_block(self, state):
        g = lane_geom.gather_lane(self.scene, state.sidx, state.ego.lane)
        return g["block"] == TOLL_BLOCK_CODE

    def _pre_reward_update(self, state, loc):
        # aux0: steps spent inside the toll block this visit
        # aux1: was inside the toll block last step
        # aux2: latched "rushed through the toll too fast" flag
        aux = state.aux
        in_toll = self._in_toll_block(state)
        stay = torch.where(in_toll, aux[:, 0] + 1.0, aux[:, 0])
        exited = (aux[:, 1] > 0.5) & ~in_toll
        too_fast = exited & (stay < self.config["vehicle_config"]["min_pass_steps"])
        aux = torch.stack([torch.where(exited, 0.0, stay), in_toll.float(),
                           torch.maximum(aux[:, 2], too_fast.float()), aux[:, 3]], dim=1)
        return state.replace(aux=aux)

    # ---- reward / done ------------------------------------------------------
    def _is_out_of_road(self, ego, state=None):
        # marl_tollgate.py:240-246
        ret = ego.crash_sidewalk
        if self.config["cross_yellow_line_done"]:
            ret = ret | ego.on_yellow_line
        return ret

    def reward_function(self, state, loc, arrive, out_of_road):
        # marl_tollgate.py:193-238
        cfg = self.config
        scene, sidx, ego = self.scene, state.sidx, state.ego
        cur_road = loc["cur_road"]
        road_info = lane_geom.gather_road(scene, sidx, cur_road)
        lane_for_reward = torch.where(loc["road"] == cur_road, ego.lane, road_info["lane0"])
        g = lane_geom.gather_lane(scene, sidx, lane_for_reward)
        long_now, lateral_now = lane_geom.local_coordinates(g, ego.pos)
        long_last, _ = lane_geom.local_coordinates(g, ego.last_pos)

        if cfg["use_lateral_reward"]:
            lateral_factor = clip01(1 - 2 * torch.abs(lateral_now) / g["width"])
        else:
            lateral_factor = 1.0
        reward = cfg["driving_reward"] * (long_now - long_last) * lateral_factor

        speed_kmh = ego.speed * 3.6
        overspeed = speed_kmh > g["speed_limit"] * 3.6
        toll_reward = torch.where(
            overspeed, -cfg["overspeed_penalty"] * speed_kmh / ego.params.max_speed_kmh, reward)
        cruise_reward = reward + cfg["speed_reward"] * (speed_kmh / ego.params.max_speed_kmh)
        reward = torch.where(self._in_toll_block(state), toll_reward, cruise_reward)
        step_reward = reward

        reward = torch.where(
            arrive, cfg["success_reward"],
            torch.where(
                out_of_road, -cfg["out_of_road_penalty"],
                torch.where(
                    ego.crash_vehicle, -cfg["crash_vehicle_penalty"],
                    torch.where(ego.crash_object, -cfg["crash_object_penalty"], reward),
                ),
            ),
        )
        return reward, dict(step_reward=step_reward)

    def done_function(self, state, arrive, out_of_road):
        terminated, truncated, done_info = super().done_function(state, arrive, out_of_road)
        # rushing through the plaza terminates as out_of_road
        # (marl_tollgate.py:262-268)
        too_fast = state.aux[:, 2] > 0.5
        done_info = dict(done_info)
        done_info["out_of_road"] = done_info["out_of_road"] | too_fast
        return terminated | too_fast, truncated, done_info
