"""MetaDriveEnv — the PG-map driving task (vectorized).

Reward/done/cost formulas are ports of the reference
(metadrive/envs/metadrive_env.py:128-279), evaluated as batched tensor ops.
"""
import torch

from benchmarks.reference.constants import TerminationState
from benchmarks.reference.envs.base import BaseVectorEnv
from benchmarks.reference.ops import lane_geom
from benchmarks.reference.ops.math_ops import clip01


class MetaDriveEnv(BaseVectorEnv):
    """``MetaDriveEnv(config, device=None)`` runs on CUDA unless ``device``
    names another device (``"cpu"``); without a GPU it raises unless asked
    for the CPU."""

    def _is_out_of_road(self, ego, state=None):
        # reference: metadrive_env.py:229-237
        ret = ~ego.on_lane
        if self.config["out_of_route_done"]:
            ret = ret | ego.out_of_route
        elif self.config["on_continuous_line_done"]:
            ret = ret | ego.on_yellow_line | ego.on_white_line | ego.crash_sidewalk
        return ret

    def reward_function(self, state, loc, arrive, out_of_road):
        # reference: metadrive_env.py:239-279
        cfg = self.config
        scene, sidx, ego = self.scene, state.sidx, state.ego

        # driving progress is measured on the current lane when it belongs to
        # the current ref road, else on ref lane 0 (metadrive_env.py:249-257)
        cur_road = loc["cur_road"]
        road_info = lane_geom.gather_road(scene, sidx, cur_road)
        on_ref = loc["road"] == cur_road
        lane_for_reward = torch.where(on_ref, ego.lane, road_info["lane0"])
        g = lane_geom.gather_lane(scene, sidx, lane_for_reward)
        long_now, lateral_now = lane_geom.local_coordinates(g, ego.pos)
        long_last, _ = lane_geom.local_coordinates(g, ego.last_pos)
        positive_road = torch.where(road_info["negative"], -1.0, 1.0)

        if cfg["use_lateral_reward"]:
            lateral_factor = clip01(1 - 2 * torch.abs(lateral_now) / g["width"])
        else:
            lateral_factor = 1.0

        reward = cfg["driving_reward"] * (long_now - long_last) * lateral_factor * positive_road
        speed_kmh = ego.speed * 3.6
        reward = reward + cfg["speed_reward"] * (speed_kmh / ego.params.max_speed_kmh) * positive_road
        step_reward = reward

        # terminal overrides (metadrive_env.py:271-279) in the reference's
        # if/elif order
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

    def cost_function(self, state, out_of_road):
        # reference: metadrive_env.py:201-211 (if/elif priority)
        cfg = self.config
        ego = state.ego
        cost = torch.where(
            out_of_road, cfg["out_of_road_cost"],
            torch.where(
                ego.crash_vehicle, cfg["crash_vehicle_cost"],
                torch.where(ego.crash_object, cfg["crash_object_cost"], 0.0),
            ),
        )
        return cost, {}

    def done_function(self, state, arrive, out_of_road):
        # reference: metadrive_env.py:128-199
        cfg = self.config
        ego = state.ego
        terminated = arrive | out_of_road
        if cfg["crash_vehicle_done"]:
            terminated = terminated | ego.crash_vehicle
        if cfg["crash_object_done"]:
            terminated = terminated | ego.crash_object
        # crash_building always terminates (metadrive_env.py:179-184)
        terminated = terminated | ego.crash_building
        if cfg["crash_human_done"]:
            terminated = terminated | ego.crash_human
        horizon = cfg["horizon"]
        if horizon is not None:
            truncated = state.step_count >= horizon
            if cfg["truncate_as_terminate"]:
                terminated = terminated | truncated
        else:
            truncated = torch.zeros_like(terminated)
        done_info = {
            TerminationState.SUCCESS: arrive,
            TerminationState.OUT_OF_ROAD: out_of_road,
            TerminationState.CRASH_VEHICLE: ego.crash_vehicle,
            TerminationState.CRASH_OBJECT: ego.crash_object,
            TerminationState.CRASH_BUILDING: ego.crash_building,
            TerminationState.CRASH_HUMAN: ego.crash_human,
            TerminationState.CRASH_SIDEWALK: ego.crash_sidewalk,
        }
        return terminated, truncated, done_info
