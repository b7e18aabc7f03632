"""Multi-agent racing environment.

Reference: metadrive/envs/marl_envs/marl_racing_env.py — a hand-designed
one-way 12-block track (straights and sweeping curves) walled with
guardrails on both sides, 12 agents racing to the finish. Guardrail contact
counts as crash_sidewalk (a small penalty, not terminal by default);
driving backwards past the lane start (longitude < -5) is out_of_road;
standing still for ~100 steps ends the episode as IDLE.

The reference tracks idling with a 100-step rolling sum of per-step movement
(< 0.1 m in all); here a counter of consecutive steps without movement in
aux[:, 0] gives the same observable behaviour, as in the JAX package.
"""
import torch

from metadrive_ped_torch.constants import LINE_GUARDRAIL, TerminationState
from metadrive_ped_torch.envs.marl_envs.marl_env import MultiAgentMetaDrive
from metadrive_ped_torch.ops import lane_geom

# the fixed track (marl_racing_env.py:103-318), as (id, config) specs
_TRACK = [
    dict(id="S", config=dict(length=100.0)),
    dict(id="C", config=dict(length=200.0, radius=100.0, angle=90.0, dir=1)),
    dict(id="S", config=dict(length=100.0)),
    dict(id="C", config=dict(length=100.0, radius=60.0, angle=90.0, dir=1)),
    dict(id="C", config=dict(length=100.0, radius=60.0, angle=90.0, dir=1)),
    dict(id="S", config=dict(length=200.0)),
    dict(id="C", config=dict(length=80.0, radius=40.0, angle=90.0, dir=1)),
    dict(id="C", config=dict(length=40.0, radius=50.0, angle=180.0, dir=1)),
    dict(id="C", config=dict(length=40.0, radius=50.0, angle=220.0, dir=0)),
    dict(id="C", config=dict(length=50.0, radius=20.0, angle=180.0, dir=1)),
    dict(id="S", config=dict(length=100.0)),
    dict(id="C", config=dict(length=100.0, radius=40.0, angle=140.0, dir=0)),
]
_FINISH_NODE = "12C0_1_"  # the final curve's socket end
IDLE_STEPS = 100
IDLE_MOVEMENT = 0.001  # m/step; a 100-step sum < 0.1 m in the reference


class MultiAgentRacingEnv(MultiAgentMetaDrive):
    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                num_agents=12,
                map="racing",
                map_config=dict(
                    lane_width=3.5, lane_num=2, exit_length=20.0,
                    custom_blocks=_TRACK,
                    remove_negative_lanes=True,
                    center_line_type=LINE_GUARDRAIL,
                    side_line_type=LINE_GUARDRAIL,
                ),
                # the short first block and the 100 m opening straight give
                # spawn slots for 12 agents
                spawn_roads=[(">>", ">>>"), (">>>", "1S0_0_")],
                spawn_dest_nodes=[[_FINISH_NODE], [_FINISH_NODE]],
                # RACING_CONFIG (marl_racing_env.py:41-61)
                out_of_road_penalty=5.0,
                success_reward=20.0,
                crash_sidewalk_penalty=1.0,
                idle_penalty=1.0,
                idle_done=True,
                crash_sidewalk_done=False,
                out_of_road_done=True,
                use_lateral_reward=False,
            ),
            allow_add_new_key=True,
        )
        return config

    # ---- idle tracking (aux[:, 0] = consecutive still steps) ---------------
    def _pre_reward_update(self, state, loc):
        moved = torch.sqrt(((state.ego.pos - state.ego.last_pos) ** 2).sum(-1))
        count = torch.where(moved < IDLE_MOVEMENT, state.aux[:, 0] + 1.0, 0.0)
        return state.replace(aux=torch.cat([count[:, None], state.aux[:, 1:]], dim=1))

    def _is_idle(self, state):
        return state.aux[:, 0] >= IDLE_STEPS

    # ---- scheme overrides ---------------------------------------------------
    def _is_out_of_road(self, ego, state=None):
        """Guardrails wall the track; only reversing past the lane start is
        out of road (marl_racing_env.py:354-359)."""
        g = lane_geom.gather_lane(self.scene, state.sidx, ego.lane)
        long, _ = lane_geom.local_coordinates(g, ego.pos)
        return long < -5.0

    def reward_function(self, state, loc, arrive, out_of_road):
        # marl_racing_env.py:396-436
        cfg = self.config
        scene, sidx, ego = self.scene, state.sidx, state.ego
        cur_road = loc["cur_road"]
        road_info = lane_geom.gather_road(scene, sidx, cur_road)
        lane_for_reward = torch.where(loc["road"] == cur_road, ego.lane, road_info["lane0"])
        g = lane_geom.gather_lane(scene, sidx, lane_for_reward)
        long_now, _ = lane_geom.local_coordinates(g, ego.pos)
        long_last, _ = lane_geom.local_coordinates(g, ego.last_pos)
        speed_kmh = ego.speed * 3.6
        reward = (cfg["driving_reward"] * (long_now - long_last)
                  + cfg["speed_reward"] * (speed_kmh / ego.params.max_speed_kmh))
        step_reward = reward
        reward = torch.where(
            arrive, cfg["success_reward"],
            torch.where(
                out_of_road, -cfg["out_of_road_penalty"],
                torch.where(
                    ego.crash_vehicle, -cfg["crash_vehicle_penalty"],
                    torch.where(
                        ego.crash_sidewalk, -cfg["crash_sidewalk_penalty"],
                        torch.where(self._is_idle(state), -cfg["idle_penalty"], reward),
                    ),
                ),
            ),
        )
        return reward, dict(step_reward=step_reward, progress=long_now - long_last,
                            speed_km_h=speed_kmh)

    def done_function(self, state, arrive, out_of_road):
        terminated, truncated, done_info = super().done_function(state, arrive, out_of_road)
        idle = self._is_idle(state)
        done_info = dict(done_info)
        done_info[TerminationState.IDLE] = idle
        if self.config["idle_done"]:
            terminated = terminated | idle
        if self.config["crash_sidewalk_done"]:
            terminated = terminated | state.ego.crash_sidewalk
        return terminated, truncated, done_info
