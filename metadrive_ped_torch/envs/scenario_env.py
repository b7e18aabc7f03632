"""ScenarioEnv — log replay of ScenarioDescription datasets (vectorized).

Reference: metadrive/envs/scenario_env.py:21-357 + the scenario managers
(manager/scenario_*.py). Every env replays one scenario: traffic follows its
recorded tracks frame by frame (ReplayTrafficParticipantPolicy,
policy/replay_policy.py:10-68) or, with reactive_traffic, IDM speed control
along the recorded path (TrajectoryIDMPolicy, idm_policy.py:426-493); the
ego is RL-controlled and navigated along the recorded sdc trajectory
(TrajectoryNavigation, navigation_module/trajectory_navigation.py).

Observation layout (reference formula, 161 dims with the default config):
  12 side-detector rays + 6 ego core + 1 lane-lateral = 19
  trajectory navi 10 waypoints x 2 + (lateral, heading-diff) = 22
  lidar 120
The side detector sees the scenario's continuous lines through the
ray-segment kernel (ops/ray_segment.py); the lane-line detector is not
part of this observation and its config is ignored.

A step makes no host synchronisation: `_advance` and `rollout` decide
every branch on the host from the config, never from tensor values.
"""
import math
from collections import deque

import numpy as np
import torch

from metadrive_ped_torch.config import Config
from metadrive_ped_torch.constants import (
    BICYCLE_REF_ACCEL, BICYCLE_REF_BRAKE, IDM_ACT_BATCH_SIZE, OBS_MAX_STEERING,
    SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE, TerminationState,
)
from metadrive_ped_torch.core import prng, trace
from metadrive_ped_torch.core.device import resolve_device
from metadrive_ped_torch.core.logger import get_logger
from metadrive_ped_torch.core.scenario_structs import ScenarioScene, ScenarioSimState
from metadrive_ped_torch.core.structs import PAST_POS_STEPS, EgoState, tree_map
from metadrive_ped_torch.envs.base import (
    _TBL_MAT, DEFAULT_CLASS_IDX, VectorEnvLoop, make_vehicle_params,
)
from metadrive_ped_torch.mapgen.scenario_scene import (
    TRK_SPACING_M, UPATH_QUANT, build_scenario_pack,
)
from metadrive_ped_torch.ops import collision, dynamics, polyline, ray_segment, raycast
from metadrive_ped_torch.ops.idm import idm_acceleration
from metadrive_ped_torch.ops.math_ops import clip01, heading_vec, rhs_vec, wrap_to_pi

NUM_WAY_POINT = 10      # trajectory_navigation.py:21
CKPT_DIM = 2
DISCRETE_LEN = 2.0      # trajectory_navigation.py:19
TRAJ_NAVI_POINT_DIST = 30.0

NAVI_DIM = NUM_WAY_POINT * CKPT_DIM + 2  # = 22

# TrajectoryIDMPolicy (idm_policy.py:426-430)
TRAJ_NORMAL_SPEED = 40.0   # km/h
IDM_MAX_DIST = 20.0        # m
DEST_REGION_RADIUS = 2.0   # m


class ScenarioEnv(VectorEnvLoop):
    """``ScenarioEnv(config, device=None)`` runs on CUDA unless ``device``
    names another device (``"cpu"``); without a GPU it raises unless asked
    for the CPU."""

    @classmethod
    def default_config(cls):
        # reference: scenario_env.py:21-94 SCENARIO_ENV_CONFIG
        return Config(
            dict(
                num_envs=16,
                data_directory=None,
                scenario_data=None,  # in-memory list of SD dicts
                start_scenario_index=0,
                num_scenarios=None,
                sequential_seed=False,
                worker_index=0,
                num_workers=1,
                no_traffic=False,
                reactive_traffic=False,
                # curriculum (scenario_env.py:31-33): with curriculum_level > 1
                # the scenario set splits into that many contiguous
                # difficulty bands and the env levels up when the recent
                # success rate clears target_success_rate
                # (ScenarioCurriculumManager semantics)
                curriculum_level=1,
                episodes_to_evaluate_curriculum=None,
                target_success_rate=0.8,
                # localize the ego against the compiled map-feature lane
                # network (scenario_env.py:38 need_lane_localization); strict
                # out-of-road then requires lane membership
                need_lane_localization=True,
                replay_ego=False,  # ReplayEgoCarPolicy (policy/replay_policy.py:70)
                even_sample_vehicle_class=True,
                horizon=None,
                truncate_as_terminate=False,
                auto_reset=True,
                decision_repeat=5,
                physics_world_step_size=0.02,
                # ego <-> replayed-track rigid contact resolution
                contact_response=True,
                vehicle_config=dict(
                    enable_reverse=False,
                    lidar=dict(num_lasers=120, distance=50.0),
                    side_detector=dict(num_lasers=12, distance=50.0),
                    lane_line_detector=dict(num_lasers=0, distance=50.0),
                ),
                # reward scheme (scenario_env.py:64-80)
                success_reward=5.0,
                out_of_road_penalty=5.0,
                on_lane_line_penalty=1.0,
                crash_vehicle_penalty=1.0,
                crash_object_penalty=1.0,
                crash_human_penalty=1.0,
                driving_reward=1.0,
                steering_range_penalty=0.5,
                heading_penalty=1.0,
                lateral_penalty=0.5,
                max_lateral_dist=4.0,
                no_negative_reward=True,
                crash_vehicle_cost=1.0,
                crash_object_cost=1.0,
                out_of_road_cost=1.0,
                crash_human_cost=1.0,
                out_of_route_done=False,
                crash_vehicle_done=False,
                crash_object_done=False,
                crash_human_done=False,
                relax_out_of_road_done=True,
            )
        )

    def __init__(self, config=None, device=None):
        self.device = resolve_device(device)
        self.config = self.default_config()
        if config:
            self.config.update(config)
        cfg = self.config
        if cfg["scenario_data"] is not None:
            sds = list(cfg["scenario_data"])
        else:
            from metadrive_ped_torch.scenario.utils import load_scenarios
            if not cfg["data_directory"]:
                raise ValueError("ScenarioEnv needs data_directory or scenario_data")
            sds = load_scenarios(
                cfg["data_directory"], cfg["start_scenario_index"], cfg["num_scenarios"],
                cfg["worker_index"], cfg["num_workers"],
            )
        if cfg["num_scenarios"]:
            sds = sds[: cfg["num_scenarios"]]
        self.num_scenarios = len(sds)
        pack = build_scenario_pack(sds)
        get_logger().info(
            "compiled %d scenario(s): %d track slots, %d map lanes, T=%d",
            self.num_scenarios, pack["trk_pos"].shape[1],
            pack["lane_pts"].shape[1], pack["trk_pos"].shape[2],
        )
        self._has_lanes = bool(np.any(pack["lane_valid"]))
        self._sds = sds  # raw SDs for host-side map introspection
        self.scene = ScenarioScene.from_pack(pack, self.device)
        self.num_envs = cfg["num_envs"]
        self._state = None
        self._last_obs = None
        # ---- curriculum (scenario_env.py:31-33 config keys; manager/
        # scenario_curriculum_manager.py:38-84 semantics) ------------------
        self._cur_levels = int(cfg["curriculum_level"])
        if self._cur_levels > 1:
            if self.num_scenarios % self._cur_levels:
                raise ValueError("each curriculum level needs the same number of scenarios")
            self._cur_total = self.num_scenarios
            self._cur_band = self.num_scenarios // self._cur_levels
            self._cur_level = 0
            self._cur_eval = cfg["episodes_to_evaluate_curriculum"] or self._cur_band
            self._cur_recent = deque(maxlen=self._cur_eval)
            # episodes sample only the current band (state.scenario_cap
            # carries it through the step)
            self.num_scenarios = self._cur_band
        # data_coverage (scenario_data_manager.py:185-190): fraction of this
        # worker's dataset that has entered an episode, times num_workers
        self._seen_scenarios = set()
        # per-scenario difficulty (SD metadata; 0 when absent)
        self._difficulty = torch.as_tensor(np.asarray([
            float((sd.get("metadata") or {}).get("difficulty", 0) or 0) for sd in sds
        ], np.float32)).to(self.device)
        self._recent_route_completion = None
        self._class_table = torch.as_tensor(_TBL_MAT).to(self.device)
        # the side detector's per-scenario table of continuous lines, built
        # once: no step gathers or dequantizes segments for it
        self._line_table = None
        if cfg["vehicle_config"]["side_detector"]["num_lasers"] > 0:
            self._line_table = ray_segment.build_line_table(self.scene, include_broken=False)

    # ------------------------------------------------------------------ API
    @property
    def observation_dim(self):
        vc = self.config["vehicle_config"]
        side = max(vc["side_detector"]["num_lasers"], 2)
        return side + 6 + 1 + NAVI_DIM + vc["lidar"]["num_lasers"]

    def _reset_outputs(self, obs, info):
        self._track_coverage(info)
        info["curriculum_level"] = self.current_level
        info["data_coverage"] = self.data_coverage
        return obs, info

    def _step_outputs(self, obs, reward, term, trunc, info):
        """The per-env results stay on the device; the coverage statistics
        and, with curriculum_level > 1, the curriculum read ``env_seed``
        (and the done flags) on the host, as the JAX package's step does, so
        `step` synchronises with the device once. `rollout` does not."""
        self._track_coverage(info)
        if self._cur_levels > 1:
            self._curriculum_update(term, trunc, info)
        # host-side scalars like the reference's step_info keys
        # (scenario_env.py:280-283); per-env tensors stay on the device
        info["curriculum_level"] = self.current_level
        info["data_coverage"] = self.data_coverage
        info["num_stored_maps"] = self.num_scenarios
        info["scenario_difficulty"] = self._difficulty[
            (info["env_seed"] - self.config["start_scenario_index"]).long()]
        if self._cur_levels > 1:
            info["curriculum_success"] = self.current_success_rate
            info["curriculum_route_completion"] = self.current_route_completion
        return obs, reward, term, trunc, info

    # ---- curriculum / coverage stats (reference step_info surface) -------
    @property
    def current_level(self):
        """0-based current curriculum level (engine.current_level,
        scenario_env.py:280)."""
        return self._cur_level if self._cur_levels > 1 else 0

    @property
    def current_success_rate(self):
        if self._cur_levels <= 1 or not self._cur_recent:
            return 0.0
        return float(sum(self._cur_recent)) / self._cur_eval

    @property
    def data_coverage(self):
        """Fraction of this worker's dataset that has entered an episode,
        times num_workers (scenario_data_manager.py:185-190). Updated on
        .step()/.reset() calls; rollout() does not touch the host counter."""
        total = getattr(self, "_cur_total", self.num_scenarios)
        return len(self._seen_scenarios) / max(total, 1) * self.config["num_workers"]

    def _track_coverage(self, info):
        start = self.config["start_scenario_index"]
        seeds = torch.unique(info["env_seed"]).cpu().numpy()
        self._seen_scenarios.update(int(s) - start for s in seeds)

    @property
    def current_route_completion(self):
        """Mean route completion over the curriculum evaluation window."""
        if not self._recent_route_completion:
            return 0.0
        return float(np.mean(self._recent_route_completion))

    def _curriculum_update(self, term, trunc, info):
        done = (term | trunc).cpu().numpy()
        if not done.any():
            return
        success = info["arrive_dest"].cpu().numpy()[done]
        if self._recent_route_completion is None:
            self._recent_route_completion = deque(maxlen=self._cur_eval)
        if "route_completion" in info:
            self._recent_route_completion.extend(
                float(r) for r in info["route_completion"].cpu().numpy()[done])
        self._cur_recent.extend(bool(s) for s in success)
        if (self.current_success_rate >= self.config["target_success_rate"] - 1e-3
                and self._cur_level < self._cur_levels - 1):
            self._cur_level += 1
            self.num_scenarios = self._cur_band * (self._cur_level + 1)
            get_logger().info("curriculum level %d/%d: scenario band -> %d",
                              self._cur_level, self._cur_levels, self.num_scenarios)
            self._cur_recent = deque(maxlen=self._cur_eval)
            if self._state is not None:
                cap = torch.full_like(self._state.scenario_cap, self.num_scenarios)
                self._state = self._state.replace(scenario_cap=cap)

    def close(self):
        self._state = None
        self._graphs = None

    def get_map_features(self, scenario_index=0):
        """The scenario's raw SD map_features (ScenarioMap.get_map_features
        passthrough, component/map/scenario_map.py)."""
        return dict(self._sds[scenario_index].get("map_features") or {})

    def edge_network(self, scenario_index=0):
        """EdgeRoadNetwork of one loaded scenario's raw map: a lane-indexed
        graph with entry/exit/neighbor adjacency and BFS routing (the
        reference ScenarioMap's road_network, scenario_map.py +
        edge_road_network.py). Host-side introspection; the step uses the
        compiled lane arrays."""
        from metadrive_ped_torch.mapgen.edge_network import build_edge_network
        return build_edge_network(self._sds[scenario_index])

    def rollout(self, n_steps, policy_fn=None, actions=None, collect=("reward",)):
        """`VectorEnvLoop.rollout`; a state set without reset() gets its
        observation first, as the JAX package's rollout does."""
        if self._last_obs is None:
            self._last_obs = self._observe(self._state)
        return super().rollout(n_steps, policy_fn, actions, collect)

    def _rollout_fields(self, state):
        return dict(ego_pos=state.ego.pos, ego_heading=state.ego.heading,
                    ego_speed=state.ego.speed)

    # ------------------------------------------------------------- internals
    def _spawn(self, rng, sidx):
        scene = self.scene
        dev = self.device
        E = sidx.shape[0]
        s = sidx.long()
        pos = scene.sdc_start_pos[s]
        heading = scene.sdc_start_heading[s]
        zeros = torch.zeros(E, device=dev)
        zi = torch.zeros(E, dtype=torch.int32, device=dev)
        false = torch.zeros(E, dtype=torch.bool, device=dev)
        ego = EgoState(
            pos=pos, heading=heading, speed=zeros, vel_dir=zeros,
            steering=zeros, throttle=zeros,
            last_action=torch.zeros((E, 2), device=dev),
            current_action=torch.zeros((E, 2), device=dev),
            last_pos=pos, last_heading=heading,
            lane=zi, route_idx=zi, slot=zi,
            on_lane=torch.ones(E, dtype=torch.bool, device=dev),
            crash_vehicle=false, crash_object=false, crash_human=false,
            crash_building=false, crash_sidewalk=false,
            on_yellow_line=false, on_white_line=false, out_of_route=false,
            past_pos=pos[:, None, :].repeat(1, PAST_POS_STEPS, 1),
            break_down=false,
            params=make_vehicle_params(
                self._class_table,
                torch.full((E,), DEFAULT_CLASS_IDX, dtype=torch.int32, device=dev)),
        )
        KR = scene.trk_unpts.shape[1]  # compact reactive axis (eligible slots)
        # pose at arc 0 of each reactive route: the origin (chord 0) and the
        # dequantized chord 1, small row gathers
        p0 = scene.trk_uorigin[s]
        p1 = p0 + scene.trk_upath_q[:, :, 1, :][s].float() * UPATH_QUANT
        uheading = torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
        return ScenarioSimState(
            rng=rng, sidx=sidx, step_count=zi,
            episode_reward=zeros, episode_cost=zeros,
            scenario_cap=torch.full((E,), self.num_scenarios, dtype=torch.int32, device=dev),
            ego=ego, last_long=zeros, cur_long=zeros, cur_lat=zeros,
            npc_long=torch.zeros((E, KR), device=dev), npc_speed=scene.trk_spawn_speed[s],
            npc_acc=torch.zeros((E, KR), device=dev),
            npc_dead=torch.zeros((E, KR), dtype=torch.bool, device=dev),
            npc_upos=p0, npc_uheading=uheading,
            phase=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def _reset_state(self, rng):
        E = self.num_envs
        keys = prng.split(rng, E + 1)
        if self.config["sequential_seed"]:
            sidx = ((torch.arange(E, device=self.device) + self.config["worker_index"])
                    % self.num_scenarios).to(torch.int32)
        else:
            sidx = prng.randint(keys[0], (E,), 0, self.num_scenarios)
        state = self._spawn(keys[1:], sidx)
        return state, (), dict(env_seed=sidx + self.config["start_scenario_index"])

    def _npc_pose(self, state):
        """Replayed (or reactive) traffic pose at the current timestep."""
        scene = self.scene
        s = state.sidx.long()
        T = scene.trk_pos.shape[2]
        t = torch.clamp(state.step_count, 0, T - 1)
        # pose at t is one row of the time-major copy
        flat = (state.sidx * T + t).long()
        pos = scene.trk_pos_t[flat]          # [E,TRK,2]
        heading = scene.trk_heading_t[flat]
        active = scene.trk_valid_t[flat]

        if self.config["reactive_traffic"]:
            # TrajectoryIDM vehicles follow their recorded route with IDM
            # speed control (idm_policy.py:426-493). Eligibility was
            # precomputed per track (route > 5 m, spawned behind the ego,
            # scenario_traffic_manager.py:217-235) and eligible tracks sort
            # first on the track axis, so the reactive overlay only touches
            # the leading KR slots; everything else replays. The route pose
            # is carried in the state (npc_upos).
            K = pos.shape[1]
            KR = scene.trk_unpts.shape[1]
            KRT = min(KR, K)
            unpts = scene.trk_unpts[s]
            reactive = scene.trk_reactive_ok[s]                 # [E,KR]
            # reactive cars spawn at their recorded first-valid step and
            # despawn at arrive_destination (npc_dead)
            spawned = state.step_count[:, None] >= scene.trk_first_t[s]
            r_active = reactive & spawned & ~state.npc_dead & (unpts > 1)
            ov = reactive[:, :KRT]
            pos = torch.cat([torch.where(ov[..., None], state.npc_upos[:, :KRT], pos[:, :KRT]),
                             pos[:, KRT:]], dim=1)
            heading = torch.cat([torch.where(ov, state.npc_uheading[:, :KRT], heading[:, :KRT]),
                                 heading[:, KRT:]], dim=1)
            active = torch.cat([torch.where(ov, r_active[:, :KRT], active[:, :KRT]),
                                active[:, KRT:]], dim=1)
        if self.config["no_traffic"]:
            # nothing spawns at all (scenario_env.py:44 + manager gate :122)
            active = torch.zeros_like(active)
        return pos, heading, active

    def _step_npc_reactive(self, state, ego):
        """TrajectoryIDMPolicy speed control along each track's recorded
        PointLane (idm_policy.py:426-493 + scenario_traffic_manager.py:67-76):

        - front-gap search measured along the route's ARC LENGTH over a 20 m
          probe chain (get_find_front_back_objs_single_lane restricted to
          IDM_MAX_DIST: bodies near the lane, smallest positive relative
          longitude), not a heading cone;
        - staggered act batches: track k refreshes its IDM acceleration only
          on steps where the global act phase equals k % IDM_ACT_BATCH_SIZE
          and replays the committed value otherwise (the batched twin of
          before_step's round-robin policy_index gate,
          scenario_traffic_manager.py:75);
        - arrive_destination: a car within DEST_REGION_RADIUS of its route
          end is cleaned (idm_policy.py:449-455 + manager before_step).

        The IDM state lives on the compact KR axis, and the probe chain and
        front-gap search run only for the fresh act batch, selected by the
        phase tensor on the device.
        """
        scene = self.scene
        s = state.sidx.long()
        E, KR = state.npc_long.shape
        upath_q = scene.trk_upath_q[s]        # [E,KR,P,2] int16
        uorigin = scene.trk_uorigin[s]        # [E,KR,2]
        unpts = scene.trk_unpts[s]
        total = scene.trk_utotal[s]

        # candidates at their current pose (replay or reactive)
        cand_pos, _, cand_active = self._npc_pose(state)
        K = cand_pos.shape[1]
        KRT = min(KR, K)
        cand = torch.cat([cand_pos, ego.pos[:, None]], dim=1)                 # [E,C,2]
        cand_active = torch.cat(
            [cand_active, torch.ones((E, 1), dtype=torch.bool, device=self.device)], dim=1)
        # candidate speeds: live IDM speed for reactive slots, recorded body
        # speed for replayed tracks (the reference's front object is a
        # kinematic body whose velocity is force-set from the log each frame)
        T = scene.trk_pos.shape[2]
        flat = (state.sidx * T + torch.clamp(state.step_count, 0, T - 1)).long()
        rec_speed = scene.trk_speed_t[flat]                                   # [E,K]
        reactive = scene.trk_reactive_ok[s]                                   # [E,KR]
        spd = torch.cat([
            torch.where(reactive[:, :KRT], state.npc_speed[:, :KRT], rec_speed[:, :KRT]),
            rec_speed[:, KRT:],
        ], dim=1)
        cand_speed = torch.cat([spd, ego.speed[:, None]], dim=1)
        cand_wid = torch.cat([scene.trk_wid[s], ego.params.width[:, None]], dim=1)

        # ---- fresh act batch: tracks k == phase (mod ACT) ----
        ACT = IDM_ACT_BATCH_SIZE
        G = KR // ACT
        phase = state.phase
        phase_idx = phase.reshape(1).long()

        def sub(x):
            r = x.reshape((E, G, ACT) + x.shape[2:])
            return r.index_select(2, phase_idx).squeeze(2)

        long_sub = sub(state.npc_long)                                         # [E,G]
        unpts_sub = sub(unpts)
        total_sub = sub(total)
        upath_q_sub = sub(upath_q)                                             # [E,G,P,2]
        base_sub = torch.floor(long_sub / TRK_SPACING_M).to(torch.int32)

        # 20 m probe chain along my own arc (5 points / 4 chords)
        step_chords = int(round((IDM_MAX_DIST / 4.0) / TRK_SPACING_M))
        my_pos_sub, _, aheads = polyline.uniform_pose_and_ahead(
            upath_q_sub, unpts_sub, TRK_SPACING_M, long_sub, total_sub,
            deltas=tuple(k * step_chords for k in range(1, 5)),
            scale=UPATH_QUANT, origin=sub(uorigin),
        )
        probe = torch.stack([my_pos_sub] + aheads, dim=-2)                    # [E,G,5,2]
        chain = torch.arange(5, dtype=torch.int32, device=self.device) * step_chords
        probe_long = torch.minimum(
            torch.minimum(base_sub[..., None] + chain, unpts_sub[..., None] - 1).float()
            * TRK_SPACING_M,
            total_sub[..., None],
        )
        probe_long = torch.cat([long_sub[..., None], probe_long[..., 1:]], dim=-1)
        a = probe[..., :-1, :]
        seg = probe[..., 1:, :] - a
        seg_len = torch.sqrt(torch.clamp((seg ** 2).sum(-1), min=1e-12))     # [E,G,4]
        arc0 = (probe_long - long_sub[..., None])[..., :-1]                  # [E,G,4]

        rel = cand[:, None, :, None, :] - a[:, :, None, :, :]                 # [E,G,C,4,2]
        t = torch.clamp(
            (rel * seg[:, :, None]).sum(-1)
            / torch.clamp((seg_len ** 2)[:, :, None], min=1e-9), 0.0, 1.0,
        )
        proj = a[:, :, None] + t[..., None] * seg[:, :, None]
        dist_lat = torch.sqrt(((cand[:, None, :, None, :] - proj) ** 2).sum(-1))
        long_c = arc0[:, :, None, :] + t * seg_len[:, :, None, :]             # [E,G,C,4]
        # on-route test ~ PointLane(width=2).point_on_lane of the candidate
        # bounding box (idm_policy.py:160-167): centre within half the lane
        # width plus the body's half width
        on_route = dist_lat < (1.0 + cand_wid[:, None, :, None] / 2)
        # candidate c is the probing track itself when c == g*ACT + phase
        ks = torch.arange(G, device=self.device) * ACT + phase                 # [G]
        not_self = torch.arange(K + 1, device=self.device)[None, :] != ks[:, None]  # [G,C]
        valid = (on_route & cand_active[:, None, :, None]
                 & not_self[None, :, :, None] & (long_c > 0.1))
        fgap = torch.where(valid, long_c, torch.inf)                          # [E,G,C,4]
        front_dist = fgap.amin(dim=(2, 3))                                    # [E,G]
        has_front = torch.isfinite(front_dist)
        # speed of the nearest candidate: the minimum speed over every
        # candidate at the minimum gap (ties resolve to the slowest), the
        # JAX package's rule, not the first match
        front_speed = torch.where(
            fgap <= front_dist[..., None, None], cand_speed[:, None, :, None], torch.inf,
        ).amin(dim=(2, 3))
        front_speed = torch.where(has_front, front_speed, 0.0)

        acc_sub = idm_acceleration(
            sub(state.npc_speed) * 3.6, front_speed * 3.6,
            torch.where(has_front, front_dist, 1e6), has_front,
            target_speed_kmh=TRAJ_NORMAL_SPEED,
        )
        # commit the fresh batch; other tracks replay their committed value
        in_batch = torch.arange(ACT, device=self.device) == phase
        acc = torch.where(in_batch, acc_sub[..., None],
                          state.npc_acc.reshape(E, G, ACT)).reshape(E, KR)

        # acceleration -> speed exactly like a throttle on the bicycle model
        # (positive scales to the engine gain, negative to the brake gain,
        # bicycle_model.py:29-36). Integration is gated on the spawn step: a
        # late-spawning IDM car holds its recorded spawn speed at arc 0
        # until step >= first_t
        spawned = state.step_count[:, None] >= scene.trk_first_t[s]
        dt = self.config["physics_world_step_size"] * self.config["decision_repeat"]
        thr = torch.clamp(acc, -1.0, 1.0)
        accel_ms2 = torch.where(thr >= 0, thr * BICYCLE_REF_ACCEL, thr * BICYCLE_REF_BRAKE)
        speed = torch.where(
            spawned, torch.clamp(state.npc_speed + accel_ms2 * dt, 0.0, 80.0 / 3.6),
            state.npc_speed)
        long = torch.where(
            spawned, torch.minimum(state.npc_long + speed * dt, total), state.npc_long)
        # arrive_destination within 2 m of the route end, measured along the
        # arc (== the reference's euclidean end-region radius at route ends)
        dead = state.npc_dead | (total - long < DEST_REGION_RADIUS)
        # re-establish the carried pose at the advanced arc
        upos, uheading = polyline.uniform_pose(
            upath_q, unpts, TRK_SPACING_M, long, total=total,
            scale=UPATH_QUANT, origin=uorigin,
        )
        return state.replace(npc_long=long, npc_speed=speed, npc_acc=acc,
                             npc_dead=dead, npc_upos=upos, npc_uheading=uheading)

    def _observe(self, state, cached=None):
        """cached = (long, lat, traj_heading, npc_pose) computed by
        _advance this step, so the polyline localization and the track
        poses are not computed twice."""
        cfg = self.config
        scene, ego = self.scene, state.ego
        s = state.sidx.long()
        vc = cfg["vehicle_config"]
        E = self.num_envs

        pts = scene.sdc_pts[s]
        npts = scene.sdc_npts[s]
        arcl = scene.sdc_arclen[s]
        if cached is not None:
            long, lat, traj_heading, npc_pose = cached
        else:
            long, lat = polyline.local_coordinates(pts, npts, ego.pos, s=arcl)
            traj_heading = polyline.heading_at(pts, npts, long, s=arcl)
            npc_pose = None

        with trace.stage("observe.features", self.device):
            # --- side detector rays vs continuous lines (state_obs.py:77-86) ---
            n_side = vc["side_detector"]["num_lasers"]
            if n_side > 0:
                dist = vc["side_detector"]["distance"]
                side, _ = raycast.detector_clouds(
                    ego.pos, ego.heading, state.sidx, (n_side, dist), (0, dist), *self._line_table)
            else:
                # side detector off -> normalized lateral distances to the SDC
                # route's left/right borders (state_obs.py:90-98 fallback with
                # TrajectoryNavigation: lane = the width-2 idm route,
                # parse_object_state.py:19; lateral range = 2*width,
                # trajectory_navigation.py:148-152; normalized by
                # (MAX_LANE_NUM+1)*MAX_LANE_WIDTH = 18, base_map.py:38-40)
                route_w = 2.0
                lat_to_left = lat + route_w / 2.0
                lat_to_right = 2.0 * route_w - lat_to_left
                side = torch.stack([clip01(lat_to_left / 18.0), clip01(lat_to_right / 18.0)],
                                   dim=-1)

            # --- ego core (state_obs.py:100-151) -------------------------------
            hv = heading_vec(ego.heading)
            traj_rhs = rhs_vec(traj_heading)
            hdiff = torch.clamp((hv * traj_rhs).sum(-1), -1.0, 1.0) / 2 + 0.5
            speed_kmh = ego.speed * 3.6
            f_speed = clip01((speed_kmh + 1) / (ego.params.max_speed_kmh + 1))
            f_steer = clip01((ego.steering / OBS_MAX_STEERING + 1) / 2)
            f_a0 = clip01((ego.current_action[:, 0] + 1) / 2)
            f_a1 = clip01((ego.current_action[:, 1] + 1) / 2)
            # yaw rate: arccos(clip(<h_t, h_t-1>, 0, 1)) / 0.1, written as
            # min(|wrap(dh)|, pi/2) / 0.1, the same function without the
            # arccos's loss of precision near 1 (as obs/state_obs.py does)
            dh = torch.abs(wrap_to_pi(ego.heading - ego.last_heading))
            f_yaw = clip01(torch.clamp(dh, max=math.pi / 2) / 0.1)
            f_lat = clip01((lat * 2 / 4.5 + 1) / 2)
            core = torch.stack([hdiff, f_speed, f_steer, f_a0, f_a1, f_yaw, f_lat], dim=-1)

            # --- trajectory navi (trajectory_navigation.py:106-146) ------------
            next_idx = torch.clamp((long / DISCRETE_LEN).to(torch.int32) + 1, min=0)
            ks = torch.arange(1, NUM_WAY_POINT, dtype=torch.int32, device=self.device)
            total = polyline.total_length(pts, npts, s=arcl)
            ck_long = torch.minimum((next_idx[:, None] + ks[None, :]).float() * DISCRETE_LEN,
                                    total[:, None])
            ck_pos = polyline.position(pts[:, None], npts[:, None], ck_long, s=arcl[:, None])
            dirv = ck_pos - ego.pos[:, None, :]
            dn = torch.sqrt((dirv ** 2).sum(-1))
            scale = torch.where(dn > TRAJ_NAVI_POINT_DIST,
                                TRAJ_NAVI_POINT_DIST / torch.clamp(dn, min=1e-6), 1.0)
            dirv = dirv * scale[..., None]
            # LEFT-positive lateral (TrajectoryNavigation._get_info_for_checkpoint
            # -> convert_to_local_coordinates, base_vehicle.py:986-988)
            rv = -rhs_vec(ego.heading)
            in_h = (dirv * hv[:, None, :]).sum(-1)
            in_r = (dirv * rv[:, None, :]).sum(-1)
            wp = torch.stack(
                [clip01((in_h / TRAJ_NAVI_POINT_DIST + 1) / 2),
                 clip01((in_r / TRAJ_NAVI_POINT_DIST + 1) / 2)], dim=-1,
            ).reshape(E, (NUM_WAY_POINT - 1) * 2)
            tail = torch.stack([
                clip01((lat / cfg["max_lateral_dist"] + 1) / 2),
                clip01((wrap_to_pi(traj_heading - ego.heading) / math.pi + 1) / 2),
            ], dim=-1)
            navi = torch.cat([wp, tail, torch.zeros((E, 2), device=self.device)], dim=-1)  # 22

        # --- lidar vs replayed bodies --------------------------------------
        parts = [side, core, navi]
        if vc["lidar"]["num_lasers"] > 0:
            with trace.stage("observe.lidar", self.device):
                npc_pos, npc_heading, npc_active = (
                    npc_pose if npc_pose is not None else self._npc_pose(state))
                cloud = raycast.lidar_cloud(
                    ego.pos, ego.heading, vc["lidar"]["num_lasers"], vc["lidar"]["distance"],
                    npc_pos, npc_heading, scene.trk_len[s], scene.trk_wid[s], npc_active,
                )
            parts.append(cloud)
        return torch.cat(parts, dim=-1)

    def _advance(self, state, actions, prev_obs=None):
        """The step up to the observation, as `BaseVectorEnv._advance`; its
        stages are device spans of core/trace.py."""
        cfg = self.config
        scene = self.scene
        E = self.num_envs
        dev = self.device
        with trace.stage("advance.actions", dev):
            actions = torch.clamp(torch.nan_to_num(actions, nan=0.0, posinf=1.0, neginf=-1.0),
                                  -1.0, 1.0)
            # fault injection (set_break_down, base_vehicle.py:939-941)
            actions = torch.where(state.ego.break_down[:, None], 0.0, actions)

        with trace.stage("advance.dynamics", dev):
            ego = state.ego
            ego = ego.replace(
                last_pos=ego.pos, last_heading=ego.heading,
                last_action=ego.current_action, current_action=actions,
                steering=actions[:, 0], throttle=actions[:, 1],
                past_pos=torch.cat([ego.past_pos[:, 1:], ego.pos[:, None]], dim=1),
            )
            if cfg["replay_ego"]:
                # force-set the recorded sdc state (ReplayEgoCarPolicy semantics)
                T = scene.sdc_track_pos.shape[1]
                flat = (state.sidx * T + torch.clamp(state.step_count + 1, 0, T - 1)).long()
                pos = scene.sdc_pos_t[flat]
                heading = scene.sdc_heading_t[flat]
                speed = torch.sqrt(((pos - ego.pos) ** 2).sum(-1)) / 0.1
                vel_dir = torch.zeros_like(speed)
            else:
                pos, heading, speed, vel_dir = dynamics.step_vehicle(
                    ego.pos, ego.heading, ego.speed, ego.vel_dir, ego.steering, ego.throttle,
                    ego.params, dt=cfg["physics_world_step_size"], substeps=cfg["decision_repeat"],
                    enable_reverse=cfg["vehicle_config"]["enable_reverse"],
                )
            ego = ego.replace(pos=pos, heading=heading, speed=speed, vel_dir=vel_dir)

        with trace.stage("advance.traffic", dev):
            if cfg["reactive_traffic"]:
                state = self._step_npc_reactive(state, ego)
            state = state.replace(step_count=state.step_count + 1, ego=ego)
            s = state.sidx.long()

        with trace.stage("advance.contacts", dev):
            # contacts
            npc_pos, npc_heading, npc_active = self._npc_pose(state)
            hits = collision.obb_obb_overlap(
                ego.pos[:, None, :], ego.heading[:, None],
                ego.params.length[:, None], ego.params.width[:, None],
                npc_pos, npc_heading, scene.trk_len[s], scene.trk_wid[s],
            ) & npc_active
            is_ped = scene.trk_kind[s] != 0
            crash_v = (hits & ~is_ped).any(dim=1)
            crash_h = (hits & is_ped).any(dim=1)

            # rigid contact response, ego side only: replayed/reactive tracks are
            # kinematic bodies (ReplayTrafficParticipantPolicy force-sets their
            # pose, replay_policy.py:10-68), so the ego takes the full
            # minimum-translation push and loses its closing velocity — the
            # Bullet behavior when a dynamic chassis meets a kinematic body
            # (engine_core.py:350-352). replay_ego force-sets the ego too.
            if cfg["contact_response"] and not cfg["replay_ego"]:
                depth, normal = collision.obb_obb_mtv(
                    ego.pos[:, None, :], ego.heading[:, None],
                    ego.params.length[:, None], ego.params.width[:, None],
                    npc_pos, npc_heading, scene.trk_len[s], scene.trk_wid[s],
                )
                contact = hits & ~is_ped
                push = (torch.where(contact, torch.clamp(depth, min=0.0), 0.0)[..., None]
                        * normal).sum(dim=1)
                mag = torch.sqrt((push ** 2).sum(-1, keepdim=True))
                push = push * torch.clamp(1.0 / torch.clamp(mag, min=1.0), max=1.0)
                scale = collision.contact_speed_scale(ego.speed, ego.heading + ego.vel_dir,
                                                      normal, contact)
                ego = ego.replace(pos=ego.pos + push, speed=ego.speed * scale)
                state = state.replace(ego=ego)

        with trace.stage("advance.navigation", dev):
            # trajectory localization
            pts = scene.sdc_pts[s]
            npts = scene.sdc_npts[s]
            arcl = scene.sdc_arclen[s]
            long, lat = polyline.local_coordinates(pts, npts, ego.pos, s=arcl)
            traj_heading = polyline.heading_at(pts, npts, long, s=arcl)
            total = polyline.total_length(pts, npts, s=arcl)
            route_completion = long / torch.clamp(total, min=1e-3)
            state = state.replace(last_long=state.cur_long, cur_long=long, cur_lat=lat)
            seg_flags = collision.vehicle_segment_flags(
                ego.pos, ego.heading, ego.params.length, ego.params.width,
                *scene.seg_points(state.sidx),
                scene.seg_type[s], scene.seg_halfwidth[s], scene.seg_valid[s],
                (SEG_YELLOW_LINE, SEG_WHITE_LINE, SEG_SIDEWALK),
            )
            # traffic light ahead (BaseTrafficLight contact,
            # base_vehicle.py:720-733): red/yellow within the stop region
            lp = scene.light_pos[s]                                  # [E,LG,2]
            LT = scene.light_status.shape[2]
            lflat = (state.sidx * LT + torch.clamp(state.step_count, 0, LT - 1)).long()
            lstat = scene.light_status_t[lflat]                       # [E,LG]
            ldist = torch.sqrt(((lp - ego.pos[:, None, :]) ** 2).sum(-1))
            near = (ldist < 4.0) & scene.light_valid[s]
            on_red = (near & (lstat == 3)).any(dim=1)
            on_yellow_light = (near & (lstat == 2)).any(dim=1)

            # lane-network localization (need_lane_localization; the reference
            # builds ScenarioLanes from map_features and ray-localizes the ego
            # against them, scenario_map.py:9, edge_network_navigation.py:159):
            # on_lane = the ego centre sits inside some map lane's band.
            # Computed only when something consumes it: with
            # relax_out_of_road_done (the default) out-of-road is the lateral
            # band test and on_lane would be a dead flag
            on_lane = torch.ones(E, dtype=torch.bool, device=dev)
            use_lanes = (self._has_lanes and cfg["need_lane_localization"]
                         and not cfg["relax_out_of_road_done"])
            if use_lanes:
                inside = polyline.in_band(
                    scene.lane_pts[s], scene.lane_npts[s], ego.pos[:, None, :],
                    scene.lane_width[s] / 2,
                ) & scene.lane_valid[s]                                # [E,LN]
                on_lane = inside.any(dim=1)

            ego = ego.replace(
                crash_vehicle=crash_v, crash_human=crash_h,
                on_yellow_line=seg_flags[SEG_YELLOW_LINE],
                on_white_line=seg_flags[SEG_WHITE_LINE],
                crash_sidewalk=seg_flags[SEG_SIDEWALK],
                on_lane=on_lane,
            )
            state = state.replace(ego=ego)

            # done (scenario_env.py:128-196)
            arrive = (route_completion > 0.95) | (total < 2.0)
            if cfg["relax_out_of_road_done"]:
                out_of_road = torch.abs(lat) > cfg["max_lateral_dist"]
            else:
                out_of_road = ego.crash_sidewalk | ego.on_yellow_line | ego.on_white_line
                if use_lanes:
                    # leaving every map lane is out-of-road (lane membership)
                    out_of_road = out_of_road | ~on_lane
            out_of_road = out_of_road | (route_completion < -0.1)
            terminated = arrive | out_of_road
            if cfg["crash_vehicle_done"]:
                terminated = terminated | crash_v
            if cfg["crash_human_done"]:
                terminated = terminated | crash_h
            horizon = cfg["horizon"]
            truncated = state.step_count >= scene.scenario_len[s]
            if horizon is not None:
                truncated = truncated | (state.step_count >= horizon)
            if cfg["truncate_as_terminate"]:
                terminated = terminated | truncated

            # reward (scenario_env.py:216-292)
            reward = cfg["driving_reward"] * (long - state.last_long)
            lateral_penalty = -torch.abs(lat) / cfg["max_lateral_dist"] * cfg["lateral_penalty"]
            heading_diff = torch.abs(wrap_to_pi(ego.heading - traj_heading)) / math.pi
            heading_penalty = -heading_diff * cfg["heading_penalty"]
            allowed_steering = 1.0 / torch.clamp(ego.speed, min=1e-2)
            overflow = torch.clamp(allowed_steering - torch.abs(actions[:, 0]), max=0.0)
            steering_penalty = overflow * cfg["steering_range_penalty"]
            reward = reward + lateral_penalty + heading_penalty + steering_penalty
            if cfg["no_negative_reward"]:
                reward = torch.clamp(reward, min=0.0)
            on_line = ego.on_yellow_line | ego.on_white_line | ego.crash_sidewalk
            reward = torch.where(crash_v, -cfg["crash_vehicle_penalty"], reward)
            reward = torch.where(crash_h, -cfg["crash_human_penalty"], reward)
            reward = torch.where(on_line, -cfg["on_lane_line_penalty"], reward)
            step_reward = reward
            reward = torch.where(arrive, cfg["success_reward"], reward)
            reward = torch.where(~arrive & out_of_road, -cfg["out_of_road_penalty"], reward)

            # cost (scenario_env.py:198-214; additive)
            cost = (torch.where(out_of_road, cfg["out_of_road_cost"], 0.0)
                    + torch.where(crash_v, cfg["crash_vehicle_cost"], 0.0)
                    + torch.where(crash_h, cfg["crash_human_cost"], 0.0))

            episode_reward = state.episode_reward + reward
            episode_cost = state.episode_cost + cost
            state = state.replace(episode_reward=episode_reward, episode_cost=episode_cost)

            done = terminated | truncated
            start = cfg["start_scenario_index"]
            info = {
                "arrive_dest": arrive, "out_of_road": out_of_road,
                "crash_vehicle": crash_v, "crash_human": crash_h,
                "crash": crash_v | crash_h | ego.crash_sidewalk,
                "cost": cost, "total_cost": episode_cost, "step_reward": step_reward,
                "route_completion": route_completion,
                "velocity": ego.speed, "max_step": truncated,
                "on_red_light": on_red, "on_yellow_light": on_yellow_light,
                "episode_reward": episode_reward, "episode_length": state.step_count,
                "env_seed": state.sidx + start,
                # reference step_info extras (scenario_env.py:276-283):
                # navigation.reference_trajectory.length, lateral_now, seed
                "track_length": total,
                "lateral_dist": lat,
                "scenario_index": state.sidx + start,
                "carsize": torch.stack([ego.params.width, ego.params.length], dim=-1),
                TerminationState.SUCCESS: arrive,
                TerminationState.OUT_OF_ROAD: out_of_road,
                TerminationState.CRASH_VEHICLE: crash_v,
                TerminationState.CRASH_HUMAN: crash_h,
            }

            npc_pose = (npc_pos, npc_heading, npc_active)
        with trace.stage("advance.reset", dev):
            if cfg["auto_reset"]:
                new_keys = prng.split(state.rng, 2)                   # [E,2,2]
                step_rng, reset_rng = new_keys[:, 0], new_keys[:, 1]
                cap = state.scenario_cap  # a tensor: a curriculum level-up swaps it
                if cfg["sequential_seed"]:
                    new_sidx = (state.sidx + 1) % cap
                else:
                    new_sidx = prng.randint(step_rng, (), 0, cap)
                fresh = self._spawn(reset_rng, new_sidx)
                # the 0-d act-batch phase is global and not reset per env
                state = tree_map(
                    lambda new, old: old if old.dim() == 0 else torch.where(
                        done.reshape(done.shape + (1,) * (old.dim() - 1)), new, old),
                    fresh, state.replace(rng=step_rng),
                )
                state = state.replace(scenario_cap=cap)
                # refresh the cached obs inputs for re-spawned rows: spawn sits at
                # arc length 0 of the new sdc trajectory; tracks are at t=0
                s = state.sidx.long()
                T0 = scene.trk_pos.shape[2]
                d1 = done[:, None]
                long = torch.where(done, 0.0, long)
                lat = torch.where(done, 0.0, lat)
                traj_heading = torch.where(done, scene.sdc_start_heading[s], traj_heading)
                npc_pose = (
                    torch.where(d1[..., None], scene.trk_pos_t[s * T0], npc_pos),
                    torch.where(d1, scene.trk_heading_t[s * T0], npc_heading),
                    torch.where(d1, scene.trk_valid_t[s * T0], npc_active),
                )

            # advance the global act-batch phase. Because it is global, a freshly
            # auto-reset env's IDM cars refresh at another offset relative to
            # its episode step than the reference's per-car round-robin; every
            # car still refreshes once per IDM_ACT_BATCH_SIZE steps
            state = state.replace(phase=(state.phase + 1) % IDM_ACT_BATCH_SIZE)

        if cfg["auto_reset"]:
            # the spawn computes every row and keeps the done ones
            trace.count("reset.rows", done, dev)
            trace.count("reset.computed", done.shape[0], dev)
        return state, ((long, lat, traj_heading, npc_pose),), reward, terminated, truncated, info
