"""Vectorized env core: one step advances all envs in lockstep.

This is the batched replacement for the reference's engine step protocol
(BaseEnv.step -> engine.before_step/step/after_step,
envs/base_env.py:426-463 + engine/base_engine.py:402-478): the manager loop
becomes a fixed pipeline of batched tensor ops —

    actions -> dynamics (x5 substeps) -> traffic release -> localization
            -> collision flags -> reward/done/cost -> obs -> auto-reset

All state is a `SimState` of tensors [E, ...] on one device; maps are
`Scene` tensors [S, ...] compiled on the host once (mapgen/). Auto-reset
re-spawns done envs in place, sampling a fresh scenario per the
reference's seed cycling (base_env.py:886-891). Random draws go through
the threefry twin in core/prng.py, so resets pick the same scenarios and
spawn slots as the JAX package from the same seed.

A step makes no host synchronisation: every branch is decided on the host
from the config, never from tensor values.
"""
import copy

import numpy as np
import torch

from metadrive_ped_torch.config import Config
from metadrive_ped_torch.constants import (
    BICYCLE_REF_ACCEL, BICYCLE_REF_BRAKE, BICYCLE_REF_WHEELBASE_EFF,
    SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE,
    VEHICLE_CLASS_ORDER, VEHICLE_CLASSES,
)
from metadrive_ped_torch.core import graph, prng, trace
from metadrive_ped_torch.core.device import resolve_device
from metadrive_ped_torch.core.logger import get_logger
from metadrive_ped_torch.core.structs import (
    PAST_POS_STEPS, EgoState, NpcState, PedState, Scene, SimState, VehicleParams, map_tensors,
    take_rows, tree_map,
)
from metadrive_ped_torch.mapgen.scene import (
    OBJ_BUILDING, OBJ_CONE, OBJ_WARNING, PED_WALKER, build_scene_pack,
)
from metadrive_ped_torch.obs import state_obs, top_down
from metadrive_ped_torch.ops import (
    camera, collision, dynamics, idm, lane_geom, localization, mixed_traffic, participants,
    ray_segment,
)
from metadrive_ped_torch.ops.gather import onehot_pick, vector_lookup
from metadrive_ped_torch.ops.math_ops import wrap_to_pi
from metadrive_ped_torch.policies.expert import expert_action, load_expert_params
from metadrive_ped_torch.policies.manual import make_controller

# ---- per-class parameter table (constants.py VEHICLE_CLASSES) -------------
_CLS = [VEHICLE_CLASSES[k] for k in VEHICLE_CLASS_ORDER]
_TBL_MAT = np.stack([
    np.array([c["length"] for c in _CLS], np.float32),
    np.array([c["width"] for c in _CLS], np.float32),
    np.array([BICYCLE_REF_ACCEL * (c["engine"] / c["mass"]) / (800.0 / 1100.0) for c in _CLS],
             np.float32),
    np.array([BICYCLE_REF_BRAKE * (c["brake"] / 130.0) for c in _CLS], np.float32),
    np.array([np.radians(c["steer"]) for c in _CLS], np.float32),
    np.array([c["vmax"] for c in _CLS], np.float32),
    np.array([BICYCLE_REF_WHEELBASE_EFF * c["wheelbase"] / VEHICLE_CLASSES["default"]["wheelbase"]
              for c in _CLS], np.float32),
], axis=-1)  # [5, 7]: length, width, accel, brake, steer, vmax, wheelbase
DEFAULT_CLASS_IDX = VEHICLE_CLASS_ORDER.index("default")


def make_vehicle_params(table, class_idx):
    """VehicleParams of class ids ``class_idx`` from the device copy of
    `_TBL_MAT` (zero rows for ids out of range)."""
    v = vector_lookup(table, class_idx)
    return VehicleParams(
        length=v[..., 0], width=v[..., 1], accel_gain=v[..., 2], brake_gain=v[..., 3],
        max_steer_rad=v[..., 4], max_speed_kmh=v[..., 5], wheelbase_eff=v[..., 6],
    )


# the expert's observation layout (policies/expert.py OBS_DIM = 275)
EXPERT_LIDAR = dict(num_lasers=240, num_others=4)


class VectorEnvLoop:
    """`reset`, `step` and the host-sync-free `rollout` loop of a vector env.

    A subclass gives `device`, `num_envs`, `_reset_state(rng)`,
    `_advance(state, actions, prev_obs)`, `_observe(state, *obs_args)` and
    `_rollout_fields(state)`, the state tensors `rollout` can collect by
    name. The device work of a step is `_advance` then `_observe`: split, so
    that `parallel.ShardedEnv` advances every shard before any observes
    (the lidar noise key reads the whole batch's step counts). The host's
    work around it, `_step_actions` before and `_reset_outputs` /
    `_step_outputs` after, runs once for the whole batch; `_frame_obs`
    builds the rows' user observation from the state observation."""

    # attributes with a row axis (name -> axis), cut to a shard's rows by
    # `_shard`; every other tensor is a constant of the whole batch
    _ROW_AXES = dict(_state=0, _last_obs=0)
    # a shard's first row in the batch, and the batch's step-count sum it
    # is handed before it observes (`parallel.ShardedEnv`)
    _row_offset = 0
    _batch_step_sum = None
    _graphs = None  # core.graph.EnvGraphs, made at the first step on a card
    # the port's spans and counters (core/trace.py), reached through the env
    tracer = trace

    def _as_tensor(self, a, dtype):
        if torch.is_tensor(a):
            return a.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

    def reset(self, seed=0):
        rng = prng.prng_key(0 if seed is None else seed, self.device)
        self._state, obs_args, info = self._reset_state(rng)
        self._last_obs = obs = self._observe(self._state, *obs_args)
        return self._reset_outputs(self._frame_obs(obs, graphs=self._graphs_or_none()), info)

    def _graphs_or_none(self):
        """The env's captured steps (`core.graph.EnvGraphs`), or None on the
        CPU, which has no graphs and runs its steps eagerly."""
        capture = graph.capture_backend(self.device)
        if capture is None:
            return None
        if self._graphs is None:
            self._graphs = graph.EnvGraphs(capture, self.device)
        return self._graphs

    def step(self, actions):
        """One step of every env: the host's action conversion, the rows'
        step on the device, the host's bookkeeping. On a CUDA device the
        device work is one replay of the captured `_step_impl`
        (core/graph.py); on the CPU it runs op by op."""
        return self._step(actions, self._graphs_or_none())

    def _step_eager(self, actions):
        """`step` with the device work dispatched op by op, on any device.
        Nothing chooses it: it is called by name, to profile the eager
        step."""
        return self._step(actions, None)

    def _step(self, actions, graphs):
        with trace.span("env.step"):
            with trace.span("step.actions"):
                actions = self._step_actions(actions)
            if graphs is None:
                self._state, obs, reward, terminated, truncated, info = self._step_impl(
                    self._state, actions, self._prev_obs())
                self._last_obs = obs
            else:
                obs, reward, terminated, truncated, info = graphs.step(self, actions)
            with trace.span("step.frame_obs"):
                obs = self._frame_obs(obs, terminated, truncated, graphs)
            with trace.span("step.outputs"):
                return self._step_outputs(obs, reward, terminated, truncated, info)

    def _step_impl(self, state, actions, prev_obs=None):
        with trace.stage("advance", self.device):
            state, obs_args, reward, terminated, truncated, info = self._advance(
                state, actions, prev_obs)
        with trace.stage("observe", self.device):
            obs = self._observe(state, *obs_args)
        return state, obs, reward, terminated, truncated, info

    # ---- hooks --------------------------------------------------------------
    def _step_actions(self, actions):
        """Host side, before a step: the user's actions -> [rows, 2] float32."""
        return self._as_tensor(actions, torch.float32).reshape(self.num_envs, 2)

    def _prev_obs(self):
        """The last observation a step reads (None: the step reads none)."""
        return None

    def _frame_obs(self, obs, terminated=None, truncated=None, graphs=None):
        """The rows' observation for the user from the state observation
        ``obs``; called without the done flags at reset, where per-row
        buffers start afresh. Device work of its own replays ``graphs``'s
        (`core.graph.EnvGraphs`; None: op by op)."""
        return obs

    def _reset_outputs(self, obs, info):
        """Host side, after reset: what `reset` returns."""
        return obs, info

    def _step_outputs(self, obs, reward, terminated, truncated, info):
        """Host side, after a step: what `step` returns."""
        return obs, reward, terminated, truncated, info

    def _shard(self, r0, r1, device):
        """A view of rows [r0, r1) of this env on ``device``: a shallow copy
        whose tensors lie on ``device``, those of `_ROW_AXES` cut to the
        rows. It steps its rows as the whole env steps them; its host
        bookkeeping is unused (`parallel.ShardedEnv` runs that on the whole
        batch)."""
        view = copy.copy(self)
        for name, value in vars(self).items():
            if name in self._ROW_AXES:
                value = take_rows(value, r0, r1, self._ROW_AXES[name])
            setattr(view, name, map_tensors(lambda t: t.to(device), value))
        view.device, view.num_envs, view._row_offset = device, r1 - r0, r0
        # not the env's graphs: parallel.ShardedEnv replays the view's step
        # graphs (core.graph.ShardedGraphs); the view keeps its frame graph
        view._graphs = None
        return view

    def rollout(self, n_steps, policy_fn=None, actions=None, collect=("reward",)):
        """Run n_steps with no host synchronisation inside the loop.
        policy_fn(obs, state) -> [E,2] actions; or fixed ``actions``.
        Returns (dict of collected tensors stacked over steps, mean_reward);
        the mean reward is read on the host once, after the loop, when
        ``reward`` is collected. On a CUDA device each step is one replay of
        the step captured for (policy_fn, collect, num_scenarios, shapes),
        captured at the first call for that key (core/graph.py); on the CPU
        the loop runs op by op. Where the env renders frames (`_frames`),
        every step also renders the stepped state's frame and rolls the
        image stack, which ``"image"`` collects as `step` returns it, and
        which a `step` after the rollout continues."""
        self._check_collect(collect)
        with trace.span("env.rollout"):
            graphs = self._graphs_or_none()
            with trace.stage("rollout", self.device):
                if graphs is None:
                    return self._rollout_eager(n_steps, policy_fn, actions, collect)
                outs = graphs.rollout(self, n_steps, policy_fn, self._fixed_actions(actions),
                                      collect)
            return outs, _mean_reward(outs)

    def _fixed_actions(self, actions):
        return (self._as_tensor(actions, torch.float32) if actions is not None
                else torch.zeros((self.num_envs, 2), device=self.device))

    def _rollout_eager(self, n_steps, policy_fn=None, actions=None, collect=("reward",)):
        """`rollout` dispatched op by op, on any device. Nothing chooses it on
        a CUDA device: it is called by name, to hold the replayed rollout
        against it and to profile the eager step."""
        self._check_collect(collect)
        fixed = self._fixed_actions(actions)
        state, obs = self._state, self._last_obs
        stack = self._img_stack if self._frames() else None
        outs = {k: [] for k in collect}
        for _ in range(n_steps):
            act = policy_fn(obs, state) if policy_fn is not None else fixed
            state, obs, reward, term, trunc, info = self._step_impl(state, act)
            special = dict(reward=reward, obs=obs, terminated=term, truncated=trunc,
                           **self._rollout_fields(state))
            if stack is not None:
                special["image"] = stack = self._rolled_stack(state, stack)
            for k in collect:
                outs[k].append(special[k] if k in special else info[k])
        self._state, self._last_obs = state, obs
        if stack is not None:
            self._img_stack = stack
        outs = {k: tree_map(lambda *xs: torch.stack(xs), *v) for k, v in outs.items()}
        return outs, _mean_reward(outs)

    # ---- the image stack of a rollout ----------------------------------------
    def _frames(self):
        """Whether every step renders a frame into the image stack
        (`_img_stack`), which `rollout` then carries and collects as
        ``"image"``."""
        return False

    def _rolled_stack(self, state, stack):
        """The image stack after a step to ``state``."""
        raise NotImplementedError

    def _check_collect(self, collect):
        if "image" in collect and not self._frames():
            raise ValueError('"image" is collected only where the env renders frames '
                             "(image_observation=True)")


def _mean_reward(outs):
    return float(outs["reward"].mean()) if "reward" in outs else 0.0


def _roll(stack, frame):
    """The frame stack [E, H, W, C, K] rolled by one, ``frame`` [E, H, W, C]
    newest (last): ImageObservation.observe's roll."""
    return torch.cat([stack[..., 1:], frame[..., None]], dim=-1)


class BaseVectorEnv(VectorEnvLoop):
    """Shared machinery; reward/done/cost live in subclasses
    (mirrors BaseEnv -> MetaDriveEnv in the reference)."""

    _ROW_AXES = dict(VectorEnvLoop._ROW_AXES, _img_stack=0)

    @classmethod
    def default_config(cls) -> Config:
        return Config(
            dict(
                num_envs=16,
                start_seed=0,
                num_scenarios=1,
                # per-process scenario striding for multi-host data parallel
                # (scenario_data_manager.py:26-32, applied to PG seeds):
                # host w of W compiles and samples seeds start_seed+w,
                # start_seed+w+W, ...
                worker_index=0,
                num_workers=1,
                map=3,  # int block count or block-ID string (pg_map.py:17-36)
                map_config=dict(lane_width=3.5, lane_num=3, exit_length=50.0,
                                # the reference's BaseMap GENERATE_TYPE /
                                # GENERATE_CONFIG keys (base_map.py:30-41):
                                # config overrides the top-level `map`
                                type=None, config=None,
                                xodr_file=None,  # OpenDrive ingest (mapgen/opendrive.py)
                                # CityBIG growth instead of linear BIG
                                # (component/map/city_map.py:97-113)
                                city_map=False),
                # pre-compiled scene pack (PGMapManager.load_all_maps,
                # pg_map_manager.py:112-133)
                map_pack_file=None,
                # per-seed lane width/count variation
                # (PGMapManager.add_random_to_map, pg_map_manager.py:66-74)
                random_lane_width=False,
                random_lane_num=False,
                traffic_density=0.1,
                # ego spawns on a random entrance lane per episode
                # (metadrive_env.py:59; agent_manager.py:107-112)
                random_spawn_lane_index=True,
                traffic_mode="trigger",  # "trigger" | "respawn" | "hybrid"
                # MixedPGTrafficManager share of expert-driven NPCs
                # (traffic_manager.py:367-418)
                rl_agent_ratio=0.0,
                accident_prob=0.0,       # metadrive_env.py:51
                static_traffic_object=True,
                # opt-in traffic lights at PG intersection approaches
                # (cycle green/yellow durations in env steps)
                pg_traffic_lights=False,
                pedestrian_density=0.0,  # participants on PG maps
                horizon=None,
                truncate_as_terminate=False,
                auto_reset=True,
                # discrete action interface (env_input_policy.py:9-69)
                discrete_action=False,
                use_multi_discrete=False,
                discrete_steering_dim=5,
                discrete_throttle_dim=5,
                # agent policy family (policy/lange_change_policy.py,
                # AI_protect_policy.py, manual_control_policy.py)
                agent_policy=None,        # None | "lane_change"
                use_AI_protector=False,
                save_level=0.5,
                manual_control=False,
                controller="keyboard",
                # per-episode randomized dynamics (varying_dynamics_env.py);
                # dict of param -> (min, max) or None
                random_dynamics=None,
                # sample the agent's vehicle class uniformly per episode and
                # prepend length/width obs features (agent_manager.py:41,
                # state_obs.py:69-75)
                random_agent_model=False,
                decision_repeat=5,
                physics_world_step_size=0.02,
                # rigid contact resolution between ego and NPC/object bodies
                # (Bullet resolves contacts every doPhysics,
                # engine_core.py:350-352). Off = flags only.
                contact_response=True,
                # terrain (base_env.py:219-223): the simulation runs on an
                # implicit flat plane; use_mesh_terrain=True raises
                use_mesh_terrain=False,
                height_scale=50,
                show_terrain=True,
                # realtime window (base_env.py use_render): always headless;
                # True raises
                use_render=False,
                window_size=(1200, 900),
                log_level=None,
                # HUD / realtime interface: accepted and ignored (no window)
                show_interface=True,
                show_fps=True,
                show_logo=True,
                show_coordinates=False,
                # camera observation family (obs/image_obs.py +
                # component/sensors/*_camera.py; rendered by the ray-cast
                # camera, ops/camera.py, or the mini map, obs/top_down.py)
                image_observation=False,
                norm_pixel=True,
                stack_size=3,
                image_source="main_camera",
                sensors=dict(main_camera=("rgb", 84, 84)),
                camera=dict(fov=66.0, pitch=0.0, height=1.4, max_dist=50.0),
                vehicle_config=dict(
                    enable_reverse=False,
                    max_engine_force=800.0,
                    max_brake_force=130.0,
                    max_steering=40.0,
                    max_speed_km_h=80.0,
                    lidar=dict(num_lasers=240, distance=50.0, num_others=0,
                               gaussian_noise=0.0, dropout_prob=0.0,
                               add_others_navi=False),
                    side_detector=dict(num_lasers=0, distance=50.0),
                    lane_line_detector=dict(num_lasers=0, distance=20.0),
                ),
                # reward/cost/termination scheme (metadrive_env.py:68-89)
                success_reward=10.0,
                out_of_road_penalty=5.0,
                crash_vehicle_penalty=5.0,
                crash_object_penalty=5.0,
                driving_reward=1.0,
                speed_reward=0.1,
                use_lateral_reward=False,
                crash_vehicle_cost=1.0,
                crash_object_cost=1.0,
                out_of_road_cost=1.0,
                out_of_route_done=False,
                on_continuous_line_done=True,
                crash_vehicle_done=True,
                crash_object_done=True,
                crash_human_done=True,
            )
        )

    def __init__(self, config=None, device=None):
        self.device = resolve_device(device)
        self.config = self.default_config()
        if config:
            # `sensors` replaces wholesale (users name their own sensors)
            self.config.update(config, stop_recursive_update=("sensors",))
        cfg = self.config
        if cfg["use_render"]:
            raise NotImplementedError(
                "use_render=True: there is no realtime window; every env is headless"
            )
        if cfg["use_mesh_terrain"]:
            raise NotImplementedError(
                "use_mesh_terrain=True: the simulation runs on an implicit flat plane"
            )
        lidar = cfg["vehicle_config"]["lidar"]
        if cfg["agent_policy"] == "lane_change":
            # LaneChangePolicy forces discrete 3-way steering [right, keep,
            # left] (lange_change_policy.py:17-24); the exception type is the
            # JAX package's
            if not cfg["discrete_action"]:
                raise AssertionError("Must set discrete_action=True for using LaneChangePolicy")
            cfg.force_set("discrete_steering_dim", 3)
        if cfg["use_AI_protector"]:
            if any(lidar[k] != v for k, v in EXPERT_LIDAR.items()):
                raise AssertionError(
                    "AI protector needs the expert observation layout (lidar num_lasers=240, "
                    "num_others=4), like the reference's expert obs-mismatch guard "
                    "(AI_protect_policy.py:16-21)")
            self._expert_params = load_expert_params(device=self.device)
        if cfg["rl_agent_ratio"] > 0:
            if lidar["num_lasers"] != EXPERT_LIDAR["num_lasers"]:
                raise ValueError("expert-driven NPCs (rl_agent_ratio > 0) cast the expert's 240 "
                                 "lidar rays: set vehicle_config.lidar.num_lasers=240")
            self._npc_expert_params = load_expert_params(device=self.device)
        # host-side human input for env row 0 (ManualControlPolicy)
        self._manual_controller = (make_controller(cfg["controller"]) if cfg["manual_control"]
                                   else None)
        # the lidar noise key is fold_in(PRNGKey(0), sum of step counts)
        self._noise_key = prng.prng_key(0, self.device)
        if cfg["log_level"] is not None:
            get_logger().setLevel(cfg["log_level"])
        seeds = list(range(cfg["start_seed"], cfg["start_seed"] + cfg["num_scenarios"]))
        if cfg["num_workers"] > 1:
            seeds = seeds[cfg["worker_index"]::cfg["num_workers"]]
            assert seeds, "num_scenarios leaves this worker without seeds"
        map_cfg = dict(cfg["map_config"])
        if map_cfg.get("config") is None:
            map_cfg["config"] = cfg["map"]
        if cfg["map_pack_file"]:
            import pickle
            with open(cfg["map_pack_file"], "rb") as f:
                pack = pickle.load(f)["pack"]
        else:
            pack = build_scene_pack(
                seeds,
                dict(
                    include_broken_line_segs=(
                        cfg["vehicle_config"]["lane_line_detector"]["num_lasers"] > 0
                    ),
                    random_lane_width=cfg["random_lane_width"],
                    random_lane_num=cfg["random_lane_num"],
                    map_config=map_cfg,
                    traffic_density=cfg["traffic_density"],
                    accident_prob=cfg["accident_prob"],
                    pedestrian_density=cfg["pedestrian_density"],
                    spawn_roads=cfg.get("spawn_roads"),
                    spawn_dest_nodes=cfg.get("spawn_dest_nodes"),
                    pg_traffic_lights=cfg["pg_traffic_lights"],
                    rl_agent_ratio=cfg["rl_agent_ratio"],
                ),
            )
        # the host pack stays for host-side consumers (the episode exporter,
        # scenario/recorder.py, reads the map from it)
        self._pack = pack
        self.scene = Scene.from_pack(pack, self.device)
        get_logger().info(
            "compiled %d PG scene(s): %d lane slots, %d NPC slots, %d boundary segs",
            pack["lane_kind"].shape[0], pack["lane_kind"].shape[1],
            pack["npc_lane"].shape[1], pack["seg_p0"].shape[1],
        )
        self.num_scenarios = int(self.scene.num_scenarios)
        self.num_envs = cfg["num_envs"]
        self._state = None
        self._last_obs = None
        self._img_stack = None  # [E, H, W, C, stack_size] with image_observation
        self._textures = None   # the baked BEV map layers (`_map_textures`)
        # device constants, made once so that a step copies nothing from
        # the host
        dev = self.device
        self._class_table = torch.as_tensor(_TBL_MAT).to(dev)
        self._seeds = torch.as_tensor(np.asarray(seeds, np.int32)).to(dev)
        # static (host-side) check: does any compiled scene carry a
        # cone/warning object or a pedestrian walker?
        self._has_cylinders = bool(
            (pack["obj_valid"] & np.isin(pack["obj_kind"], (OBJ_CONE, OBJ_WARNING))).any()
            or (pack["ped_valid"] & (pack["ped_kind"] == PED_WALKER)).any()
        )
        self._set_target_layout(extra=0)
        N = pack["npc_lane"].shape[1]
        self._npc_timer0 = (torch.arange(N, dtype=torch.int32, device=dev) * 17) % 50
        # the detectors' per-scenario line table, built once: no step
        # gathers or dequantizes segments for them
        vc = cfg["vehicle_config"]
        self._line_table = None
        if vc["side_detector"]["num_lasers"] > 0 or vc["lane_line_detector"]["num_lasers"] > 0:
            self._line_table = ray_segment.build_line_table(
                self.scene, include_broken=vc["lane_line_detector"]["num_lasers"] > 0)

    def _set_target_layout(self, extra):
        """Slices of the lidar/contact target axis: NPCs, static objects,
        pedestrians, then ``extra`` vehicle bodies per row (the other agents
        of a multi-agent env), and the share of the contact push the ego
        takes against each: half against NPCs and agents (they take the
        other half), all of it against static objects."""
        N, O, P = (self._pack[k].shape[1] for k in ("npc_lane", "obj_pos", "ped_lane"))
        self._target_slices = dict(
            npc=slice(0, N), obj=slice(N, N + O), ped=slice(N + O, N + O + P),
            agents=slice(N + O + P, N + O + P + extra),
        )
        frac = np.zeros(N + O + P + extra, np.float32)
        frac[:N] = 0.5
        frac[N:N + O] = 1.0
        frac[N + O + P:] = 0.5
        self._push_frac = torch.as_tensor(frac).to(self.device)

    # ------------------------------------------------------------------ API
    @property
    def observation_dim(self):
        vc = self.config["vehicle_config"]
        return state_obs.obs_dim(
            vc["lidar"]["num_lasers"], vc["lidar"]["num_others"],
            side_lasers=vc["side_detector"]["num_lasers"],
            lane_line_lasers=vc["lane_line_detector"]["num_lasers"],
            random_agent_model=self.config["random_agent_model"],
        )

    @property
    def observation_space(self):
        import gymnasium as gym
        state_space = gym.spaces.Box(-0.0, 1.0, shape=(self.observation_dim,), dtype=np.float32)
        if not self.config["image_observation"]:
            return state_space
        modality, w, h = self._sensor_spec()
        shape = (h, w, 1 if modality == "depth" else 3, self.config["stack_size"])
        img_space = (gym.spaces.Box(-0.0, 1.0, shape=shape, dtype=np.float32)
                     if self.config["norm_pixel"]
                     else gym.spaces.Box(0, 255, shape=shape, dtype=np.uint8))
        return gym.spaces.Dict({"image": img_space, "state": state_space})

    @property
    def action_space(self):
        import gymnasium as gym
        cfg = self.config
        if cfg["discrete_action"]:
            if cfg["use_multi_discrete"]:
                return gym.spaces.MultiDiscrete(
                    [cfg["discrete_steering_dim"], cfg["discrete_throttle_dim"]])
            return gym.spaces.Discrete(cfg["discrete_steering_dim"] * cfg["discrete_throttle_dim"])
        return gym.spaces.Box(-1.0, 1.0, shape=(2,), dtype=np.float32)

    def _convert_actions(self, actions):
        """Discrete / MultiDiscrete -> continuous
        (env_input_policy.py:40-48 convert_to_continuous_action)."""
        cfg = self.config
        if not cfg["discrete_action"]:
            return self._as_tensor(actions, torch.float32).reshape(self.num_envs, 2)
        s_dim, t_dim = cfg["discrete_steering_dim"], cfg["discrete_throttle_dim"]
        s_unit, t_unit = 2.0 / (s_dim - 1), 2.0 / (t_dim - 1)
        a = self._as_tensor(actions, torch.int64)
        if cfg["use_multi_discrete"]:
            a = a.reshape(self.num_envs, 2)
            steering = a[:, 0].float() * s_unit - 1.0
            throttle = a[:, 1].float() * t_unit - 1.0
        else:
            a = a.reshape(self.num_envs)
            steering = (a % s_dim).float() * s_unit - 1.0
            throttle = (a // s_dim).float() * t_unit - 1.0
        return torch.stack([steering, throttle], dim=-1)

    def _step_actions(self, actions):
        """The converted actions; with manual_control, the controller is read
        on the host before the step and its action replaces row 0's."""
        actions = self._convert_actions(actions)
        if self._manual_controller is not None:
            manual = self._manual_controller.process_input()
            if manual is not None:
                manual = torch.as_tensor(np.asarray(manual, np.float32)).to(self.device)
                actions = torch.cat([manual.reshape(1, 2), actions[1:]])
        return actions

    def _prev_obs(self):
        """With use_AI_protector, the expert reads the previous observation;
        only `step` passes it, so `rollout` runs without the protector, as
        the JAX package's does."""
        return self._last_obs if self.config["use_AI_protector"] else None

    def _frame_obs(self, obs, terminated=None, truncated=None, graphs=None):
        """With image_observation, {"image": the frame stack, "state": obs};
        the stack starts afresh at reset."""
        if not self.config["image_observation"]:
            return obs
        if terminated is None:
            self._img_stack = None
        return self._image_obs(obs, graphs)

    # ---- camera observation (ImageStateObservation, obs/image_obs.py:16-44;
    #      the frame stack of ImageObservation.observe: roll, newest last) --
    def _sensor_spec(self):
        cfg = self.config
        modality, w, h = cfg["sensors"][cfg["image_source"]]
        return str(modality), int(w), int(h)

    def _map_textures(self):
        """The BEV map layers of every scenario on the device (textures
        [S, 3, H, W], origins [S, 2]), baked on first use."""
        if self._textures is None:
            self._textures = top_down.bake_map_textures(self._pack, self.scene.num_scenarios,
                                                         self.device)
        return self._textures

    def _render_frame(self, state):
        """The image source's frame [E, H, W, C] float32 in [0, 1]."""
        modality, w, h = self._sensor_spec()
        if modality == "mini_map":
            # the MiniMap sensor (component/sensors/mini_map.py): a BEV
            # camera above the vehicle aimed 20 m ahead, from the baked map
            return top_down.observe_mini_map(*self._map_textures(), state.sidx, state.ego,
                                             state.npc, width=w, height=h)
        targets, _ = self._lidar_targets(state)
        cam = self.config["camera"]
        out = camera.render(
            self.scene, state.sidx, state.ego, targets, self._target_slices,
            self.scene.obj_kind[state.sidx.long()], width=w, height=h, fov_deg=cam["fov"],
            pitch_deg=cam["pitch"], cam_height=cam["height"], max_dist=cam["max_dist"])
        return out[modality]

    def _frame(self, state):
        """The frame as the observation stacks it: `_render_frame`, or
        without norm_pixel uint8, frame * 255 truncated; the tracer's stage
        `camera`."""
        with trace.stage("camera", self.device):
            frame = self._render_frame(state)
            return frame if self.config["norm_pixel"] else (frame * 255).to(torch.uint8)

    def _image_obs(self, state_vec, graphs=None):
        """{"image": the frame stack [E, H, W, C, stack_size], "state":
        state_vec}. With ``graphs`` (`step` and `reset` on a CUDA device)
        the frame is a replay of the captured `_frame`
        (`core.graph.EnvGraphs.frame`, the counterpart of the JAX package's
        ``_render_jit``); without, it runs op by op. The stack stays on the
        device; `reset` clears it."""
        frame = (self._frame(self._state) if graphs is None
                 else graphs.frame(self, self._sensor_spec(), self._frame))
        if self._img_stack is None:
            self._img_stack = frame.new_zeros(frame.shape + (self.config["stack_size"],))
        self._img_stack = _roll(self._img_stack, frame)
        return {"image": self._img_stack, "state": state_vec}

    def _frames(self):
        return self.config["image_observation"]

    def _rolled_stack(self, state, stack):
        return _roll(stack, self._frame(state))

    def _rollout_fields(self, state):
        return dict(
            ego_pos=state.ego.pos, ego_heading=state.ego.heading,
            ego_speed=state.ego.speed, ego_action=state.ego.current_action,
            npc_pos=state.npc.pos, npc_heading=state.npc.heading,
            npc_speed=state.npc.speed, npc_active=state.npc.active,
            step_count=state.step_count,
            state=state,
        )

    def render(self, mode="topdown", **kwargs):
        """An RGB uint8 frame of one env as a numpy array (reference:
        BaseEnv.render and the pygame TopDownRenderer,
        obs/top_down_renderer.py). Modes: "topdown" / "top_down" / "bev" /
        "top_down_plt" (BEV map and object stamps), "rgb_array" / "camera"
        (the ray-cast camera) and "dashboard"; ``kwargs`` go to the
        renderer (env_index, size, width, height, ...)."""
        from metadrive_ped_torch.obs.render import (
            render_dashboard, render_rgb_array, render_topdown,
        )
        if self._state is None:
            raise RuntimeError("call reset() before render()")
        if mode in ("topdown", "top_down", "bev", "top_down_plt"):
            return render_topdown(self, **kwargs)
        if mode in ("rgb_array", "camera"):
            return render_rgb_array(self, **kwargs)
        if mode == "dashboard":
            return render_dashboard(self, **kwargs)
        raise ValueError(f"unknown render mode {mode!r}")

    # -- fault injection and state snapshots (the reference's record/replay
    #    substrate, base_engine.py:480-487: the whole [E, ...] state tree is
    #    the episode state, so checkpoint and resume are tree copies) -------
    def set_break_down(self, rows=None, break_down=True):
        """In-sim fault injection (vehicle.set_break_down,
        base_vehicle.py:939-941): the selected rows' vehicles stop
        responding to actions until un-set or respawned. ``rows`` is a bool
        mask [rows], an index list, or None for all rows."""
        st = self._state
        if st is None:
            raise RuntimeError("reset() the env before injecting faults")
        flags = st.ego.break_down.clone()
        if rows is None:
            flags[:] = break_down
        else:
            flags[torch.as_tensor(rows, device=self.device)] = break_down
        self._state = st.replace(ego=st.ego.replace(break_down=flags))

    def snapshot(self):
        """The full simulation state as a host tree of numpy arrays, copied
        (a replayed step overwrites the state's buffers in place)."""
        return tree_map(lambda x: x.detach().to("cpu", copy=True).numpy(), self._state)

    def restore(self, snap):
        """Restore a snapshot taken from an env with the same config: every
        leaf goes back to the device with its dtype (the PRNG keys are int64
        holding uint32 words), and the last observation is recomputed."""
        self._state = tree_map(lambda x: torch.from_numpy(np.array(x)).to(self.device), snap)
        zeros = torch.zeros(self.num_envs, device=self.device)
        self._last_obs = self._observe(self._state, zeros, zeros)

    def record_episode(self, n_steps, policy_fn=None, actions=None):
        """Per-frame recording (RecordManager, manager/record_manager.py):
        a frame is the full state tree, so the recording is the stacked
        tree [T, rows, ...] with obs, reward, done and the applied action,
        as numpy trees that pickle. Any frame restores exactly
        (`replay_frame`). Memory is T times the live state."""
        outs, _ = self.rollout(
            n_steps, policy_fn=policy_fn, actions=actions,
            collect=("state", "obs", "reward", "terminated", "truncated", "ego_action"))
        return {k: tree_map(lambda x: x.detach().cpu().numpy(), v) for k, v in outs.items()}

    def replay_frame(self, recording, t):
        """ReplayManager force-set (manager/replay_manager.py): restore the
        world as it was after recorded step ``t`` and return the obs; stepping
        on with the recorded actions reproduces the recorded future."""
        self.restore(tree_map(lambda x: x[t], recording["state"]))
        return self._last_obs

    def dump_all_maps(self, path):
        """Write the compiled scene pack to a pickle
        (PGMapManager.dump_all_maps, pg_map_manager.py:92-110); an env with
        map_pack_file=path skips map generation."""
        import pickle
        with open(path, "wb") as f:
            pickle.dump(dict(pack=self._pack, num_scenarios=self.config["num_scenarios"],
                             start_seed=self.config["start_seed"]), f)
        return path

    def get_map_features(self, scenario_index=0):
        """Lane centerlines and boundary lines of one compiled scenario as an
        SD map_features dict (BaseMap.get_map_features, base_map.py:163-172;
        drawn by `scenario.utils.draw_map`)."""
        from metadrive_ped_torch.scenario.recorder import _map_features
        return _map_features(self._pack, int(scenario_index))

    def close(self):
        self._state = None
        self._graphs = None

    # -------------------------------------------------------------- spawning
    def _spawn(self, rng, sidx, slot=None):
        """Fresh per-env episode state for scenario indices sidx [E],
        spawning at ``slot`` [E] (default: a random valid spawn slot with
        random_spawn_lane_index, else slot 0)."""
        scene = self.scene
        E = sidx.shape[0]
        s = sidx.long()
        dev = self.device
        if slot is None:
            if self.config["random_spawn_lane_index"]:
                # uniform over the scenario's valid spawn slots
                SLOT = scene.slot_valid.shape[1]
                noise = prng.uniform(prng.fold_in(rng, 79), (SLOT,))
                score = torch.where(scene.slot_valid[s], noise, -1.0)
                slot = score.argmax(dim=1).to(torch.int32)  # first max, as the JAX one-hot
            else:
                slot = torch.zeros(E, dtype=torch.int32, device=dev)
        ego = self._spawn_ego(rng, s, slot)
        zeros = ego.speed  # the ego's zeros [E], shared (one fill fewer)
        npc_long = scene.npc_long[s]
        nz = torch.zeros_like(npc_long)
        # Respawn: all NPCs live immediately. Trigger/Hybrid: released when
        # the ego enters the trigger road (traffic_manager.py:20-29, 69).
        active = scene.npc_valid[s]
        npc = NpcState(
            pos=scene.npc_spawn_pos[s], heading=scene.npc_spawn_heading[s],
            speed=nz, vel_dir=nz, lane=scene.npc_lane[s], active=active,
            released=active if self.config["traffic_mode"] == "respawn" else torch.zeros_like(active),
            heading_pid_i=nz, heading_pid_e=nz, lateral_pid_i=nz, lateral_pid_e=nz,
            # staggered overtake timers (the reference seeds them randomly,
            # idm_policy.py:231)
            overtake_timer=self._npc_timer0.expand(E, -1).clone(),
            params=make_vehicle_params(self._class_table, scene.npc_class[s]),
        )
        ped_long = scene.ped_long[s]
        ped = PedState(long=ped_long, direction=torch.ones_like(ped_long),
                       active=scene.ped_valid[s])
        return SimState(
            rng=rng, sidx=sidx, step_count=torch.zeros(E, dtype=torch.int32, device=dev),
            episode_reward=zeros, episode_cost=zeros, episode_energy=zeros,
            dead_timer=torch.zeros(E, dtype=torch.int32, device=dev),
            scenario_cap=torch.full((E,), self.num_scenarios, dtype=torch.int32, device=dev),
            aux=torch.zeros((E, 4), device=dev), policy_state=torch.zeros((E, 4), device=dev),
            ego=ego, npc=npc, ped=ped,
        )

    def _spawn_ego(self, rng, s, slot):
        """The ego part of `_spawn`: a fresh vehicle at spawn ``slot`` [E] of
        scenarios ``s`` [E] (int64)."""
        scene = self.scene
        E = s.shape[0]
        dev = self.device
        # spawn poses come from the host-computed tables (core/structs.py)
        spawn_lane = onehot_pick(scene.slot_lane[s], slot)
        pos = scene.slot_pos[s, slot.long()]
        heading = onehot_pick(scene.slot_heading[s], slot)
        zeros = torch.zeros(E, device=dev)
        false = torch.zeros(E, dtype=torch.bool, device=dev)
        return EgoState(
            pos=pos, heading=heading, speed=zeros, vel_dir=zeros,
            steering=zeros, throttle=zeros,
            last_action=torch.zeros((E, 2), device=dev),
            current_action=torch.zeros((E, 2), device=dev),
            last_pos=pos, last_heading=heading,
            lane=spawn_lane, route_idx=torch.zeros(E, dtype=torch.int32, device=dev),
            slot=slot, on_lane=torch.ones(E, dtype=torch.bool, device=dev),
            crash_vehicle=false, crash_object=false, crash_human=false,
            crash_building=false, crash_sidewalk=false,
            on_yellow_line=false, on_white_line=false, out_of_route=false,
            past_pos=pos[:, None, :].repeat(1, PAST_POS_STEPS, 1),
            break_down=false,
            params=self._ego_params(rng, E),
        )

    def _ego_params(self, rng, E):
        """Default-class params, optionally re-sampled per episode from the
        random_dynamics ranges (varying_dynamics_env.py:28-49)."""
        dev = self.device
        if self.config["random_agent_model"]:
            # uniform class draw per episode (vehicle_type.py:269-282)
            cls = prng.randint(prng.fold_in(rng, 78), (), 0, len(VEHICLE_CLASS_ORDER))
            base = make_vehicle_params(self._class_table, cls)
        else:
            base = make_vehicle_params(
                self._class_table, torch.full((E,), DEFAULT_CLASS_IDX, dtype=torch.int32, device=dev))
        full = lambda v: torch.full((E,), float(v), device=dev)
        # user vehicle_config overrides (base_vehicle.py:447-484), applied
        # when set away from the defaults
        vc = self.config["vehicle_config"]
        if vc["max_engine_force"] != 800.0:
            base = base.replace(accel_gain=full(
                BICYCLE_REF_ACCEL * (vc["max_engine_force"] / 1100.0) / (800.0 / 1100.0)))
        if vc["max_brake_force"] != 130.0:
            base = base.replace(brake_gain=full(BICYCLE_REF_BRAKE * (vc["max_brake_force"] / 130.0)))
        if vc["max_steering"] != 40.0:
            base = base.replace(max_steer_rad=full(np.radians(vc["max_steering"])))
        if vc["max_speed_km_h"] != 80.0:
            base = base.replace(max_speed_kmh=full(vc["max_speed_km_h"]))
        rd = self.config["random_dynamics"]
        if not rd:
            return base
        draws = prng.uniform(prng.fold_in(rng, 77), (5,))  # [E,5]

        def rng_range(i, lo_hi, default):
            if lo_hi is None:
                return full(default)
            lo, hi = lo_hi
            return lo + draws[:, i] * (hi - lo)

        engine = rng_range(0, rd.get("max_engine_force"), 800.0)
        brake = rng_range(1, rd.get("max_brake_force"), 130.0)
        steer = rng_range(2, rd.get("max_steering"), 40.0)
        mass = rng_range(3, rd.get("mass"), 1100.0)
        # wheel_friction scales how sharply the car can actually turn
        fric = rng_range(4, rd.get("wheel_friction"), 0.9)
        return base.replace(
            accel_gain=BICYCLE_REF_ACCEL * (engine / mass) / (800.0 / 1100.0),
            brake_gain=BICYCLE_REF_BRAKE * (brake / 130.0),
            max_steer_rad=torch.deg2rad(steer),
            wheelbase_eff=base.wheelbase_eff * torch.clamp(0.9 / fric, 0.5, 2.0),
        )

    def _seed_of(self, sidx):
        """Local scenario index -> global seed."""
        if self.config["num_workers"] <= 1:
            return sidx + self.config["start_seed"]
        return vector_lookup(self._seeds, sidx)

    def _reset_state(self, rng):
        """(state, the `_observe` arguments, info) of a reset of every env."""
        E = self.num_envs
        keys = prng.split(rng, E + 1)
        # scenario assignment: uniform over [0, num_scenarios)
        # (reference _reset_global_seed, base_env.py:886-891)
        sidx = prng.randint(keys[0], (E,), 0, self.num_scenarios)
        state = self._spawn(keys[1:], sidx)
        ego_long = self.scene.slot_long[sidx.long(), state.ego.slot.long()]
        return state, (ego_long, torch.zeros(E, device=self.device)), dict(
            env_seed=self._seed_of(sidx))

    def _extra_vehicle_targets(self, state):
        """Hook: further vehicle bodies of each row (multi-agent envs: the
        other agents of the same env), as (pos, heading, len, wid, active)
        [E,X,...], or None. X is the ``extra`` of `_set_target_layout`."""
        return None

    def _override_kinematics(self, state, ego, dt, rep):
        """Hook: replace the bicycle-model pose of selected rows (rule-based
        agents that advance along their lane); default no change."""
        return ego

    def _freeze_mask(self, state):
        """Hook: [E] bool of rows whose ego stays frozen this step
        (multi-agent delay-done corpses), or None when none is."""
        return None

    def _lidar_targets(self, state):
        """(pos, heading, len, wid, active) [E,T,...] of every lidar-visible
        and collidable body: NPC vehicles + static traffic objects +
        pedestrians/cyclists (reference lidar mask, lidar.py:28) + the extra
        vehicle bodies of `_extra_vehicle_targets`, and the per-target
        radius [E,T] of cylinder bodies (pedestrian r=0.35, cone r=0.2,
        warning r=0.5 — pedestrian.py:12-118, traffic_object.py:43-160), or
        None when no compiled scene has one."""
        scene, npc = self.scene, state.npc
        s = state.sidx.long()
        ped_pos, ped_heading = participants.ped_world_pose(scene, state.sidx, state.ped)
        parts = [
            [npc.pos, scene.obj_pos[s], ped_pos],
            [npc.heading, scene.obj_heading[s], ped_heading],
            [npc.params.length, scene.obj_len[s], scene.ped_len[s]],
            [npc.params.width, scene.obj_wid[s], scene.ped_wid[s]],
            [npc.active, scene.obj_valid[s], state.ped.active],
        ]
        extra = self._extra_vehicle_targets(state)
        if extra is not None:
            for lst, arr in zip(parts, extra):
                lst.append(arr)
        targets = tuple(torch.cat(p, dim=1) for p in parts)
        radius = None
        if self._has_cylinders:
            okind = scene.obj_kind[s]
            obj_r = torch.where(okind == OBJ_CONE, 0.2, torch.where(okind == OBJ_WARNING, 0.5, 0.0))
            ped_r = torch.where(scene.ped_kind[s] == PED_WALKER, 0.35, 0.0)
            r = [torch.zeros_like(npc.speed), obj_r, ped_r]
            if extra is not None:
                r.append(torch.zeros_like(extra[1]))  # agents are vehicles
            radius = torch.cat(r, dim=1)
        return targets, radius

    def _resolve_contacts(self, ego, npc, hits, t_pos, t_heading, t_len, t_wid, frozen=None):
        """Batched rigid contact response (replaces Bullet's solver,
        engine_core.py:350-352): for every ego<->body overlap compute the SAT
        minimum-translation vector, split it between the two dynamic bodies
        (equal mass; objects are static -> the ego takes the full push), and
        remove each body's closing velocity component. Pedestrians don't
        block the chassis; crash_human stays a flag. Rows of ``frozen`` [E]
        take no push and keep their speed."""
        depth, normal = collision.obb_obb_mtv(
            ego.pos[:, None, :], ego.heading[:, None],
            ego.params.length[:, None], ego.params.width[:, None],
            t_pos, t_heading, t_len, t_wid,
        )
        depth = torch.clamp(depth, min=0.0)
        frac = self._push_frac
        contact = hits & (frac > 0)

        push = torch.where(contact, depth * frac, 0.0)[..., None] * normal
        push = push.sum(dim=1)
        # cap a single-step correction (deep spawn overlaps shouldn't teleport)
        mag = torch.sqrt((push ** 2).sum(-1, keepdim=True))
        push = push * torch.clamp(1.0 / torch.clamp(mag, min=1.0), max=1.0)
        scale = collision.contact_speed_scale(ego.speed, ego.heading + ego.vel_dir, normal, contact)
        if frozen is not None:
            push = torch.where(frozen[:, None], 0.0, push)
            scale = torch.where(frozen, 1.0, scale)
        ego = ego.replace(pos=ego.pos + push, speed=ego.speed * scale)

        # NPCs take the opposite half of their contact with the ego
        sl = self._target_slices["npc"]
        n_hit, n_depth, n_normal = hits[:, sl], depth[:, sl], normal[:, sl]
        n_push = torch.where(n_hit, -0.5 * n_depth, 0.0)[..., None] * n_normal
        n_scale = collision.contact_speed_scale(
            npc.speed, npc.heading + npc.vel_dir, -n_normal[:, :, None, :], n_hit[:, :, None],
        )
        npc = npc.replace(pos=npc.pos + n_push, speed=npc.speed * n_scale)
        return ego, npc

    def _observe(self, state, ego_long, ego_lat):
        vc = self.config["vehicle_config"]
        lidar_cfg = vc["lidar"]
        targets, radius = self._lidar_targets(state)
        sl = self._target_slices
        rng = None
        if lidar_cfg["gaussian_noise"] > 0 or lidar_cfg["dropout_prob"] > 0:
            # a shard is handed the batch's sum (`_batch_step_sum`)
            total = (state.step_count.sum() if self._batch_step_sum is None
                     else self._batch_step_sum)
            rng = prng.fold_in(self._noise_key, total)
        return state_obs.observe(
            self.scene, state.sidx, state.ego, targets, ego_long, ego_lat,
            num_lasers=lidar_cfg["num_lasers"], lidar_distance=lidar_cfg["distance"],
            num_others=lidar_cfg["num_others"], npc=state.npc,
            gaussian_noise=lidar_cfg["gaussian_noise"], dropout_prob=lidar_cfg["dropout_prob"],
            rng=rng, row_offset=self._row_offset,
            side_lasers=vc["side_detector"]["num_lasers"],
            side_distance=vc["side_detector"]["distance"],
            lane_line_lasers=vc["lane_line_detector"]["num_lasers"],
            lane_line_distance=vc["lane_line_detector"]["distance"],
            line_table=self._line_table,
            random_agent_model=self.config["random_agent_model"],
            t_radius=radius, circle_slice=slice(sl["obj"].start, sl["ped"].stop),
        )

    # ------------------------------------------------------------------ step
    def _advance(self, state, actions, prev_obs=None):
        """The step up to the observation: (state, the `_observe` arguments,
        reward, terminated, truncated, info). Its stages are device spans of
        core/trace.py."""
        cfg = self.config
        scene = self.scene
        sidx = state.sidx
        s = sidx.long()
        dev = self.device
        with trace.stage("advance.actions", dev):
            # NaN -> 0, +/-inf -> +/-1, clip to [-1, 1]
            # (reference _preprocess_action -> safe_clip_for_small_array,
            # base_vehicle.py:204-209 + utils/math.py:16-26)
            actions = torch.clamp(torch.nan_to_num(actions, nan=0.0, posinf=1.0, neginf=-1.0),
                                  -1.0, 1.0)
            # broken-down vehicles ignore their actions and coast to a stop
            actions = torch.where(state.ego.break_down[:, None], 0.0, actions)

            takeover_info = None
            if cfg["agent_policy"] == "lane_change":
                state, actions = self._lane_change_actions(state, actions)
            if cfg["use_AI_protector"] and prev_obs is not None:
                state, actions, takeover_info = self._ai_protect(state, actions, prev_obs)

        with trace.stage("advance.dynamics", dev):
            ego = state.ego
            # before_step (base_vehicle.py:211-232): save last kinematics, apply action
            ego = ego.replace(
                last_pos=ego.pos, last_heading=ego.heading,
                last_action=ego.current_action, current_action=actions,
                steering=actions[:, 0], throttle=actions[:, 1],
                past_pos=torch.cat([ego.past_pos[:, 1:], ego.pos[:, None]], dim=1),
            )

            # ego dynamics (decision_repeat substeps)
            dt = cfg["physics_world_step_size"]
            rep = cfg["decision_repeat"]
            pos, heading, speed, vel_dir = dynamics.step_vehicle(
                ego.pos, ego.heading, ego.speed, ego.vel_dir,
                ego.steering, ego.throttle, ego.params, dt=dt, substeps=rep,
                enable_reverse=cfg["vehicle_config"]["enable_reverse"],
            )
            frozen = self._freeze_mask(state)
            if frozen is not None:
                keep = lambda new, old: torch.where(
                    frozen.reshape(frozen.shape + (1,) * (old.dim() - 1)), old, new)
                pos, heading = keep(pos, ego.pos), keep(heading, ego.heading)
                speed, vel_dir = keep(speed, ego.speed), keep(vel_dir, ego.vel_dir)
            ego = ego.replace(pos=pos, heading=heading, speed=speed, vel_dir=vel_dir)
            # rows driven kinematically instead of by the bicycle model
            ego = self._override_kinematics(state, ego, dt, rep)

            # PG traffic-light phases (opt-in): green -> yellow -> red per arm,
            # opposite arms antiphased. Computed before the NPC step so red
            # lights gate IDM traffic too.
            light_ctx = None
            if scene.light_lane.shape[1] > 0 and cfg["pg_traffic_lights"]:
                lcfg = cfg["pg_traffic_lights"]
                g_dur = int(lcfg.get("green", 30)) if isinstance(lcfg, dict) else 30
                y_dur = int(lcfg.get("yellow", 4)) if isinstance(lcfg, dict) else 4
                half = g_dur + y_dur
                phase = (state.step_count[:, None] + scene.light_offset[s]) % (2 * half)
                status = torch.where(phase < g_dur, 0, torch.where(phase < half, 1, 2))  # g/y/r
                light_ctx = dict(
                    status=status, valid=scene.light_valid[s],
                    lane=scene.light_lane[s], long=scene.light_long[s],
                    pos=scene.light_pos[s], heading=scene.light_heading[s],
                    width=scene.light_width[s],
                )

        with trace.stage("advance.traffic", dev):
            # NPC traffic: release by trigger road, IDM actuation, dynamics
            npc = state.npc
            cur_road = localization.route_road_at(scene, sidx, ego.slot, ego.route_idx)
            released = npc.released | (scene.npc_trigger_road[s] == cur_road[:, None])
            npc = npc.replace(released=released)
            light_block = None
            if light_ctx is not None:
                # red lights hold IDM NPCs at the stop line
                light_block = (light_ctx["lane"], light_ctx["long"],
                               light_ctx["valid"] & (light_ctx["status"] == 2))
            npc = self._step_traffic(state, npc, ego, dt, rep, light_block)

            # pedestrians / cyclists advance kinematically
            ped = participants.step_peds(scene, sidx, state.ped, dt * rep)
            state = state.replace(ego=ego, npc=npc, ped=ped)

        with trace.stage("advance.contacts", dev):
            # contact flags (_state_check, base_vehicle.py:700-792)
            targets, t_radius = self._lidar_targets(state)
            t_pos, t_heading, t_len, t_wid, t_active = targets
            kinds = self._target_slices
            hits = collision.obb_obb_overlap(
                ego.pos[:, None, :], ego.heading[:, None],
                ego.params.length[:, None], ego.params.width[:, None],
                t_pos, t_heading, t_len, t_wid,
            ) & t_active
            if t_radius is not None:
                # cylinder bodies use the exact OBB-vs-circle test
                sl = slice(kinds["obj"].start, kinds["ped"].stop)
                circ = t_radius[:, sl] > 0
                circ_hits = collision.obb_circle_overlap(
                    ego.pos[:, None, :], ego.heading[:, None],
                    ego.params.length[:, None], ego.params.width[:, None],
                    t_pos[:, sl], t_radius[:, sl],
                ) & t_active[:, sl] & circ
                hits = torch.cat(
                    [hits[:, :sl.start], torch.where(circ, circ_hits, hits[:, sl]),
                     hits[:, sl.stop:]], dim=1)
            crash_v = hits[:, kinds["npc"]].any(dim=1)
            if kinds["agents"].stop > kinds["agents"].start:
                crash_v = crash_v | hits[:, kinds["agents"]].any(dim=1)
            obj_hits = hits[:, kinds["obj"]]
            # toll booths are buildings, not traffic objects
            is_building = scene.obj_kind[s] == OBJ_BUILDING
            crash_o = (obj_hits & ~is_building).any(dim=1)
            crash_b = (obj_hits & is_building).any(dim=1)
            crash_h = hits[:, kinds["ped"]].any(dim=1)

            # rigid contact response: project the bodies apart and kill the
            # closing velocity (Bullet's per-substep contact resolution,
            # engine_core.py:350-352)
            if cfg["contact_response"]:
                ego, npc = self._resolve_contacts(ego, npc, hits, t_pos, t_heading, t_len, t_wid,
                                                  frozen)
                state = state.replace(ego=ego, npc=npc)

        with trace.stage("advance.navigation", dev):
            # localization + navigation update (after_step,
            # base_vehicle.py:234-253)
            loc = localization.localize(scene, sidx, ego.slot, ego.pos, ego.lane, ego.route_idx)
            ego = ego.replace(lane=loc["lane"], route_idx=loc["route_idx"], on_lane=loc["on_lane"])
            seg_flags = collision.vehicle_segment_flags(
                ego.pos, ego.heading, ego.params.length, ego.params.width,
                *scene.seg_points(sidx),
                scene.seg_type[s], scene.seg_halfwidth[s], scene.seg_valid[s],
                (SEG_YELLOW_LINE, SEG_WHITE_LINE, SEG_SIDEWALK),
            )
            left, right = localization.boundary_distances(scene, sidx, ego.slot, ego.route_idx,
                                                          ego.pos)
            ego = ego.replace(
                on_yellow_line=seg_flags[SEG_YELLOW_LINE],
                on_white_line=seg_flags[SEG_WHITE_LINE],
                crash_sidewalk=seg_flags[SEG_SIDEWALK],
                crash_vehicle=crash_v, crash_object=crash_o,
                crash_building=crash_b, crash_human=crash_h,
                out_of_route=(left < 0) | (right < 0),
            )

            step_count = state.step_count + 1
            state = state.replace(ego=ego, npc=npc, step_count=step_count)
            state = self._pre_reward_update(state, loc)

            # reward / done / cost (subclass formulas)
            arrive = localization.arrive_destination(scene, sidx, ego.slot, ego.pos)
            out_of_road = self._is_out_of_road(ego, state)
            reward, step_info = self.reward_function(state, loc, arrive, out_of_road)
            cost, cost_info = self.cost_function(state, out_of_road)
            terminated, truncated, done_info = self.done_function(state, arrive, out_of_road)

            episode_reward = state.episode_reward + reward
            episode_cost = state.episode_cost + cost
            # fuel model 3.25*e^(0.01 v_kmh) L/100km (base_vehicle.py:259-271)
            dist_km = torch.sqrt(((ego.pos - ego.last_pos) ** 2).sum(-1)) / 1000.0
            step_energy = 3.25 * torch.exp(0.01 * ego.speed * 3.6) * dist_km / 100.0 * 1000.0
            episode_energy = state.episode_energy + step_energy
            state = state.replace(
                episode_reward=episode_reward, episode_cost=episode_cost,
                episode_energy=episode_energy,
            )
            # crash aggregates vehicle/object/building/sidewalk/human
            # (metadrive_env.py:148-152)
            crash_any = (ego.crash_vehicle | ego.crash_object | ego.crash_sidewalk
                         | ego.crash_human | ego.crash_building)
            env_seed = self._seed_of(sidx)

            # traffic-light contact flags: the ego OBB against each light's
            # air-wall stop region, a 0.25 m x lane-width box across the lane
            # end (base_traffic_light.py:17, 44-51; base_vehicle.py:720-733)
            light_info = {}
            if light_ctx is not None:
                wall = collision.obb_obb_overlap(
                    ego.pos[:, None, :], ego.heading[:, None],
                    ego.params.length[:, None], ego.params.width[:, None],
                    light_ctx["pos"], light_ctx["heading"],
                    torch.full_like(light_ctx["width"], 0.25), light_ctx["width"],
                ) & light_ctx["valid"]
                status = light_ctx["status"]
                light_info = dict(on_green_light=(wall & (status == 0)).any(dim=1),
                                  on_yellow_light=(wall & (status == 1)).any(dim=1),
                                  on_red_light=(wall & (status == 2)).any(dim=1))

        state, terminated, truncated = self._post_done(state, terminated, truncated)
        info = dict(
            arrive_dest=arrive, out_of_road=out_of_road,
            crash_vehicle=ego.crash_vehicle, crash_object=ego.crash_object,
            crash_human=ego.crash_human, crash_sidewalk=ego.crash_sidewalk,
            crash_building=ego.crash_building,
            crash=crash_any,
            max_step=truncated, cost=cost, total_cost=episode_cost,
            step_reward=step_info["step_reward"],
            velocity=ego.speed, steering=ego.steering, acceleration=ego.throttle,
            step_energy=step_energy, episode_energy=episode_energy,
            episode_reward=episode_reward, episode_length=step_count,
            env_seed=env_seed,
        )
        info.update({k: v for k, v in step_info.items() if k != "step_reward"})
        info.update(done_info)
        info.update(cost_info)
        if takeover_info is not None:
            info.update(takeover_info)
        info.update(light_info)

        with trace.stage("advance.reset", dev):
            # auto-reset done envs in place (vectorized-RL semantics replacing
            # the reference's explicit env.reset())
            done = self._reset_mask(state, terminated | truncated)
            if cfg["auto_reset"]:
                new_keys = prng.split(state.rng, 2)                 # [E,2,2]
                step_rng, reset_rng = new_keys[:, 0], new_keys[:, 1]
                cap = state.scenario_cap
                new_sidx = prng.randint(step_rng, (), 0, cap)
                fresh = self._spawn(reset_rng, new_sidx)
                state = tree_map(
                    lambda new, old: torch.where(done.reshape(done.shape + (1,) * (old.dim() - 1)),
                                                 new, old),
                    fresh, state.replace(rng=step_rng),
                )
                # _spawn sets the full scenario band; keep the live cap
                state = state.replace(scenario_cap=cap)
                ego_long = torch.where(done, 5.0, loc["long"])
                ego_lat = torch.where(done, 0.0, loc["lat"])
            else:
                ego_long, ego_lat = loc["long"], loc["lat"]
        if cfg["auto_reset"]:
            # the spawn computes every row and keeps the done ones
            trace.count("reset.rows", done, dev)
            trace.count("reset.computed", done.shape[0], dev)

        return state, (ego_long, ego_lat), reward, terminated, truncated, info

    # ---- agent policies -----------------------------------------------------
    def _lane_change_actions(self, state, actions):
        """LaneChangePolicy (policy/lange_change_policy.py:11-72): discrete
        steering {-1: right, 0: keep, +1: left} picks a target lane; the
        applied steering is a heading PID plus a lateral PID toward it.
        policy_state = (heading_i, heading_prev_e, lateral_i, lateral_prev_e)."""
        scene, ego = self.scene, state.ego
        cmd = actions[:, 0]
        g = lane_geom.gather_lane(scene, state.sidx, ego.lane)
        target = torch.where(
            cmd > 0.5, torch.where(g["left"] >= 0, g["left"], ego.lane),
            torch.where(cmd < -0.5, torch.where(g["right"] >= 0, g["right"], ego.lane), ego.lane),
        )
        gt = lane_geom.gather_lane(scene, state.sidx, target)
        long, lat = lane_geom.local_coordinates(gt, ego.pos)
        herr = -wrap_to_pi(lane_geom.heading_theta_at(gt, long + 1.0) - ego.heading)
        ps = state.policy_state
        # the reference's gains (lange_change_policy.py:26-27); the error
        # signs are those of the IDM steering (ops/idm.py)
        s_h, h_i, h_e = idm._pid((1.7, 0.01, 3.5), herr, ps[:, 0], ps[:, 1])
        s_l, l_i, l_e = idm._pid((0.3, 0.002, 0.05), -lat, ps[:, 2], ps[:, 3])
        steering = torch.clamp(s_h + s_l, -1.0, 1.0)
        return (state.replace(policy_state=torch.stack([h_i, h_e, l_i, l_e], dim=-1)),
                torch.stack([steering, actions[:, 1]], dim=-1))

    def _ai_protect(self, state, actions, prev_obs):
        """AIProtectPolicy / TakeoverPolicy (policy/AI_protect_policy.py): the
        PPO expert vetoes dangerous actions. save_level > 0.9 is a full
        takeover; otherwise the expert steps in near the road's edges (obs
        dims 0 and 1) and when the lidar shows a close side or front body.
        policy_state[:, 3] latches last step's takeover flag, for the
        takeover_start / takeover_end info keys."""
        ego = state.ego
        save_level = self.config["save_level"]
        saver = expert_action(self._expert_params, prev_obs)
        steering, throttle = actions[:, 0], actions[:, 1]
        if save_level > 0.9:
            new_s, new_t = saver[:, 0], saver[:, 1]
        elif save_level > 1e-3:
            hd = localization.heading_diff_ref(
                self.scene, state.sidx, ego.slot, ego.route_idx, ego.pos, ego.heading) - 0.5
            speed_kmh = ego.speed * 3.6
            f = torch.clamp(1 + torch.abs(hd) * speed_kmh * ego.params.max_speed_kmh,
                            max=save_level * 10)
            o0, o1 = prev_obs[:, 0], prev_obs[:, 1]
            out_of_road = (((o0 < 0.04 * f) & (hd < 0)) | ((o1 < 0.04 * f) & (hd > 0))
                           | (o0 <= 1e-3) | (o1 <= 1e-3))
            new_s = torch.where(out_of_road, saver[:, 0], steering)
            new_t = torch.where(out_of_road, saver[:, 1], throttle)
            new_t = torch.where(out_of_road & (speed_kmh < 5), 0.5, new_t)
            # collision guards on the lidar tail of the expert obs
            n = self.config["vehicle_config"]["lidar"]["num_lasers"]
            cloud = prev_obs[:, -n:]
            left, right = n // 4, n // 4 * 3
            near = (save_level + 0.1) / 10
            side_close = ((cloud[:, left - 4:left + 6].amin(dim=1) < near)
                          | (cloud[:, right - 4:right + 6].amin(dim=1) < near))
            new_s = torch.where(side_close, saver[:, 0], new_s)
            front_close = torch.minimum(cloud[:, :10].amin(dim=1),
                                        cloud[:, -10:].amin(dim=1)) < save_level
            brake = (throttle >= 0) & (saver[:, 1] <= 0) & front_close
            new_t = torch.where(brake, saver[:, 1], new_t)
        else:
            new_s, new_t = steering, throttle
        takeover = (new_s != steering) | (new_t != throttle)
        pre = state.policy_state[:, 3] > 0.5
        # the saver's action applies only from the second consecutive
        # takeover step (AI_protect_policy.py:49-57)
        apply = takeover & pre
        info = dict(takeover=apply, takeover_start=takeover & ~pre, takeover_end=~takeover & pre)
        ps = torch.cat([state.policy_state[:, :3], takeover.float()[:, None]], dim=1)
        out = torch.stack([torch.where(apply, new_s, steering), torch.where(apply, new_t, throttle)],
                          dim=-1)
        return state.replace(policy_state=ps), out, info

    # ---- overridable scheme ------------------------------------------------
    def _step_traffic(self, state, npc, ego, dt, rep, light_block):
        """Advance NPC traffic one decision step (IDM, and the expert for the
        pack's expert slots when rl_agent_ratio > 0). Multi-agent envs step
        it once per env against all agent rows instead."""
        expert_actions, expert_mask = self._expert_traffic(state.sidx, npc, ego)
        return idm.step_npcs(
            self.scene, state.sidx, npc, ego, dt=dt, substeps=rep,
            respawn_mode=self.config["traffic_mode"] in ("respawn", "hybrid"),
            expert_actions=expert_actions, expert_mask=expert_mask, light_block=light_block,
        )

    def _expert_traffic(self, sidx, npc, ego):
        """(expert actions [E,N,2], expert mask [E,N]) of the NPC slots, or
        (None, None) when no NPC is expert-driven (rl_agent_ratio = 0)."""
        if self.config["rl_agent_ratio"] <= 0:
            return None, None
        lidar = self.config["vehicle_config"]["lidar"]
        with trace.stage("advance.traffic.expert", self.device):
            actions = mixed_traffic.expert_npc_actions(
                self.scene, sidx, npc, ego, self._npc_expert_params,
                num_lasers=lidar["num_lasers"], distance=lidar["distance"])
            mask = self.scene.npc_expert[sidx.long()]
        # the expert computes every slot; its actions drive the live ones
        trace.count("expert.live", mask & npc.active, self.device)
        trace.count("expert.computed", mask.numel(), self.device)
        return actions, mask

    def _pre_reward_update(self, state, loc):
        """Hook after localization and contacts, before reward/done: env
        families update their aux counters here (tollgate stay time)."""
        return state

    def _post_done(self, state, terminated, truncated):
        """Hook after the done computation (multi-agent delay-done and
        respawn)."""
        return state, terminated, truncated

    def _reset_mask(self, state, done):
        """Hook mapping per-row done to the rows to auto-reset (a
        multi-agent env resets only when all its agents are finished)."""
        return done

    def _is_out_of_road(self, ego, state=None):
        raise NotImplementedError

    def reward_function(self, state, loc, arrive, out_of_road):
        raise NotImplementedError

    def cost_function(self, state, out_of_road):
        raise NotImplementedError

    def done_function(self, state, arrive, out_of_road):
        raise NotImplementedError
