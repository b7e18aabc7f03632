"""Multi-agent envs (vectorized).

Reference: metadrive/envs/marl_envs/multi_agent_metadrive.py:12-150 plus the
SpawnManager slot machinery (manager/spawn_manager.py:20-250). Agents live on
a second batch axis folded into rows: the state is [E*A, ...], the A rows of
one env share a scenario, and agent interactions (mutual lidar and
contacts) reshape to [E, A].

- Spawn slots tile every spawn road at 8 m intervals; each agent takes a
  distinct random slot per episode (spawn_manager.py:72-105 reset).
- delay_done corpses: a done agent freezes in place for delay_done steps and
  keeps blocking traffic (multi_agent_metadrive.py delay_done=25).
- Respawn: after the corpse delay an agent re-enters at a random free slot
  of its env while the horizon lasts (allow_respawn). A slot is free when
  the 8 x 3 m region at it overlaps no agent body (rect_region_detection,
  spawn_manager.py:27-29, 163); same-step respawns claim slots one agent
  after another, so no two share one (spawn_places_used,
  spawn_manager.py:160-166).
- An env auto-resets only when all its agents are finished at once
  ("__all__", multi_agent_metadrive.py:130-150). That reset draws each row's
  scenario and spawn slot on its own, as the JAX package's base step does,
  so two agents of a reset env can share a slot (ROADMAP.md queue 3).
- Background IDM traffic is canonical per env (the agent-0 row): it steps
  once against all agent bodies and is broadcast back to the rows.

The step makes no host synchronisation: the slot claim is a loop of A
iterations over device tensors.
"""
import torch

from metadrive_ped_torch.core import prng, trace
from metadrive_ped_torch.core.structs import tree_map
from metadrive_ped_torch.envs.metadrive_env import MetaDriveEnv
from metadrive_ped_torch.ops import collision, idm

# RESPAWN_REGION box (spawn_manager.py:27-29)
RESPAWN_REGION_LONGITUDE = 8.0
RESPAWN_REGION_LATERAL = 3.0


class MultiAgentMetaDrive(MetaDriveEnv):
    """``reset`` and ``step`` take and give [E, A, ...] arrays (E =
    num_envs, A = num_agents); inside, every agent is a row, so after
    ``__init__`` ``num_envs`` counts rows (E*A) and ``rollout`` works on
    rows."""

    _ROW_AXES = dict(MetaDriveEnv._ROW_AXES, _others=0)

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                num_agents=15,
                delay_done=25,
                allow_respawn=True,
                crash_done=True,
                out_of_road_done=True,
                spawn_roads=[(">>", ">>>")],
                horizon=1000,
                truncate_as_terminate=True,
                # MARL reward scheme (multi_agent_metadrive.py:49-56)
                out_of_road_penalty=10.0,
                crash_vehicle_penalty=10.0,
                crash_object_penalty=10.0,
                out_of_road_cost=0.0,
                traffic_density=0.0,
                vehicle_config=dict(lidar=dict(num_lasers=72, distance=40.0)),
                # top-down camera poses of the reference's scene configs
                # (marl_inout_roundabout.py:20-22 et al.): accepted and
                # ignored, there is no camera to aim
                top_down_camera_initial_x=0,
                top_down_camera_initial_y=0,
                top_down_camera_initial_z=120,
            ),
            allow_add_new_key=True,
        )
        return config

    def __init__(self, config=None, device=None):
        super().__init__(config, device)
        E, A = self.config["num_envs"], self.config["num_agents"]
        self.agents_per_env = A
        self.num_marl_envs = E
        self.num_envs = E * A  # every agent is a row
        self._set_target_layout(extra=A)
        # [E*A, A]: the other agents of each row's env
        self._others = ~torch.eye(A, dtype=torch.bool, device=self.device).repeat(E, 1)

    # ---- row plumbing -----------------------------------------------------
    def _rows_to_EA(self, x):
        return x.reshape((self.num_marl_envs, self.agents_per_env) + tuple(x.shape[1:]))

    def _shard(self, r0, r1, device):
        """Rows [r0, r1) must hold whole envs: the mutual lidar, the
        contacts and the respawn stay inside an env."""
        A = self.agents_per_env
        if r0 % A or r1 % A:
            raise ValueError(f"rows [{r0}, {r1}) cut an env of {A} agents")
        view = super()._shard(r0, r1, device)
        view.num_marl_envs = (r1 - r0) // A
        return view

    def _reset_state(self, rng):
        E, A = self.num_marl_envs, self.agents_per_env
        rows = E * A
        keys = prng.split(rng, rows + 2)
        sidx_env = prng.randint(keys[0], (E,), 0, self.num_scenarios)
        sidx = sidx_env.repeat_interleave(A)
        slot = self._assign_slots(keys[1], sidx_env).reshape(rows)
        state = self._spawn(keys[2:], sidx, slot)
        ego_long = self.scene.slot_long[sidx.long(), state.ego.slot.long()]
        return state, (ego_long, torch.zeros(rows, device=self.device)), dict(
            env_seed=self._seed_of(sidx))

    def _assign_slots(self, key, sidx_env):
        """Distinct random valid slots per agent within each env
        (spawn_manager.py:72-90: np_random.choice without replacement)."""
        E, A = self.num_marl_envs, self.agents_per_env
        SLOT = self.scene.slot_valid.shape[1]
        noise = prng.uniform(key, (E, SLOT))
        score = torch.where(self.scene.slot_valid[sidx_env.long()], noise, -1.0)
        # valid slots first, in random order (stable, as jnp.argsort)
        order = torch.argsort(-score, dim=1, stable=True)
        return order[:, :A].to(torch.int32)

    # ---- hooks into the base step ----------------------------------------
    def _step_traffic(self, state, npc, ego, dt, rep, light_block):
        """The NPC state is canonical per env (all A rows of one env carry
        the same copy): step the agent-0 copy once against every agent
        body, then broadcast it back. The reference has one traffic manager
        per env."""
        if self.scene.npc_lane.shape[1] == 0 or self.config["traffic_density"] == 0.0:
            return npc
        E, A = self.num_marl_envs, self.agents_per_env
        take0 = lambda x: self._rows_to_EA(x)[:, 0]
        # releases are decided per agent row (any agent entering the
        # trigger road releases the block, traffic_manager.py:74-92)
        npc_env = tree_map(take0, npc).replace(released=self._rows_to_EA(npc.released).any(dim=1))
        lb_env = None if light_block is None else tuple(take0(x) for x in light_block)
        agents = (
            self._rows_to_EA(ego.pos), self._rows_to_EA(ego.speed),
            self._rows_to_EA(ego.params.length),
            torch.ones((E, A), dtype=torch.bool, device=self.device),  # corpses keep blocking
        )
        sidx_env = take0(state.sidx)
        # expert slots (rl_agent_ratio > 0) see agent 0 as "the ego", as in
        # the JAX package; the IDM gap search sees every agent
        expert_actions, expert_mask = self._expert_traffic(sidx_env, npc_env, tree_map(take0, ego))
        npc_env = idm.step_npcs(
            self.scene, sidx_env, npc_env, None, dt=dt, substeps=rep,
            respawn_mode=self.config["traffic_mode"] in ("respawn", "hybrid"),
            expert_actions=expert_actions, expert_mask=expert_mask,
            light_block=lb_env, extra_bodies=agents,
        )
        return tree_map(lambda x: x.repeat_interleave(A, dim=0), npc_env)

    def _resolve_contacts(self, ego, npc, hits, t_pos, t_heading, t_len, t_wid, frozen=None):
        """Each agent row pushes its own copy of the env's NPCs; the pushes
        add up over the agents and the speed scale takes the smallest, so
        every row keeps the same NPC state (one physics world per env)."""
        ego2, npc2 = super()._resolve_contacts(ego, npc, hits, t_pos, t_heading, t_len, t_wid,
                                               frozen)
        if self.scene.npc_lane.shape[1] == 0:
            return ego2, npc2
        A = self.agents_per_env
        push = self._rows_to_EA(npc2.pos - npc.pos).sum(dim=1)            # [E,N,2]
        pos = self._rows_to_EA(npc.pos)[:, 0] + push
        speed = self._rows_to_EA(npc2.speed).amin(dim=1)
        return ego2, npc2.replace(pos=pos.repeat_interleave(A, dim=0),
                                  speed=speed.repeat_interleave(A, dim=0))

    def _extra_vehicle_targets(self, state):
        """Every agent of the row's env except the row's own: corpses stay
        bodies until they respawn (delay_done)."""
        E, A = self.num_marl_envs, self.agents_per_env

        def of_env(x):
            x = self._rows_to_EA(x)[:, None]                                # [E,1,A,...]
            return x.expand((E, A) + tuple(x.shape[2:])).reshape((E * A,) + tuple(x.shape[2:]))

        ego = state.ego
        return (of_env(ego.pos), of_env(ego.heading), of_env(ego.params.length),
                of_env(ego.params.width), self._others)

    def _freeze_mask(self, state):
        return state.dead_timer > 0

    def _post_done(self, state, terminated, truncated):
        """delay_done bookkeeping and respawn (multi_agent_metadrive.py
        _after_vehicle_done / _respawn_vehicles), the device span
        `advance.reset` (core/trace.py) as the auto-reset is."""
        cfg = self.config
        with trace.stage("advance.reset", self.device):
            newly_done = (terminated | truncated) & (state.dead_timer == 0)
            timer = torch.where(newly_done, cfg["delay_done"] + 1, state.dead_timer)
            timer = torch.clamp(timer - 1, min=0)
            if cfg["allow_respawn"]:
                state = self._respawn(state, (state.dead_timer == 1) & (timer == 0))
            state = state.replace(dead_timer=timer)
            # dead agents emit no further terminations
            silent = (state.dead_timer > 0) & ~newly_done
            return state, terminated & ~silent, truncated & ~silent

    def _respawn(self, state, mask):
        """Respawn the ``mask`` rows at a random free slot of their env.

        A slot is free when the 8 x 3 m respawn region at it overlaps no
        agent body (rect_region_detection, spawn_manager.py:163). Same-step
        respawns claim slots one agent after another (spawn_places_used), so
        no two agents share one; a row that finds no free slot stays."""
        E, A = self.num_marl_envs, self.agents_per_env
        EA = self._rows_to_EA
        scene, ego, dev = self.scene, state.ego, self.device
        SLOT = scene.slot_valid.shape[1]
        s_env = EA(state.sidx)[:, 0].long()
        # slot poses from the host-computed spawn tables (core/structs.py);
        # the JAX package derives the same poses from the lane geometry
        region = lambda v: torch.full((E, SLOT, 1), v, device=dev)
        occupied = collision.obb_obb_overlap(
            scene.slot_pos[s_env][:, :, None, :], scene.slot_heading[s_env][:, :, None],
            region(RESPAWN_REGION_LONGITUDE), region(RESPAWN_REGION_LATERAL),
            EA(ego.pos)[:, None], EA(ego.heading)[:, None],
            EA(ego.params.length)[:, None], EA(ego.params.width)[:, None],
        ).any(dim=2)                                                        # [E,SLOT]
        free = scene.slot_valid[s_env] & ~occupied

        keys = prng.split(state.rng, 2)
        rng_next, rng_pick = keys[:, 0], keys[:, 1]
        noise = prng.uniform(rng_pick, (SLOT,))                            # [rows,SLOT]
        # only respawning rows compete, each over its env's free slots
        score = EA(torch.where(free.repeat_interleave(A, dim=0) & mask[:, None], noise, -1.0))

        # the claim, agent by agent: a taken slot scores -3, below every
        # untaken one (>= -1), so a row that finds nothing free (best <= 0)
        # picks an untaken slot and writes False onto it: `taken` changes
        # only where a slot is claimed; ties go to the first slot
        taken = torch.zeros((E, SLOT), dtype=torch.bool, device=dev)
        picks, oks = [], []
        for a in range(A):
            best, pick = torch.where(taken, -3.0, score[:, a]).max(dim=1)
            ok = best > 0
            taken.scatter_(1, pick[:, None], ok[:, None])
            picks.append(pick)
            oks.append(ok)
        new_slot = torch.stack(picks, dim=1).reshape(E * A).to(torch.int32)
        do = mask & torch.stack(oks, dim=1).reshape(E * A)

        fresh = self._spawn_ego(rng_next, state.sidx.long(), new_slot)
        # the spawn computes every row and keeps the respawned ones
        trace.count("reset.rows", do, dev)
        trace.count("reset.computed", do.shape[0], dev)
        sel = lambda new, old: torch.where(do.reshape(do.shape + (1,) * (old.dim() - 1)), new, old)
        return state.replace(
            ego=tree_map(sel, fresh, ego), rng=rng_next,
            step_count=torch.where(do, 0, state.step_count),
            episode_reward=torch.where(do, 0.0, state.episode_reward),
            episode_cost=torch.where(do, 0.0, state.episode_cost),
            dead_timer=torch.where(do, 0, state.dead_timer),
            aux=torch.where(do[:, None], 0.0, state.aux),
        )

    def _reset_mask(self, state, done):
        """Auto-reset an env only when every agent is done or dead
        ("__all__"); with respawn, only at the horizon."""
        finished = done | (state.dead_timer > 0)
        if self.config["allow_respawn"]:
            finished = finished & (state.step_count >= self.config["horizon"])
        return self._rows_to_EA(finished).all(dim=1).repeat_interleave(self.agents_per_env)

    # ---- the [E, A, ...] user surface: `step` takes actions [E, A, 2] (or
    #      [E, A] / [E, A, 2] integers with discrete_action) and gives
    #      [E, A, ...] arrays and info["__all__"] [E] ------------------------
    def _reset_outputs(self, obs, info):
        return self._rows_to_EA(obs), info

    def _step_outputs(self, obs, reward, terminated, truncated, info):
        r, rows = self._rows_to_EA, self.num_envs
        info = {k: r(v) if torch.is_tensor(v) and tuple(v.shape[:1]) == (rows,) else v
                for k, v in info.items()}
        info["__all__"] = r(terminated | truncated).all(dim=1)
        return r(obs), r(reward), r(terminated), r(truncated), info


class MultiAgentRoundaboutEnv(MultiAgentMetaDrive):
    """MARL roundabout scene (reference: marl_envs/marl_inout_roundabout.py):
    one Roundabout block, 40 agents spawning on all four arms.

    The map is the reference's fixed MARoundaboutMap (marl_inout_roundabout
    .py:27-64): FirstPGBlock(exit_length=60) + Roundabout(random_seed=1,
    exit_radius=10, inner_radius=30, angle=70, EXIT_PART_LENGTH=60)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                map="O",  # informational; the map is custom_blocks below
                num_agents=40,
                map_config=dict(
                    lane_width=3.5, lane_num=2, exit_length=60.0,
                    custom_blocks=[dict(id="O", random_seed=1, config=dict(
                        exit_radius=10.0, inner_radius=30.0, angle=70.0,
                        exit_part_length=60.0,
                    ))],
                ),
                spawn_roads=[
                    (">>", ">>>"),
                    ("-1O0_3_", "-1O0_2_"),
                    ("-1O1_3_", "-1O1_2_"),
                    ("-1O2_3_", "-1O2_2_"),
                ],
            ),
            allow_add_new_key=True,
        )
        return config


class MultiAgentBottleneckEnv(MultiAgentMetaDrive):
    """MARL bottleneck scene (reference: marl_envs/marl_bottleneck.py):
    a 4-lane road bottling to a 1-lane neck and splitting back, 20 agents
    spawning at both 4-lane ends.

    The map is the reference's fixed MABottleneckMap (marl_bottleneck.py:
    28-67): FirstPGBlock(4 lanes, exit_length=60) + Merge(drop 3,
    length=neck_length=20) + Split(add 3, length=60), random_seed=1."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                map="yY",  # informational; the map is custom_blocks below
                num_agents=20,
                map_config=dict(
                    lane_width=3.5, lane_num=4, exit_length=60.0,
                    bottle_lane_num=4, neck_lane_num=1, neck_length=20.0,
                    custom_blocks=[
                        dict(id="y", random_seed=1, config=dict(lane_num=3, length=20.0)),
                        dict(id="Y", random_seed=1, config=dict(lane_num=3, length=60.0)),
                    ],
                ),
                spawn_roads=[(">>", ">>>"), ("-2Y0_1_", "-2Y0_0_")],
                cross_yellow_line_done=True,
                vehicle_config=dict(
                    side_detector=dict(num_lasers=4, distance=50.0),
                    lane_line_detector=dict(num_lasers=4, distance=20.0),
                ),
            ),
            allow_add_new_key=True,
        )
        return config


class MultiAgentBidirectionEnv(MultiAgentMetaDrive):
    """MARL bidirection scene (reference: marl_envs/marl_bidirection.py):
    a shared bidirectional span between two 4-lane approaches, 20 agents
    driven from both ends.

    The map is the reference's fixed MABidirectionMap (marl_bidirection.py:
    29-71): FirstPGBlock(4 lanes, exit_length=60) + Merge(drop 3, length=3)
    + Bidirection + Split(add 3, length=60), random_seed=1."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                map="yBY",  # informational; the map is custom_blocks below
                num_agents=20,
                map_config=dict(
                    lane_width=3.5, lane_num=4, exit_length=60.0,
                    bottle_lane_num=4, neck_lane_num=1, neck_length=20.0,
                    custom_blocks=[
                        dict(id="y", random_seed=1, config=dict(lane_num=3, length=3.0)),
                        dict(id="B", random_seed=1),
                        dict(id="Y", random_seed=1, config=dict(lane_num=3, length=60.0)),
                    ],
                ),
                spawn_roads=[(">>", ">>>"), ("-3Y0_1_", "-3Y0_0_")],
                cross_yellow_line_done=True,
                vehicle_config=dict(
                    side_detector=dict(num_lasers=4, distance=50.0),
                    lane_line_detector=dict(num_lasers=4, distance=20.0),
                ),
            ),
            allow_add_new_key=True,
        )
        return config


class MultiAgentIntersectionEnv(MultiAgentMetaDrive):
    """MARL intersection scene (reference: marl_envs/marl_intersection.py):
    one StdInterSection block, 30 agents spawning on all four arms.

    The map is the reference's fixed MAIntersectionMap (marl_intersection
    .py:27-68): FirstPGBlock(exit_length=60) + InterSection(random_seed=1,
    EXIT_PART_LENGTH=60, enable_u_turn for lane_num>1). Each spawn slot
    routes to another arm's exit: the JAX package's u-turn destination
    flag never reaches its scene compiler, and this package compiles the
    same scenes (ROADMAP.md queue 3)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                map="X",  # informational; the map is custom_blocks below
                num_agents=30,
                map_config=dict(
                    lane_width=3.5, lane_num=2, exit_length=60.0,
                    custom_blocks=[dict(id="X", random_seed=1, u_turn=True,
                                        config=dict(exit_part_length=60.0))],
                ),
                spawn_roads=[
                    (">>", ">>>"),
                    ("-1X0_1_", "-1X0_0_"),
                    ("-1X1_1_", "-1X1_0_"),
                    ("-1X2_1_", "-1X2_0_"),
                ],
            ),
            allow_add_new_key=True,
        )
        return config
