"""Data parallelism over devices and processes (the counterpart of
metadrive_ped_tpu/parallel/mesh.py).

Envs are independent during stepping, so the [rows, ...] state splits into
contiguous row blocks, one per mesh device. JAX runs one program over its
mesh and computes every whole-batch draw and sum as if nothing were
sharded. PyTorch has no such program: here a shard is a view of the env
over its rows on its own device (`VectorEnvLoop._shard`), and
`ShardedEnv` steps the views in turn; on CUDA devices each shard's step
replays its own CUDA graphs (`core.graph.ShardedGraphs`), so the host
launches a few graphs a step, not every shard's kernels. Where a row's
result depends on the whole batch it hands each shard the batch's part:

- the lidar noise key folds in the batch's step-count sum, so every shard
  advances before any observes and each is handed the sum of the shards'
  sums, summed on the devices (no host sync) into a buffer of its own;
- each shard draws its rows of the batch's [rows, lasers] noise (the
  threefry counters from its first row on, `prng.uniform` ``offset``);
- reset runs on the whole batch and is then cut, since a reset splits one
  key over the batch's rows;
- the host's bookkeeping (action conversion, manual control of row 0,
  ScenarioEnv coverage and curriculum) runs once, on the whole batch.

So a sharded env gives the unsharded env's numbers. Multi-agent envs shard
by whole envs (rows = E*A stay env-major), so the mutual lidar, contacts
and respawn stay inside a shard.

Across processes: call `init_distributed` in every process and give each
its own env batch with ``worker_index=rank`` and ``num_workers=world_size``
in the config: each process compiles and samples its stride of the
scenario set (the reference shards scenario indices across workers,
scenario_data_manager.py:26-32).
"""
import datetime

import torch

from metadrive_ped_torch.core import graph, prng
from metadrive_ped_torch.core.structs import _Tree, map_tensors, take_rows, tree_map
from metadrive_ped_torch.envs.marl_envs import (
    MultiAgentBidirectionEnv, MultiAgentBottleneckEnv, MultiAgentIntersectionEnv,
    MultiAgentMetaDrive, MultiAgentParkingLotEnv, MultiAgentRacingEnv, MultiAgentRoundaboutEnv,
    MultiAgentTinyInter, MultiAgentTollgateEnv,
)
from metadrive_ped_torch.envs.metadrive_env import MetaDriveEnv
from metadrive_ped_torch.envs.mixed_traffic_env import MixedTrafficEnv
from metadrive_ped_torch.envs.safe_metadrive_env import SafeMetaDriveEnv
from metadrive_ped_torch.envs.scenario_env import ScenarioEnv
from metadrive_ped_torch.envs.top_down_env import (
    TopDownMetaDrive, TopDownMetaDriveEnvV2, TopDownSingleFrameMetaDriveEnv,
)
from metadrive_ped_torch.envs.varying_dynamics_env import VaryingDynamicsEnv

# the env classes held against the unsharded env (tests/test_torch_parallel.py)
SHARDABLE = (
    MetaDriveEnv, SafeMetaDriveEnv, MixedTrafficEnv, VaryingDynamicsEnv, ScenarioEnv,
    TopDownSingleFrameMetaDriveEnv, TopDownMetaDrive, TopDownMetaDriveEnvV2,
    MultiAgentMetaDrive, MultiAgentRoundaboutEnv, MultiAgentIntersectionEnv,
    MultiAgentBottleneckEnv, MultiAgentBidirectionEnv, MultiAgentTollgateEnv,
    MultiAgentParkingLotEnv, MultiAgentRacingEnv, MultiAgentTinyInter,
)


def init_distributed(init_method=None, world_size=None, rank=None, backend=None, timeout=300.0):
    """Join the process group of a multi-process run (the counterpart of
    `jax.distributed.initialize`); returns (rank, world_size).

    Nothing to do for a single process: (0, 1). Otherwise
    `torch.distributed.init_process_group` with ``backend`` (default
    "nccl" with CUDA, "gloo" without; two ranks on one GPU cannot use NCCL,
    so name "gloo" there), giving up after ``timeout`` seconds. Use a
    ``file://`` ``init_method`` on a fresh path where the ranks share a file
    system: no port is bound and released before the ranks meet."""
    import torch.distributed as dist
    if (world_size is not None and world_size > 1) or init_method:
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        print(f"init_distributed: rank {rank} of {world_size}, backend {backend}", flush=True)
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout))
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(devices=None):
    """The mesh: a tuple of `torch.device`s, one per shard. By default every
    CUDA device; without CUDA that raises (pass ``["cpu"] * n`` to shard on
    the CPU). A device may repeat: ``["cuda:0"] * 2`` splits one card's
    batch in two."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_mesh() takes every CUDA device; pass "
                               "devices (['cpu', 'cpu']) to shard on the CPU")
        devices = range(torch.cuda.device_count())
    mesh = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"no CUDA device for mesh entry {d}")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(f"mesh entry {d}: only {torch.cuda.device_count()} "
                                   "CUDA devices")
        mesh.append(d)
    if not mesh:
        raise ValueError("the mesh needs at least one device")
    return tuple(mesh)


class ShardedEnv:
    """A vectorized env whose rows split over the devices of a mesh.

        env = MetaDriveEnv(dict(num_envs=4096, ...))
        senv = ShardedEnv(env)        # over every CUDA device
        obs, info = senv.reset(seed=0)
        obs, r, term, trunc, info = senv.step(actions)

    The env's envs must divide over the mesh. Outputs lie on the mesh's
    first device, and equal the unsharded env's. `self.env` is the env's
    view over every row on that device: reset and the host's work of a step
    run there, and other attributes come from it. On CUDA devices `step`
    and `rollout` replay each shard's `_advance` and `_observe` captured as
    graphs on its device (`core.graph.ShardedGraphs`, captured at the first
    call of a key, as the unsharded env's), so two shards on one card cost
    two graphs' replays a step, not twice the host's launches; on the CPU
    the shards step op by op (`_step_eager`, `_rollout_eager`)."""

    _graphs = None  # core.graph.ShardedGraphs, made at the first step on a card

    def __init__(self, env, mesh=None):
        if type(env) not in SHARDABLE:
            raise TypeError(f"ShardedEnv does not shard {type(env).__name__}: it shards "
                            + ", ".join(c.__name__ for c in SHARDABLE))
        self.mesh = make_mesh(mesh)
        if len({d.type for d in self.mesh}) > 1:
            raise ValueError(f"the mesh {self.mesh} mixes device types: all CUDA or all CPU")
        n = len(self.mesh)
        envs = env.config["num_envs"]
        if envs % n:
            raise AssertionError(f"num_envs={envs} must divide over {n} devices")
        rows = env.num_envs // n
        self._bounds = [(k * rows, (k + 1) * rows) for k in range(n)]
        self.env = env._shard(0, env.num_envs, self.mesh[0])
        self.env._state = self.env._last_obs = None  # the shards hold the live state
        self.shards = [env._shard(r0, r1, d) for (r0, r1), d in zip(self._bounds, self.mesh)]
        lidar = env.config["vehicle_config"]["lidar"]
        self._noisy = lidar.get("gaussian_noise", 0) > 0 or lidar.get("dropout_prob", 0) > 0
        if self._noisy:
            # the batch's step-count sum each shard folds into its noise key:
            # one buffer a shard, filled before it observes (a graph reads it)
            for sh in self.shards:
                sh._batch_step_sum = torch.zeros((), dtype=torch.int64, device=sh.device)
        self._cap = None

    # ---- moving rows between the whole batch and the shards ---------------
    def _cut(self, x):
        """Each shard's rows of ``x`` (a tensor or tree over the batch's
        rows), on the shard's device."""
        return [map_tensors(lambda t: t.to(sh.device), take_rows(x, r0, r1))
                for sh, (r0, r1) in zip(self.shards, self._bounds)]

    def _gather(self, parts, dim=0):
        """The shards' parts joined along ``dim`` on the mesh's first
        device, copies; a tensor without that axis (a 0-d counter every
        shard keeps alike) comes from the first shard."""
        first, dev = parts[0], self.mesh[0]
        if torch.is_tensor(first):
            if first.dim() <= dim:
                return first.to(dev, copy=True)
            return torch.cat([p.to(dev) for p in parts], dim)
        if isinstance(first, _Tree):
            return tree_map(lambda *ps: self._gather(list(ps), dim), *parts)
        if type(first) in (tuple, list):
            return type(first)(self._gather([p[i] for p in parts], dim)
                               for i in range(len(first)))
        if type(first) is dict:
            return {k: self._gather([p[k] for p in parts], dim) for k in first}
        return first

    def _step_sum(self, state):
        """A shard's part of the batch's step-count sum (None without lidar
        noise, which alone reads it)."""
        return state.step_count.sum() if self._noisy else None

    def _hand_out_step_sum(self, parts):
        """The shards' parts summed on the mesh's first device, copied into
        every shard's buffer."""
        dev = self.mesh[0]
        total = sum((p.to(dev) for p in parts[1:]), parts[0].to(dev))
        for sh in self.shards:
            sh._batch_step_sum.copy_(total)

    def _observe(self, states, obs_args):
        """Every shard's observation, after every shard advanced: with lidar
        noise each is handed the batch's step-count sum."""
        if self._noisy:
            self._hand_out_step_sum([self._step_sum(st) for st in states])
        return [sh._observe(st, *args) for sh, st, args in zip(self.shards, states, obs_args)]

    def _graphs_or_none(self):
        """The shards' captured steps (`core.graph.ShardedGraphs`), or None
        on a CPU mesh, whose shards step eagerly."""
        capture = graph.capture_backend(self.mesh[0])
        if capture is None:
            return None
        if self._graphs is None:
            self._graphs = graph.ShardedGraphs(capture, len(self.shards))
        return self._graphs

    def _follow_cap(self):
        """The shards' scenario band follows the env's `num_scenarios`, which
        a curriculum narrows or widens on the host."""
        n = self.env.num_scenarios
        if n == self._cap:
            return
        self._cap = n
        for sh in self.shards:
            if sh._state is not None:
                cap = torch.full_like(sh._state.scenario_cap, n)
                sh._state = sh._state.replace(scenario_cap=cap)

    @property
    def num_scenarios(self):
        return self.env.num_scenarios

    @num_scenarios.setter
    def num_scenarios(self, n):
        self.env.num_scenarios = n
        self._follow_cap()

    # ---- the env API --------------------------------------------------------
    def reset(self, seed=0):
        """The env's reset over the whole batch on the mesh's first device,
        cut into the shards' rows; each shard then observes its rows."""
        host = self.env
        state, obs_args, info = host._reset_state(prng.prng_key(0 if seed is None else seed,
                                                                host.device))
        states = self._cut(state)
        for sh, st in zip(self.shards, states):
            sh._state = st
        obs = self._observe(states, self._cut(obs_args))
        frames = []
        for sh, o in zip(self.shards, obs):
            sh._last_obs = o
            frames.append(sh._frame_obs(o, graphs=sh._graphs_or_none()))
        self._cap = host.num_scenarios
        return host._reset_outputs(self._gather(frames), info)

    def step(self, actions):
        """One step of every shard; the host's work before and after it runs
        once, on the whole batch. On CUDA devices each shard's step is a
        replay of its graphs (`core.graph.ShardedGraphs.step`)."""
        return self._step(actions, self._graphs_or_none())

    def _step_eager(self, actions):
        """`step` with every shard's step dispatched op by op, on any mesh.
        Nothing chooses it: it is called by name, to hold the replayed step
        against it and to profile the eager step."""
        return self._step(actions, None)

    def _step(self, actions, graphs):
        host = self.env
        blocks = self._cut(host._step_actions(actions))
        if graphs is None:
            adv = [sh._advance(sh._state, a, sh._prev_obs())
                   for sh, a in zip(self.shards, blocks)]
            states = [a[0] for a in adv]
            obs = self._observe(states, [a[1] for a in adv])
            for sh, st, o in zip(self.shards, states, obs):
                sh._state, sh._last_obs = st, o
            outs = [a[2:] for a in adv]
        else:
            outs = graphs.step(self, blocks)
        frames = [sh._frame_obs(sh._last_obs, term, trunc, graphs and sh._graphs_or_none())
                  for sh, (_, term, trunc, _) in zip(self.shards, outs)]
        # joined copies: the graphs' outputs are overwritten by the next step
        reward, terminated, truncated, info = (self._gather([o[i] for o in outs])
                                               for i in range(4))
        out = host._step_outputs(self._gather(frames), reward, terminated, truncated, info)
        self._follow_cap()
        return out

    def _blocks(self, actions):
        host = self.env
        fixed = (host._as_tensor(actions, torch.float32) if actions is not None
                 else torch.zeros((host.num_envs, 2), device=host.device))
        return self._cut(fixed.reshape(host.num_envs, -1))

    def rollout(self, n_steps, policy_fn=None, actions=None, collect=("reward",)):
        """`VectorEnvLoop.rollout` over the shards, with no host sync inside
        the loop; the collected tensors are joined once, after the loop. On
        CUDA devices every step replays each shard's graphs, captured at the
        first call for (policy_fn, collect, num_scenarios, shapes) as the
        unsharded env's (`core.graph.ShardedGraphs.rollout`); on the CPU the
        shards step op by op.

        ``policy_fn(obs, state)`` sees the whole batch: the observation
        [rows, D] and the state joined on the mesh's first device, as the
        unsharded env gives them; its actions [rows, 2] are cut to the
        shards. A policy that draws over the batch from one key (as
        examples/train_ppo.py's `sample_policy` does) thus gives the
        unsharded result, for a copy of the state a step."""
        graphs = self._graphs_or_none()
        if graphs is None:
            return self._rollout_eager(n_steps, policy_fn, actions, collect)
        outs = graphs.rollout(self, n_steps, policy_fn, self._blocks(actions), collect)
        return self._joined_outs(outs, collect)

    def _joined_outs(self, outs, collect):
        outs = {k: self._gather([o[k] for o in outs], dim=1) for k in collect}
        mean_reward = float(outs["reward"].mean()) if "reward" in outs else 0.0
        return outs, mean_reward

    def _rollout_eager(self, n_steps, policy_fn=None, actions=None, collect=("reward",)):
        """`rollout` with every shard's step dispatched op by op, on any
        mesh. Nothing chooses it on CUDA devices: it is called by name, to
        hold the replayed rollout against it and to profile the eager
        step."""
        graph.refuse_sharded_image(collect)
        blocks = self._blocks(actions)
        states = [sh._state for sh in self.shards]
        obs = [sh._last_obs for sh in self.shards]
        outs = [{k: [] for k in collect} for _ in self.shards]
        for _ in range(n_steps):
            if policy_fn is not None:
                blocks = self._cut(policy_fn(self._gather(obs), self._gather(states)))
            adv = [sh._advance(st, a) for sh, st, a in zip(self.shards, states, blocks)]
            states = [a[0] for a in adv]
            obs = self._observe(states, [a[1] for a in adv])
            for sh, out, st, o, (_, _, reward, term, trunc, info) in zip(
                    self.shards, outs, states, obs, adv):
                special = dict(reward=reward, obs=o, terminated=term, truncated=trunc,
                               **sh._rollout_fields(st))
                for k in collect:
                    out[k].append(special[k] if k in special else info[k])
        for sh, st, o in zip(self.shards, states, obs):
            sh._state, sh._last_obs = st, o
        stacked = [{k: tree_map(lambda *xs: torch.stack(xs), *v) for k, v in out.items()}
                   for out in outs]
        return self._joined_outs(stacked, collect)

    def mean_metrics(self, info, keys=("step_reward", "cost")):
        """Means over every row of every shard (`step`'s info is joined)."""
        return {k: info[k].float().mean() for k in keys if k in info}

    def close(self):
        for sh in self.shards:
            sh.close()
        self.env.close()
        self._graphs = None

    # ---- the state, and the methods that read or write it ----------------
    @property
    def _state(self):
        """The shards' states joined on the mesh's first device (a copy;
        None before reset). Setting it cuts a whole-batch state to the
        shards."""
        if self.shards[0]._state is None:
            return None
        return self._gather([sh._state for sh in self.shards])

    @_state.setter
    def _state(self, state):
        for sh, st in zip(self.shards, self._cut(state)):
            sh._state = st

    @property
    def _last_obs(self):
        """The shards' last state observations joined (None before reset)."""
        if self.shards[0]._last_obs is None:
            return None
        return self._gather([sh._last_obs for sh in self.shards])

    def _need(self, name):
        if not hasattr(self.env, name):
            raise AttributeError(f"{type(self.env).__name__} has no {name}")
        if self.shards[0]._state is None:
            raise RuntimeError(f"reset() the env before {name}")

    def set_break_down(self, rows=None, break_down=True):
        """`BaseVectorEnv.set_break_down` with ``rows`` over the whole batch."""
        self._need("set_break_down")
        dev = self.mesh[0]
        mask = torch.ones(self.env.num_envs, dtype=torch.bool, device=dev)
        if rows is not None:
            mask = torch.zeros_like(mask)
            mask[torch.as_tensor(rows, device=dev)] = True
        for sh, m in zip(self.shards, self._cut(mask)):
            ego = sh._state.ego
            sh._state = sh._state.replace(ego=ego.replace(
                break_down=torch.where(m, break_down, ego.break_down)))

    def snapshot(self):
        """The whole batch's state as a host tree of numpy arrays."""
        self._need("snapshot")
        return tree_map(lambda x: x.detach().cpu().numpy(), self._state)

    def restore(self, snap):
        """`BaseVectorEnv.restore` of a whole-batch snapshot: the shards
        take their rows and observe them at zero offsets."""
        import numpy as np
        self._need("restore")
        state = tree_map(lambda x: torch.from_numpy(np.array(x)), snap)
        states = self._cut(state)
        zeros = [(torch.zeros(sh.num_envs, device=sh.device),) * 2 for sh in self.shards]
        for sh, st, o in zip(self.shards, states, self._observe(states, zeros)):
            sh._state, sh._last_obs = st, o

    def record_episode(self, n_steps, policy_fn=None, actions=None):
        """`BaseVectorEnv.record_episode` through the sharded `rollout`."""
        self._need("record_episode")
        outs, _ = self.rollout(
            n_steps, policy_fn=policy_fn, actions=actions,
            collect=("state", "obs", "reward", "terminated", "truncated", "ego_action"))
        return {k: tree_map(lambda x: x.detach().cpu().numpy(), v) for k, v in outs.items()}

    def replay_frame(self, recording, t):
        """`BaseVectorEnv.replay_frame`: restore recorded step ``t``."""
        self.restore(tree_map(lambda x: x[t], recording["state"]))
        return self._last_obs

    def render(self, mode="topdown", **kwargs):
        """The env's render of the joined state."""
        self._need("render")
        self.env._state = self._state
        try:
            return self.env.render(mode, **kwargs)
        finally:
            self.env._state = None

    def __getattr__(self, name):
        """Everything else from the env's view (it holds no live state:
        `get_map_features`, `dump_all_maps`, the spaces read the pack and
        the config)."""
        if name == "env":  # not set yet
            raise AttributeError(name)
        return getattr(self.env, name)
