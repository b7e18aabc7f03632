"""The step-graph runner (metadrive_ped_torch/core/graph.py) on the CPU.

The CPU has no CUDA graphs, so these tests put a stand-in in their place
(`EagerGraph`): its capture computes the region's outputs on copies of the
buffers (a capture executes nothing), and its replay runs the captured
callable on the buffers and writes the results into the captured outputs.
Everything else is the runner's path on the card. Against the eager loop
(`_rollout_eager`, `_step_eager`) the replayed steps are bit-equal; against
the JAX package's `rollout`, at the parity tolerances of
tests/test_torch_env.py and tests/_torch_parity.py."""
import collections

import numpy as np
import pytest
import torch
from _torch_parity import assert_trees_close, np_tree, obs_gap, to_np, yaw_column

import metadrive_ped_torch as T
import metadrive_ped_tpu as J
from metadrive_ped_torch.core import graph, launches
from metadrive_ped_torch.core.convert import state_to_numpy
from metadrive_ped_torch.core.structs import map_tensors
from metadrive_ped_torch.ops import ray_segment

CFG = dict(num_envs=4, map="SCS", num_scenarios=2, traffic_density=0.1,
           vehicle_config=dict(side_detector=dict(num_lasers=8, distance=50.0),
                               lane_line_detector=dict(num_lasers=6, distance=20.0)))
FULL = torch.tensor([[0.0, 1.0]] * 4)
COLLECT = ("reward", "obs", "terminated", "truncated", "state")
ATOL = 1e-4


class EagerGraph:
    """The test's stand-in for `graph.CudaGraphCapture`: the captured
    callable re-run eagerly at each replay. A replay runs no Python on the
    card, so the re-run's kernel launches are not counted (the runner adds
    the capture's tally)."""

    captures = 0

    def __init__(self, device):
        self.device = device

    def warm_up(self, fn, buffers):
        for _ in range(graph.WARMUP_STEPS):
            fn(map_tensors(torch.clone, buffers))

    def capture(self, fn, buffers):
        EagerGraph.captures += 1
        outs = fn(map_tensors(torch.clone, buffers))

        def replay():
            with launches.uncounted():
                new = fn(buffers)
            for dst, src in zip(graph.leaves(outs), graph.leaves(new)):
                dst.copy_(src)
        return outs, replay


@pytest.fixture
def replays(monkeypatch):
    """Route the CPU's steps through the runner with `EagerGraph`."""
    monkeypatch.setattr(graph, "capture_backend", lambda device: EagerGraph)
    EagerGraph.captures = 0


def pair(cls=T.MetaDriveEnv, cfg=CFG, seed=0):
    a, b = cls(cfg, device="cpu"), cls(cfg, device="cpu")
    a.reset(seed=seed)
    b.reset(seed=seed)
    return a, b


def bit_equal(x, y):
    xs, ys = graph.leaves(x), graph.leaves(y)
    return len(xs) == len(ys) and all(torch.equal(p, q) for p, q in zip(xs, ys))


def test_the_cpu_runs_eagerly():
    env = T.MetaDriveEnv(CFG, device="cpu")
    env.reset(seed=0)
    env.rollout(2, actions=FULL)
    env.step(FULL)
    assert graph.capture_backend(env.device) is None and env._graphs is None


@pytest.mark.parametrize("auto_reset", [True, False])
def test_replayed_rollout_and_step_equal_the_eager_ones(replays, auto_reset):
    """Without the auto-reset, whose selects make every leaf of the new
    state a new tensor, the new state's leaves alias the old buffers (its
    last_pos is the old pos, its current_action the actions buffer): the
    write-back must not read a buffer it already overwrote."""
    a, b = pair(cfg=dict(CFG, auto_reset=auto_reset))
    for n in (6, 1, 9):
        assert bit_equal(a.rollout(n, actions=FULL, collect=COLLECT),
                         b._rollout_eager(n, actions=FULL, collect=COLLECT))
    for _ in range(4):
        assert bit_equal(a.step(FULL), b._step_eager(FULL))
    assert bit_equal((a._state, a._last_obs), (b._state, b._last_obs))
    assert a._graphs.captures == 2 and a._graphs.replays == 20


def test_collected_steps_do_not_alias_the_buffers(replays):
    env = T.MetaDriveEnv(CFG, device="cpu")
    env.reset(seed=0)
    outs, _ = env.rollout(8, actions=FULL, collect=COLLECT)
    buffers = {graph._storage(t) for t in graph.leaves(env._graphs._rollout.buffers)}
    assert not buffers & {graph._storage(t) for t in graph.leaves(outs)}
    for k in ("obs", "reward"):
        assert not torch.equal(outs[k][0], outs[k][-1]), k
    assert not torch.equal(outs["state"].ego.pos[0], outs["state"].ego.pos[-1])
    # the new state's last_pos is the old pos: written back unaliased
    torch.testing.assert_close(outs["state"].ego.last_pos[1:], outs["state"].ego.pos[:-1],
                               rtol=0, atol=0)
    # what `step` returns is the caller's: the next step leaves it be
    first = env.step(FULL)
    kept = map_tensors(torch.clone, first)
    env.step(FULL)
    assert bit_equal(first, kept)


def _restore(env):
    snap = env.snapshot()
    env.rollout(3, actions=FULL, collect=COLLECT)
    env.restore(snap)


def _break_down(env):
    env.set_break_down([0, 2])


def _reset(env):
    env.reset(seed=5)


def _replay_frame(env):
    rec = env.record_episode(4, actions=FULL)
    env.replay_frame(rec, 1)


BETWEEN = dict(restore=_restore, set_break_down=_break_down, reset=_reset,
               replay_frame=_replay_frame)


@pytest.mark.parametrize("name", sorted(BETWEEN))
def test_state_set_between_rollouts_reaches_the_replay(replays, name):
    a, b = pair()
    runs = []
    for env, roll in ((a, a.rollout), (b, b._rollout_eager)):
        first = roll(5, actions=FULL, collect=COLLECT)
        BETWEEN[name](env)
        runs.append((first, roll(10, actions=FULL, collect=COLLECT)))
    assert bit_equal(runs[0], runs[1])
    assert bit_equal(a._state, b._state)
    # the last call ran on the buffers it loaded: the env's state is theirs
    assert a._state is a._graphs._rollout.state


def test_a_curriculum_level_reaches_the_replay(replays):
    cfg = dict(CFG, num_scenarios=4, horizon=6)
    a, b = (T.CurriculumWrapper(T.MetaDriveEnv(cfg, device="cpu"), curriculum_level=2)
            for _ in range(2))
    a.reset(seed=0)
    b.reset(seed=0)
    runs = []
    for w, roll in ((a, a.rollout), (b, b.env._rollout_eager)):
        first = roll(8, actions=FULL, collect=COLLECT)
        w.level_up()
        runs.append((first, roll(20, actions=FULL, collect=COLLECT + ("env_seed",))))
    assert bit_equal(runs[0], runs[1])
    # the widened band: auto-resets draw scenarios past the first band
    assert int(runs[0][1][0]["state"].scenario_cap.min()) == 4
    assert a.env._graphs.captures == 2


def test_captures_follow_the_key(replays):
    """As the JAX package's `_rollout_cache_key` (metadrive_ped_tpu/envs/
    base.py:506-525) without n_steps: the same (policy_fn, collect,
    num_scenarios) replays, a new one captures once."""
    env = T.MetaDriveEnv(CFG, device="cpu")
    env.reset(seed=0)
    policy = lambda obs, state: torch.tanh(obs[:, :2])  # noqa: E731
    calls = [
        (dict(n_steps=3, actions=FULL), 1),
        (dict(n_steps=7, actions=FULL), 1),                     # another length
        (dict(n_steps=2, actions=FULL * 0.5), 1),               # other fixed actions
        (dict(n_steps=2, actions=FULL, collect=("obs",)), 2),   # another collect
        (dict(n_steps=2, policy_fn=policy), 3),                 # a policy
        (dict(n_steps=4, policy_fn=policy), 3),
        (dict(n_steps=2, policy_fn=lambda o, s: policy(o, s)), 4),  # a new policy object
    ]
    for kwargs, captures in calls:
        env.rollout(**kwargs)
        assert env._graphs.captures == captures, kwargs
    env.num_scenarios = 1
    env.rollout(2, policy_fn=env._graphs._rollout.key[0])
    assert env._graphs.captures == 5
    env.step(FULL)
    env.step(FULL)
    assert env._graphs.captures == 6 and EagerGraph.captures == 6


def test_kernel_launches_count_replays_not_captures(replays, monkeypatch):
    """A stand-in kernel wrapper records each call, as the card's does: the
    warm-up's calls are not counted, the capture's go into its tally, each
    replay adds the tally, so a graph env counts what an eager one does."""
    plain = ray_segment.detector_clouds

    def counted(*args):
        launches.record(ray_segment, 7)
        return plain(*args)

    monkeypatch.setattr(ray_segment, "detector_clouds", counted)
    monkeypatch.setattr(ray_segment, "launches", 0)
    monkeypatch.setattr(ray_segment, "launches_by_device", ray_segment.collections.Counter())
    a, b = pair()
    counts = []
    for env, roll, step in ((a, a.rollout, a.step), (b, b._rollout_eager, b._step_eager)):
        ray_segment.launches = 0
        ray_segment.launches_by_device.clear()
        roll(6, actions=FULL, collect=())
        roll(3, actions=FULL, collect=())
        step(FULL)
        step(FULL)
        counts.append((ray_segment.launches, dict(ray_segment.launches_by_device)))
    assert counts[0] == counts[1] == (11, {7: 11})
    assert EagerGraph.captures == 2


def test_launch_counts_outside_inside_and_after_a_capture():
    """`core.launches`: a launch counts at once; one made while a capture is
    open goes into its tally and counts at each replay; one inside
    `uncounted` never counts."""
    class Kernel:  # a wrapper's counter, as ops/ray_segment.py's module is
        launches = 0
        launches_by_device = collections.Counter()

    counter = Kernel()
    launches.record(counter, 0)
    with launches.uncounted():
        launches.record(counter, 0)
    with launches.capturing() as tally:
        launches.record(counter, 1)
        launches.record(counter, 1)
    assert (counter.launches, dict(counter.launches_by_device)) == (1, {0: 1})
    for _ in range(3):
        launches.replayed(tally)
    assert (counter.launches, dict(counter.launches_by_device)) == (7, {0: 1, 1: 6})


# ---- ShardedEnv: each shard's step replayed (core.graph.ShardedGraphs) ---

def _sample_policy(env):
    """examples/train_ppo.py's sampling policy: an MLP and a draw over the
    batch from one key (folded with the batch's step-count sum)."""
    from metadrive_ped_torch.core import prng
    from metadrive_ped_torch.examples import train_ppo as ppo
    key = prng.prng_key(0, "cpu")
    return ppo.sample_policy(ppo.PolicyValue(env.observation_dim, key=key, device="cpu"),
                             prng.split(key, 2)[1])


NOISE = dict(CFG, vehicle_config=dict(CFG["vehicle_config"],
                                      lidar=dict(gaussian_noise=0.05, dropout_prob=0.1)))
# name -> (class, config, mesh, policy maker or None)
SHARDED = {
    "fixed_actions": (T.MetaDriveEnv, CFG, ["cpu"] * 2, None),
    "batch_key_policy": (T.MetaDriveEnv, CFG, ["cpu"] * 2, _sample_policy),
    # distinct mesh entries: the policy's join and cut run between replays
    "batch_key_policy_two_devices": (T.MetaDriveEnv, CFG, ["cpu:0", "cpu:1"], _sample_policy),
    "lidar_noise": (T.MetaDriveEnv, NOISE, ["cpu"] * 2, None),
    "roundabout": (T.MultiAgentRoundaboutEnv, dict(num_envs=2, num_agents=4), ["cpu"] * 2, None),
}


def sharded_trio(name, cfg=None):
    """(sharded env, another over the same mesh, the unsharded env), each
    reset with seed 0, and the case's policy or None."""
    from metadrive_ped_torch.parallel import ShardedEnv
    cls, base, mesh, policy = SHARDED[name]
    envs = [cls(cfg or base, device="cpu") for _ in range(3)]
    trio = (ShardedEnv(envs[0], mesh), ShardedEnv(envs[1], mesh), envs[2])
    for env in trio:
        env.reset(seed=0)
    return trio, policy and policy(envs[2])


def _step_actions(senv):
    """Full throttle on every row, in the shape `step` takes ([E, A, 2]
    for the multi-agent envs)."""
    return torch.tensor([[0.0, 1.0]] * senv.num_envs).reshape(senv.config["num_envs"], -1, 2)


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_replayed_sharded_rollout_and_step_equal_eager_and_unsharded(replays, name):
    """The replayed sharded rollout and step, bit for bit against the
    eager shard loop (`_rollout_eager`, `_step_eager`) and the replayed
    unsharded env."""
    (a, b, u), policy = sharded_trio(name)
    kw = dict(policy_fn=policy) if policy else dict(actions=torch.tensor([[0.0, 1.0]] * a.num_envs))
    for n in (6, 1, 9):
        run = a.rollout(n, collect=COLLECT, **kw)
        assert bit_equal(run, b._rollout_eager(n, collect=COLLECT, **kw))
        assert bit_equal(run, u.rollout(n, collect=COLLECT, **kw))
    act = _step_actions(a)
    for _ in range(4):
        out = a.step(act)
        assert bit_equal(out, b._step_eager(act)) and bit_equal(out, u.step(act))
    assert bit_equal((a._state, a._last_obs), (u._state, u._last_obs))
    assert bit_equal((a._state, a._last_obs), (b._state, b._last_obs))
    assert a._graphs.captures == 2 and a._graphs.replays == 20
    assert a._graphs.shard_replays == [20, 20]
    # every shard's state and last observation are its graphs' buffers
    for sh, unit in zip(a.shards, a._graphs._step.shards):
        assert sh._state is unit.buffers["state"] and sh._last_obs is unit.buffers["obs"]


@pytest.mark.parametrize("name", sorted(BETWEEN))
def test_state_set_between_sharded_rollouts_reaches_the_replay(replays, name):
    """`restore`, `set_break_down`, `reset` and `replay_frame` rebind the
    shards' leaves: the next replay loads them (rule 2)."""
    (a, b, _), _ = sharded_trio("fixed_actions")
    runs = []
    for env, roll in ((a, a.rollout), (b, b._rollout_eager)):
        first = roll(5, actions=FULL, collect=COLLECT)
        BETWEEN[name](env)
        runs.append((first, roll(10, actions=FULL, collect=COLLECT)))
    assert bit_equal(runs[0], runs[1])
    assert bit_equal(a._state, b._state)


def test_a_curriculum_level_reaches_the_sharded_replay(replays):
    """The curriculum's wider band reaches the shards' next replay: a new
    num_scenarios captures again, and its scenario cap is loaded."""
    from metadrive_ped_torch.parallel import ShardedEnv
    cfg = dict(CFG, num_scenarios=4, horizon=6)
    a, b = (T.CurriculumWrapper(ShardedEnv(T.MetaDriveEnv(cfg, device="cpu"), ["cpu"] * 2),
                                curriculum_level=2) for _ in range(2))
    a.reset(seed=0)
    b.reset(seed=0)
    runs = []
    for w, roll in ((a, a.rollout), (b, b.env._rollout_eager)):
        first = roll(8, actions=FULL, collect=COLLECT)
        w.level_up()
        runs.append((first, roll(20, actions=FULL, collect=COLLECT + ("env_seed",))))
    assert bit_equal(runs[0], runs[1])
    assert int(runs[0][1][0]["state"].scenario_cap.min()) == 4
    assert a.env._graphs.captures == 2


def test_sharded_captures_follow_the_key(replays):
    """As the unsharded env's keys: another length or other fixed actions
    replay; another collect, a policy, a new policy object, another
    num_scenarios and `step` capture. A capture is two graphs a shard (its
    advance and observe), and one more for a policy."""
    (senv, _, _), _ = sharded_trio("fixed_actions")
    policy = lambda obs, state: torch.tanh(obs[:, :2])  # noqa: E731
    calls = [
        (dict(n_steps=3, actions=FULL), 1, 4),
        (dict(n_steps=7, actions=FULL), 1, 4),
        (dict(n_steps=2, actions=FULL * 0.5), 1, 4),
        (dict(n_steps=2, actions=FULL, collect=("obs",)), 2, 8),
        (dict(n_steps=2, policy_fn=policy), 3, 13),
        (dict(n_steps=4, policy_fn=policy), 3, 13),
        (dict(n_steps=2, policy_fn=lambda o, s: policy(o, s)), 4, 18),
    ]
    for kwargs, captures, graphs in calls:
        senv.rollout(**kwargs)
        assert (senv._graphs.captures, EagerGraph.captures) == (captures, graphs), kwargs
    senv.num_scenarios = 1
    senv.rollout(2, policy_fn=senv._graphs._rollout.key[0])
    assert (senv._graphs.captures, EagerGraph.captures) == (5, 23)
    senv.step(_step_actions(senv))
    senv.step(_step_actions(senv))
    assert (senv._graphs.captures, EagerGraph.captures) == (6, 27)
    # each shard's graphs live on its device, over its own buffers
    units = senv._graphs._step.shards
    assert [u.advance.state is u.observe.state for u in units] == [True, True]
    assert units[0].buffers["state"] is not units[1].buffers["state"]


def test_sharded_kernel_launches_count_replays_not_captures(replays, monkeypatch):
    """Each shard's replay adds its capture's tally: the kernel's launches
    are shards x steps (and one a shard at reset), captures and warm-ups
    not counted, as the eager shard loop counts them."""
    plain = ray_segment.detector_clouds

    def counted(*args):
        launches.record(ray_segment, 7)
        return plain(*args)

    monkeypatch.setattr(ray_segment, "detector_clouds", counted)
    monkeypatch.setattr(ray_segment, "launches", 0)
    monkeypatch.setattr(ray_segment, "launches_by_device", ray_segment.collections.Counter())
    (a, b, _), _ = sharded_trio("fixed_actions")
    counts = []
    for env, roll, step in ((a, a.rollout, a.step), (b, b._rollout_eager, b._step_eager)):
        ray_segment.launches = 0
        ray_segment.launches_by_device.clear()
        env.reset(seed=0)
        roll(6, actions=FULL, collect=())
        roll(3, actions=FULL, collect=())
        step(_step_actions(env))
        step(_step_actions(env))
        counts.append((ray_segment.launches, dict(ray_segment.launches_by_device)))
    assert counts[0] == counts[1] == (2 * 12, {7: 2 * 12})
    assert EagerGraph.captures == 2 * 2 * 2


IMAGE = dict(CFG, image_observation=True, stack_size=3, sensors=dict(main_camera=("rgb", 32, 32)))


def test_replayed_camera_frame_equals_the_eager_one(replays):
    """`_image_obs` through the frame graph (`EnvGraphs.frame`): bit for bit
    the eager frame and stack over 3 steps; the frame graph reads the step
    graph's state buffers; `reset` clears the stack and loads the new state;
    another modality captures a new frame graph."""
    a, b = T.MetaDriveEnv(IMAGE, device="cpu"), T.MetaDriveEnv(IMAGE, device="cpu")
    for seed in (0, 1):
        first = a.reset(seed=seed), b.reset(seed=seed)
        assert bit_equal(*first)
        assert not bool(first[0][0]["image"][..., :2].any())  # the stack starts afresh
        for _ in range(3):
            # `_step_eager` renders op by op
            assert bit_equal(a.step(FULL), b._step_eager(FULL))
            assert a._graphs._frame.state is a._state is a._graphs._step.state
    # the first reset's frame graph over its own buffers, the first step's
    # over the step graph's, and the step graph
    assert a._graphs.captures == 3 and a._graphs.frame_replays == 8
    for env in (a, b):
        env.config["sensors"]["main_camera"] = ("depth", 32, 32)
    assert bit_equal(a.reset(seed=2), b.reset(seed=2))
    out = a.step(FULL)
    assert bit_equal(out, b._step_eager(FULL)) and out[0]["image"].shape == (4, 32, 32, 1, 3)
    assert a._graphs.captures == 5


def _pg_case():
    cfg = dict(CFG, num_envs=8)
    act = np.clip(np.random.RandomState(0).normal([0.0, 0.6], [0.3, 0.4], (8, 2)),
                  -1, 1).astype(np.float32)
    return J.MetaDriveEnv(cfg), T.MetaDriveEnv(cfg, device="cpu"), act, 40


def _marl_case():
    cfg = dict(num_envs=2, num_agents=4, delay_done=5)
    act = np.tile(np.float32([0.0, 1.0]), (8, 1))
    return J.MultiAgentRoundaboutEnv(cfg), T.MultiAgentRoundaboutEnv(cfg, device="cpu"), act, 30


@pytest.mark.parametrize("case", [_pg_case, _marl_case], ids=["pg_detectors", "marl"])
def test_replayed_rollout_matches_jax(replays, case):
    """The replayed rollout on the CPU against the JAX package's lax.scan
    rollout from the same seed and actions: obs (yaw through cos, as
    `obs_gap`) and reward within 1e-4, the done flags and the final state's
    ints and bools equal, its floats within 1e-4."""
    jenv, tenv, act, steps = case()
    yaw = yaw_column(tenv.config["vehicle_config"])
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    collect = ("obs", "reward", "terminated", "truncated")
    jouts, jmean = jenv.rollout(steps, actions=act, collect=collect)
    touts, tmean = tenv.rollout(steps, actions=torch.from_numpy(act), collect=collect)
    assert tenv._graphs.captures == 1 and tenv._graphs.replays == steps
    D = touts["obs"].shape[-1]
    assert obs_gap(np.asarray(jouts["obs"]).reshape(-1, D), to_np(touts["obs"]).reshape(-1, D),
                   yaw) <= ATOL
    np.testing.assert_allclose(to_np(touts["reward"]), np.asarray(jouts["reward"]), rtol=0,
                               atol=ATOL)
    for k in ("terminated", "truncated"):
        np.testing.assert_array_equal(to_np(touts[k]), np.asarray(jouts[k]))
    assert tmean == pytest.approx(jmean, abs=ATOL)
    assert_trees_close(np_tree(jenv._state), state_to_numpy(tenv._state), atol=ATOL)
