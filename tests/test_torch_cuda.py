"""The CUDA kernel on the card: it builds, agrees with its plain version hit
for hit, counts its launches, and carries both of the env's detector clouds
in one launch per step. These tests need an NVIDIA GPU with nvcc and skip
elsewhere. On the card, where JAX is not installed, run them without
tests/conftest.py (which imports jax):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import collections
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the kernel's cases, shared with the card run)

pytestmark = pytest.mark.cuda

CASES = {
    "main_path_like": lambda: chip_smoke.random_line_case(64, 16, 470, 160, 12, seed=1),
    "ragged": lambda: chip_smoke.random_line_case(129, 7, 1500, 160, 12, seed=2),
    "n_cont_0_n_any_1": lambda: chip_smoke.random_line_case(1024, 64, 1, 160, 12, seed=3,
                                                            counts=[[0, 1]] * 64),
    "Rs_300": lambda: chip_smoke.random_line_case(7, 3, 777, 300, 12, seed=4),
    "Rs_0": lambda: chip_smoke.random_line_case(9, 2, 100, 0, 12, seed=5),
    "Rl_0": lambda: chip_smoke.random_line_case(9, 2, 100, 160, 0, seed=6),
    "Rl_40": lambda: chip_smoke.random_line_case(9, 2, 100, 160, 40, seed=7),
    "adversarial": chip_smoke.adversarial_line_case,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    from metadrive_ped_torch.ops import ray_segment as rs
    args = chip_smoke.to_device(CASES[case](), cuda)
    before = rs.launches
    out = rs.detector_clouds(*args)
    ref = rs.detector_clouds_plain(*args)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        if a.numel():
            assert float((a - b).abs().max()) <= 1e-5
            assert int((a < 1).sum()) == int((b < 1).sum())
    assert any(bool((a < 1).any()) for a in out)


def test_kernel_rejects_what_it_cannot_take(cuda):
    from metadrive_ped_torch.ops import ray_segment as rs
    origin, sidx, side, lane, sd, ld, table, counts = chip_smoke.to_device(
        chip_smoke.random_line_case(4, 2, 16, 8, 4, seed=1), cuda)
    with pytest.raises(ValueError):
        rs.detector_clouds(origin, sidx, side, lane, sd, ld, table.double(), counts)
    with pytest.raises(ValueError):
        rs.detector_clouds(origin, sidx.long(), side, lane, sd, ld, table, counts)
    with pytest.raises(ValueError):
        rs.detector_clouds(origin, sidx, (side[0].t().contiguous().t(), side[1]), lane, sd, ld,
                           table, counts)
    with pytest.raises(ValueError):
        rs.detector_clouds(origin, sidx, side, lane, sd, ld, table[:, :, :2].contiguous(), counts)
    with pytest.raises(ValueError):
        rs.detector_clouds(origin, sidx, side, lane, sd, ld, table, counts.cpu())


def test_env_steps_through_the_kernel(cuda):
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import ray_segment as rs
    env = MetaDriveEnv(dict(num_envs=64, map="SCS", num_scenarios=2, traffic_density=0.1,
                            vehicle_config=dict(side_detector=dict(num_lasers=16),
                                                lane_line_detector=dict(num_lasers=6))),
                       device="cuda")
    rs.launches = 0
    env.reset(seed=0)
    act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
    for _ in range(10):
        obs, *_ = env.step(act)
    assert rs.launches == 10 + 1
    assert bool(torch.isfinite(obs).all())


def test_scenario_side_cloud_through_the_kernel(cuda):
    """ScenarioEnv's side detector over the continuous lines of PG-exported
    scenarios: the kernel's cloud equals its plain version hit for hit, and
    each step launches it once."""
    import math

    from metadrive_ped_torch import MetaDriveEnv, ScenarioEnv
    from metadrive_ped_torch.ops import ray_segment as rs
    from metadrive_ped_torch.ops.raycast import _fan_dirs
    from metadrive_ped_torch.scenario import export_scenarios
    src = MetaDriveEnv(dict(num_envs=4, map="SCS", num_scenarios=4, traffic_density=0.1),
                       device="cpu")
    src.reset(seed=0)
    sds = list(export_scenarios(src, 30, actions=[[0.0, 1.0]] * 4).values())
    env = ScenarioEnv(dict(num_envs=64, scenario_data=sds, reactive_traffic=True,
                           vehicle_config=dict(side_detector=dict(num_lasers=160))),
                      device="cuda")
    rs.launches = 0
    env.reset(seed=0)
    act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
    for _ in range(10):
        obs, *_ = env.step(act)
    assert rs.launches == 10 + 1
    assert bool(torch.isfinite(obs).all())
    st = env._state
    table, counts = env._line_table
    assert bool((counts[:, 0] > 0).all())
    none = st.ego.heading.new_zeros((64, 0))
    args = (st.ego.pos.contiguous(), st.sidx, _fan_dirs(st.ego.heading, 160, offset=math.pi / 2),
            (none, none), 50.0, 50.0, table, counts)
    (side, _), (ref, _) = rs.detector_clouds(*args), rs.detector_clouds_plain(*args)
    assert float((side - ref).abs().max()) <= 1e-5
    assert int((side < 1).sum()) == int((ref < 1).sum()) > 0


def test_tollgate_clouds_through_the_kernel(cuda):
    """The tollgate's detector clouds (side 72 and lane-line 4 rays at
    20 m over its float-endpoint line table): the kernel equals its plain
    version hit for hit, and each multi-agent step launches it once."""
    import math

    from metadrive_ped_torch import MultiAgentTollgateEnv
    from metadrive_ped_torch.ops import ray_segment as rs
    from metadrive_ped_torch.ops.raycast import _fan_dirs
    env = MultiAgentTollgateEnv(dict(num_envs=4, num_agents=16), device="cuda")
    rs.launches = 0
    env.reset(seed=0)
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    outs, _ = env.rollout(10, actions=act, collect=("obs",))
    assert rs.launches == 10 + 1
    assert bool(torch.isfinite(outs["obs"]).all())
    st = env._state
    fan = lambda R: _fan_dirs(st.ego.heading, R, offset=math.pi / 2)
    args = (st.ego.pos.contiguous(), st.sidx, fan(72), fan(4), 20.0, 20.0, *env._line_table)
    out, ref = rs.detector_clouds(*args), rs.detector_clouds_plain(*args)
    for a, b in zip(out, ref):
        assert float((a - b).abs().max()) <= 1e-5
        assert int((a < 1).sum()) == int((b < 1).sum())
    assert int((out[0] < 1).sum()) > 0


def test_sharded_env_launches_on_each_shards_device(cuda):
    """ShardedEnv over every card twice over: each shard launches the
    kernel once a step and at reset, on its own device, and the outputs are
    the unsharded env's."""
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import ray_segment as rs
    from metadrive_ped_torch.parallel import ShardedEnv
    mesh = [f"cuda:{i}" for i in range(torch.cuda.device_count())] * 2
    cfg = dict(num_envs=4 * len(mesh), map="SC", num_scenarios=2, traffic_density=0.1,
               vehicle_config=dict(side_detector=dict(num_lasers=16),
                                   lane_line_detector=dict(num_lasers=4)))
    plain, sharded = MetaDriveEnv(cfg), ShardedEnv(MetaDriveEnv(cfg), mesh)
    act = torch.tensor([0.0, 1.0], device="cuda:0").expand(cfg["num_envs"], 2)
    plain.reset(seed=0)
    out_p, _ = plain.rollout(5, actions=act, collect=("obs", "reward"))
    rs.launches_by_device.clear()
    sharded.reset(seed=0)
    out_s, _ = sharded.rollout(5, actions=act, collect=("obs", "reward"))
    torch.cuda.synchronize()
    assert dict(rs.launches_by_device) == {i: 2 * 6 for i in range(torch.cuda.device_count())}
    for k in ("obs", "reward"):
        assert float((out_p[k] - out_s[k]).abs().max()) <= 1e-5


def test_sharded_step_is_replays_only(cuda):
    """ShardedEnv over [cuda:0, cuda:0] after its captures: a replayed
    rollout equals the eager shard loop bit for bit, and a step launches
    two graphs a shard (advance, observe) and no kernel of a shard's step
    from the host (the eager step launches thousands)."""
    from torch.profiler import ProfilerActivity, profile

    from metadrive_ped_torch.parallel import ShardedEnv
    make = lambda: ShardedEnv(_pg_detectors(), ["cuda:0"] * 2)  # noqa: E731
    a, b = make(), make()
    act = torch.tensor([[0.0, 1.0]] * a.num_envs, device="cuda")
    collect = ("obs", "reward", "terminated", "truncated", "state")
    for env in (a, b):
        env.reset(seed=0)
    assert _equal_trees(a.rollout(6, actions=act, collect=collect),
                        b._rollout_eager(6, actions=act, collect=collect))
    a.rollout(1, actions=act, collect=())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a.rollout(1, actions=act, collect=())
        torch.cuda.synchronize()
    count = lambda prefix: sum(e.count for e in prof.key_averages()  # noqa: E731
                               if e.key.startswith(prefix))
    assert count("cudaGraphLaunch") == 2 * 2
    assert count("cudaLaunchKernel") <= 4
    assert a._graphs.replays == 8 and a._graphs.shard_replays == [8, 8]


def _sharded_pair(name):
    """Two ShardedEnvs over [cuda:0, cuda:0] of one small config, reset
    with seed 0, and the case's policy (examples/train_ppo.py's sampling
    policy) or None."""
    from metadrive_ped_torch import MetaDriveEnv, MultiAgentRoundaboutEnv
    from metadrive_ped_torch.core import prng
    from metadrive_ped_torch.examples import train_ppo as ppo
    from metadrive_ped_torch.parallel import ShardedEnv
    cfg = dict(num_envs=64, map="SCS", num_scenarios=2, traffic_density=0.1,
               vehicle_config=dict(side_detector=dict(num_lasers=16),
                                   lane_line_detector=dict(num_lasers=6)))
    make = lambda: MetaDriveEnv(cfg, device="cuda")  # noqa: E731
    if name == "lidar_noise":
        noisy = dict(cfg["vehicle_config"], lidar=dict(gaussian_noise=0.05, dropout_prob=0.1))
        make = lambda: MetaDriveEnv(dict(cfg, vehicle_config=noisy), device="cuda")  # noqa: E731
    elif name == "roundabout":
        make = lambda: MultiAgentRoundaboutEnv(dict(num_envs=16, num_agents=4),  # noqa: E731
                                               device="cuda")
    pair = [ShardedEnv(make(), ["cuda:0"] * 2) for _ in range(2)]
    for env in pair:
        env.reset(seed=0)
    policy = None
    if name == "batch_key_policy":
        key = prng.prng_key(0, "cuda")
        policy = ppo.sample_policy(
            ppo.PolicyValue(pair[0].observation_dim, key=key, device="cuda"), prng.split(key, 2)[1])
    return pair, policy


@pytest.mark.parametrize("name", ["fixed_actions", "lidar_noise", "batch_key_policy",
                                  "roundabout"])
def test_sharded_replay_equals_eager(cuda, name):
    """ShardedEnv's replayed rollout and step against its eager shard loop
    from one reset: every collected field and the state bit for bit."""
    (a, b), policy = _sharded_pair(name)
    act = torch.tensor([[0.0, 1.0]] * a.num_envs, device="cuda")
    kw = dict(policy_fn=policy) if policy else dict(actions=act)
    collect = ("obs", "reward", "terminated", "truncated", "state")
    for n in (7, 1, 12):
        assert _equal_trees(a.rollout(n, collect=collect, **kw),
                            b._rollout_eager(n, collect=collect, **kw))
    step_act = act.reshape(a.config["num_envs"], -1, 2)
    for _ in range(3):
        assert _equal_trees(a.step(step_act), b._step_eager(step_act))
    assert _equal_trees((a._state, a._last_obs), (b._state, b._last_obs))
    assert a._graphs.captures == 2 and a._graphs.shard_replays == [23, 23]


def test_camera_frame_replay_equals_eager(cuda):
    """The camera observation through the frame graph against the eager
    frame (`_step_eager` renders op by op), over 3 steps and a reset."""
    from metadrive_ped_torch import MetaDriveEnv
    cfg = dict(num_envs=64, map="SCS", num_scenarios=2, traffic_density=0.1,
               image_observation=True, stack_size=3, sensors=dict(main_camera=("rgb", 32, 32)))
    a, b = MetaDriveEnv(cfg, device="cuda"), MetaDriveEnv(cfg, device="cuda")
    act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
    for seed in (0, 1):
        assert _equal_trees(a.reset(seed=seed), b.reset(seed=seed))
        for _ in range(3):
            assert _equal_trees(a.step(act), b._step_eager(act))
    assert a._graphs.frame_replays == 8 and a._graphs._frame.state is a._graphs._step.state


IMAGE_CFG = dict(num_envs=64, map="SCS", num_scenarios=2, traffic_density=0.1, horizon=12,
                 image_observation=True, stack_size=3, sensors=dict(main_camera=("rgb", 32, 32)))
IMAGE_COLLECT = ("obs", "image", "reward", "terminated", "truncated")


def _stepped_fields(env, act, n):
    """``n`` `step` calls, stacked over steps as `rollout` collects them."""
    outs = [_clone(env.step(act)) for _ in range(n)]
    return dict(obs=torch.stack([o[0]["state"] for o in outs]),
                image=torch.stack([o[0]["image"] for o in outs]),
                reward=torch.stack([o[1] for o in outs]),
                terminated=torch.stack([o[2] for o in outs]),
                truncated=torch.stack([o[3] for o in outs]))


def test_image_rollout_replay_equals_replayed_steps(cuda):
    """The camera rendered and the stack rolled inside the rollout graph's
    replay: over 20 steps in three calls (auto-resets among them) the
    collected stacks, state observations, rewards and done flags equal the
    replayed `step`s' and the eager loop's bit for bit, and so does the
    stack a `step` after them continues."""
    from metadrive_ped_torch import MetaDriveEnv
    envs = [MetaDriveEnv(IMAGE_CFG, device="cuda") for _ in range(3)]
    act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
    for e in envs:
        e.reset(seed=0)
    parts = [envs[0].rollout(n, actions=act, collect=IMAGE_COLLECT)[0] for n in (7, 1, 12)]
    rolled = {k: torch.cat([p[k] for p in parts]) for k in IMAGE_COLLECT}
    eager = [envs[1]._rollout_eager(n, actions=act, collect=IMAGE_COLLECT)[0] for n in (7, 13)]
    eager = {k: torch.cat([p[k] for p in eager]) for k in IMAGE_COLLECT}
    stepped = _stepped_fields(envs[2], act, 20)
    for k in IMAGE_COLLECT:
        assert torch.equal(rolled[k], stepped[k]) and torch.equal(rolled[k], eager[k]), k
    assert bool((stepped["terminated"] | stepped["truncated"]).any())
    assert envs[0]._img_stack is envs[0]._graphs._rollout.buffers["image"]
    nxt = [_clone(e.step(act)[0]["image"]) for e in envs]
    assert torch.equal(nxt[0], nxt[1]) and torch.equal(nxt[0], nxt[2])
    # the reset's frame graph and the rollout graph; then the step's graph
    # and a frame graph over its buffers
    assert envs[0]._graphs.captures == 4 and envs[0]._graphs.replays == 21


def _device_ops(replay, n=3):
    """The names of the device operations of one ``replay()``, counted over
    ``n`` replays under the profiler (after one untimed replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            replay()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)


def test_a_rollout_graph_without_the_camera_holds_the_step_alone(cuda):
    """An env without image_observation captures the rollout region it
    captured before the camera entered `rollout`: the step, the collected
    fields and the write-back, the same device operations a replay as a
    graph captured here over that region."""
    from metadrive_ped_torch.core import graph
    env = _pg_detectors()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    collect = ("obs", "reward", "terminated", "truncated")
    env.reset(seed=0)
    env.rollout(2, actions=act, collect=collect)
    assert len(env._graphs._rollout.key) == 5 and "image" not in env._graphs._rollout.buffers

    def body(b):
        state, obs, reward, terminated, truncated, info = env._step_impl(b["state"], b["actions"])
        fields = dict(reward=reward, obs=obs, terminated=terminated, truncated=truncated)
        return dict(state=state), (obs, {k: fields[k] for k in collect})
    region = graph.StepGraph(None, graph.CudaGraphCapture(env.device), env._graphs._stamped(body),
                             dict(state=env._state, actions=act))
    ours, theirs = _device_ops(env._graphs._rollout.replay), _device_ops(region.replay)
    assert ours == theirs and sum(ours.values()) > 3 * 1000


# ---- CUDA-graph replay (metadrive_ped_torch/core/graph.py) -----------------

def _pg_detectors():
    from metadrive_ped_torch import MetaDriveEnv
    return MetaDriveEnv(dict(num_envs=64, map="SCS", num_scenarios=2, traffic_density=0.1,
                             vehicle_config=dict(side_detector=dict(num_lasers=16),
                                                 lane_line_detector=dict(num_lasers=6))),
                        device="cuda")


def _scenario_lines():
    from metadrive_ped_torch import MetaDriveEnv, ScenarioEnv
    from metadrive_ped_torch.scenario import export_scenarios
    src = MetaDriveEnv(dict(num_envs=4, map="SCS", num_scenarios=4, traffic_density=0.1),
                       device="cpu")
    src.reset(seed=0)
    sds = list(export_scenarios(src, 30, actions=[[0.0, 1.0]] * 4).values())
    return ScenarioEnv(dict(num_envs=64, scenario_data=sds, reactive_traffic=True, horizon=20,
                            vehicle_config=dict(side_detector=dict(num_lasers=160))),
                       device="cuda")


def _tollgate():
    from metadrive_ped_torch import MultiAgentTollgateEnv
    return MultiAgentTollgateEnv(dict(num_envs=4, num_agents=16), device="cuda")


def _equal_trees(x, y):
    from metadrive_ped_torch.core.graph import leaves
    xs, ys = leaves(x), leaves(y)
    return len(xs) == len(ys) and all(torch.equal(a, b) for a, b in zip(xs, ys))


GRAPH_ENVS = dict(pg_detectors=_pg_detectors, scenario_lines=_scenario_lines, tollgate=_tollgate)


@pytest.mark.parametrize("name", sorted(GRAPH_ENVS))
def test_replay_equals_eager(cuda, name):
    """The replayed rollout and step against the eager loop from one reset:
    the same kernels in the same order, so every collected field, the
    state and the kernel's launches are equal bit for bit."""
    from metadrive_ped_torch.core.structs import map_tensors
    from metadrive_ped_torch.ops import ray_segment as rs
    env = GRAPH_ENVS[name]()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    collect = ("obs", "reward", "terminated", "truncated")
    runs = []
    for roll, step in ((env._rollout_eager, env._step_eager), (env.rollout, env.step)):
        rs.launches = 0
        env.reset(seed=0)
        outs = [roll(n, actions=act, collect=collect) for n in (7, 1, 12)]
        outs += [map_tensors(torch.clone, step(act)) for _ in range(3)]
        runs.append((outs, map_tensors(torch.clone, (env._state, env._last_obs)), rs.launches))
    assert _equal_trees(runs[0][:2], runs[1][:2])
    assert runs[0][2] == runs[1][2] == (0 if env._line_table is None else 24)
    assert env._graphs.captures == 2 and env._graphs.replays == 23


def test_ppo_collection_replay_equals_eager(cuda):
    """examples/train_ppo.py's collection (the sampling policy inside the
    graph) replayed and eager: the same batch bit for bit."""
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.core import prng
    from metadrive_ped_torch.examples import train_ppo as ppo
    env = MetaDriveEnv(ppo.env_config(64, 4), device="cuda")
    key = prng.prng_key(0, "cuda")
    module = ppo.PolicyValue(env.observation_dim, key=key, device="cuda")
    batches = []
    for eager in (True, False):
        env.reset(seed=0)
        if eager:
            env.rollout = env._rollout_eager
        batches.append(ppo.collect(env, module, prng.split(key, 2)[1], 16, 0.99, 0.95))
        if eager:
            del env.rollout
    assert _equal_trees(batches[0][0], batches[1][0])
    assert batches[0][1] == batches[1][1]
    assert env._graphs.captures == 1 and env._graphs.replays == 16


def test_restore_between_replays(cuda):
    env = _pg_detectors()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    env.reset(seed=0)
    env.rollout(5, actions=act)
    snap = env.snapshot()
    first, _ = env.rollout(8, actions=act, collect=("obs", "reward", "state"))
    env.restore(snap)
    again, _ = env.rollout(8, actions=act, collect=("obs", "reward", "state"))
    assert _equal_trees(first, again)
    assert env._graphs.captures == 2


def test_a_policy_that_cannot_be_captured_raises(cuda):
    """A policy that reads a value on the host cannot be captured: rollout
    raises, runs no step eagerly and leaves the state as it was; a policy
    that can be captured then replays as before."""
    env = _pg_detectors()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    env.reset(seed=0)
    before = env.snapshot()

    def host_policy(obs, state):
        return act * (obs.sum().item() > -1.0)

    with pytest.raises(RuntimeError):
        env.rollout(3, policy_fn=host_policy)
    torch.cuda.synchronize()
    after = env.snapshot()
    assert all(np.array_equal(a, b) for a, b in zip(_np_leaves(before), _np_leaves(after)))
    assert env._graphs.replays == 0
    outs, _ = env.rollout(3, policy_fn=lambda obs, state: act)
    assert env._graphs.replays == 3 and bool(torch.isfinite(outs["reward"]).all())


def _np_leaves(tree):
    import dataclasses
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _np_leaves(getattr(tree, f.name))]
    return [tree]


# ---- the tracer's stamps on the card (metadrive_ped_torch/core/trace.py) ----

@pytest.fixture
def tracer(cuda):
    from metadrive_ped_torch.core import trace
    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


def _mixed():
    from metadrive_ped_torch import MixedTrafficEnv
    return MixedTrafficEnv(dict(num_envs=64, map="SCS", num_scenarios=2, traffic_density=0.2,
                                rl_agent_ratio=0.5, horizon=20), device="cuda")


@pytest.mark.parametrize("make", [_pg_detectors, _mixed], ids=["pg_detectors", "mixed"])
def test_stamped_replay_equals_unstamped(tracer, make):
    """A graph captured with tracing on (stamps and counters inside) steps
    the env bit for bit as the graph captured with it off."""
    runs = []
    for on in (False, True):
        env = make()
        act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
        env.reset(seed=0)
        if on:
            tracer.enable()
        outs = [env.rollout(n, actions=act, collect=("obs", "reward", "terminated", "truncated",
                                                     "state"))[0] for n in (5, 9)]
        outs.append([_clone(env.step(act)) for _ in range(3)])
        tracer.disable()
        runs.append((outs, _clone((env._state, env._last_obs))))
    assert _equal_trees(runs[0], runs[1])
    assert tracer.records()["counters"]["reset.computed"] == 64 * 17


def _clone(tree):
    from metadrive_ped_torch.core.structs import map_tensors
    return map_tensors(torch.clone, tree)


def test_tracing_on_recaptures_once_and_off_restores_the_unstamped_key(tracer):
    env = _pg_detectors()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    env.reset(seed=0)
    g = lambda: env._graphs  # noqa: E731
    env.rollout(2, actions=act)
    env.step(act)
    assert g().captures == 2 and g()._rollout.key[-1] is False and g()._step.key[-1] is False
    tracer.enable()
    env.rollout(2, actions=act)
    env.rollout(2, actions=act)
    env.step(act)
    env.step(act)
    assert g().captures == 4 and g()._rollout.key[-1] is True and g()._step.key[-1] is True
    tracer.disable()
    env.rollout(2, actions=act)
    env.step(act)
    assert g().captures == 6 and g()._rollout.key[-1] is False and g()._step.key[-1] is False
    assert all(counter is not tracer for counter, _ in g()._rollout.tally)


def test_launches_count_the_stamps_of_each_replay(tracer):
    """The stamp kernel counts its launches through core.launches: each
    replay adds the capture's tally, the same number the ring holds; the
    detector kernel's count stays one a replay."""
    from metadrive_ped_torch.ops import ray_segment as rs
    env = _pg_detectors()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    env.reset(seed=0)
    tracer.enable()
    env.rollout(2, actions=act)
    tracer.clear()
    stamps0, kernel0 = tracer.launches, rs.launches
    env.rollout(5, actions=act)
    stamps, kernels = tracer.launches - stamps0, rs.launches - kernel0
    recs = tracer.records()
    per_replay = env._graphs._rollout.tally[tracer, 0]
    device_spans = [s for s in recs["spans"] if s["clock"] == "device"]
    assert per_replay == 2 * len(device_spans[1:]) // 5
    assert stamps == 5 * per_replay + 2 == 2 * len(device_spans)
    assert kernels == 5 and recs["lost"] == 0


def test_spans_share_the_profilers_host_clock(tracer):
    """Over 20 replayed steps under torch.profiler, each a `step` call then
    a synchronisation inside a host event of its own: one offset maps the
    tracer's clock onto the profiler's host events (each host span of the
    tracer lies inside the profiler's event of the same name, opened before
    it and closed after it, within 10 us), and through it every `replay`
    span of the stamps lies between the profiler's start of its call's
    graph launch and the end of the synchronisation after it, within 10
    us. The stamp kernels appear by name among the profiler's device
    events; their times there are not compared: the profiler's records of
    graph kernels hold single kernels tens to hundreds of us off the rest,
    even in a fresh process's first session, and later sessions drift,
    place kernels before their own launch and drop records (PERF.md)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    env = _pg_detectors()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    env.reset(seed=0)
    tracer.enable()
    env.step(act)
    torch.cuda.synchronize()
    tracer.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            env.step(act)
            with record_function("test.sync"):
                torch.cuda.synchronize()
    spans = tracer.records()["spans"]
    host = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            host[e.name].append((e.time_range.start * 1e3, e.time_range.end * 1e3))
    lo, hi = [], []
    for name in ("env.step", "step.actions", "step.load", "step.replay", "step.clone",
                 "step.frame_obs", "step.outputs"):
        ours = sorted((s["start_ns"], s["end_ns"]) for s in spans if s["name"] == name)
        theirs = sorted(host[name])
        assert len(ours) == len(theirs) == 20, (name, len(ours), len(theirs))
        lo += [a - c for (a, _), (c, _) in zip(theirs, ours)]
        hi += [b - d for (_, b), (_, d) in zip(theirs, ours)]
    assert max(lo) <= min(hi) + 10_000, (max(lo), min(hi))
    offset = (max(lo) + min(hi)) / 2
    launches, syncs = sorted(host["step.replay"]), sorted(host["test.sync"])
    replays = sorted((s["start_ns"] + offset, s["end_ns"] + offset)
                     for s in spans if s["name"] == "replay")
    assert len(replays) == len(syncs) == 20
    for (launch, _), (_, synced), (start, end) in zip(launches, syncs, replays):
        assert launch - 10_000 <= start < end <= synced + 10_000, (start - launch, synced - end)
    assert any("trace_stamp" in e.name and e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def test_device_spans_sit_inside_their_host_calls(tracer):
    """The tracer's own shared clock: over 20 replayed steps, each a `step`
    call then a synchronisation, every `replay` span (globaltimer mapped
    onto perf_counter_ns) starts after its call's graph launch began and
    ends before the synchronisation returned, within 10 us."""
    import time
    env = _pg_detectors()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    env.reset(seed=0)
    tracer.enable()
    env.step(act)
    torch.cuda.synchronize()
    tracer.clear()
    ends = []
    for _ in range(20):
        env.step(act)
        torch.cuda.synchronize()
        ends.append(time.perf_counter_ns())
    spans = tracer.records()["spans"]
    launches = [s["start_ns"] for s in spans if s["name"] == "step.replay"]
    replays = [s for s in spans if s["name"] == "replay"]
    assert len(launches) == len(replays) == 20
    for launch, end, r in zip(launches, ends, replays):
        assert launch - 10_000 <= r["start_ns"] < r["end_ns"] <= end + 10_000, (
            r["start_ns"] - launch, end - r["end_ns"])


def test_stamped_image_rollout_equals_unstamped(tracer):
    """An image env's rollout and steps with the graphs captured with
    tracing on (the camera's stages and counters inside the rollout graph
    and the frame graph) equal those captured with it off, bit for bit;
    captured off, no graph holds a stamp. The stamps: one `camera` span in
    each replay, nothing inside it (on the card the frame is one kernel;
    the plain chain's stages are the CPU's), one `camera` span a `step`'s
    frame; the counters: every pixel of every frame, the live box pairs at
    most those computed."""
    from metadrive_ped_torch import MetaDriveEnv
    runs = []
    for on in (False, True):
        env = MetaDriveEnv(IMAGE_CFG, device="cuda")
        act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
        env.reset(seed=0)
        if on:
            tracer.enable()
        outs = [env.rollout(n, actions=act, collect=IMAGE_COLLECT)[0] for n in (5, 9)]
        outs.append([_clone(env.step(act)) for _ in range(3)])
        graphs = env._graphs
        tracer.disable()
        assert graphs._rollout.key[4] is on and graphs._frame.key[-1] is on
        stamped = [any(counter is tracer for counter, _ in g.tally)
                   for g in (graphs._rollout, graphs._frame, graphs._step)]
        assert stamped == [on] * 3
        runs.append((outs, _clone((env._state, env._last_obs, env._img_stack))))
    assert _equal_trees(runs[0], runs[1])
    recs = tracer.records()
    spans = recs["spans"]
    cams = [i for i, s in enumerate(spans) if s["name"] == "camera"]
    in_replay = [i for i in cams if spans[i]["parent"] is not None]
    assert len(in_replay) == 14 and len(cams) == 14 + 3
    assert all(spans[spans[i]["parent"]]["name"] == "replay" for i in in_replay)
    assert not [s for s in spans if s["parent"] in cams], "the frame is one kernel: no stages"
    c = recs["counters"]
    assert c["camera.pixels"] == 64 * 32 * 32 * 17 and recs["lost"] == 0
    assert 0 < c["camera.boxes_live"] <= c["camera.boxes_computed"]


# ---- the per-NPC lidar kernel (ops/npc_lidar.py, csrc/npc_lidar.cu) --------

NPC_LIDAR_CASES = chip_smoke.npc_lidar_cases()


def _same_cloud(out, ref):
    """The kernel's cloud is the plain chain's: the same shape, max abs
    difference 0.0 and the same number of hit rays (some)."""
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) == 0.0
    assert int((out < 1).sum()) == int((ref < 1).sum()) > 0


@pytest.mark.parametrize("case", sorted(NPC_LIDAR_CASES))
def test_npc_lidar_kernel_matches_plain(cuda, case):
    """Bit-equal on random bodies (E*N and R ragged, N = 1, most bodies
    inactive, more candidates than a shared-memory tile, more rays than a
    block) and on the edge geometry of chip_smoke.edge_npc_case: rays
    parallel to a box axis (the 1e-9 guard), an origin inside a box, grazing
    hits with tmax == tmin, an env with every body inactive, NaN and
    infinite inputs."""
    from metadrive_ped_torch.ops import npc_lidar as nl
    args = chip_smoke.npc_to_device(NPC_LIDAR_CASES[case](), cuda)
    before = nl.launches
    out = nl.npc_lidar(*args)
    ref = nl.npc_lidar_plain(*args)
    torch.cuda.synchronize()
    assert nl.launches == before + 1
    _same_cloud(out, ref)


def test_npc_lidar_kernel_matches_plain_on_the_mixed_traffic_state(cuda):
    """At the expert cell's width (8192 envs, traffic 0.1, half the slots on
    the expert), on the state after 64 replayed steps with auto-resets."""
    from metadrive_ped_torch import MixedTrafficEnv
    from metadrive_ped_torch.ops import npc_lidar as nl
    env = MixedTrafficEnv(chip_smoke.MIXED_TRAFFIC, device="cuda")
    act = torch.tensor([0.0, 1.0], device="cuda").expand(env.num_envs, 2).contiguous()
    env.reset(seed=0)
    outs, _ = env.rollout(64, actions=act, collect=("terminated", "truncated"))
    assert bool((outs["terminated"] | outs["truncated"]).any())
    args = chip_smoke.npc_lidar_args(env)
    out = nl.npc_lidar(*args)
    ref = nl.npc_lidar_plain(*args)
    torch.cuda.synchronize()
    _same_cloud(out, ref)


def test_npc_lidar_rejects_what_it_cannot_take(cuda):
    from metadrive_ped_torch.ops import npc_lidar as nl
    pos, heading, length, width, active, N, R, d = chip_smoke.npc_to_device(
        chip_smoke.random_npc_case(4, 3, 16, seed=1), cuda)
    C = N + 1
    for bad in ((pos.double(), heading, length, width, active),
                (pos, heading, length, width, active.float()),
                (pos, heading, length[:, :-1].contiguous(), width, active),
                (pos, heading.cpu(), length, width, active),
                (pos.transpose(0, 1).contiguous().transpose(0, 1), heading, length, width, active),
                (pos, heading.t().contiguous().t(), length, width, active)):
        with pytest.raises(ValueError):
            nl.npc_lidar(*bad, N, R, d)
    with pytest.raises(ValueError):
        nl.npc_lidar(pos, heading, length, width, active, C + 1, R, d)
    with pytest.raises(ValueError):
        nl.npc_lidar(pos, heading, length, width, active, N, R, 0.0)


def test_npc_lidar_replay_equals_eager(cuda):
    """A replayed MixedTrafficEnv rollout of 8 steps equals the eager one bit
    for bit, and each step launches the per-NPC lidar kernel once."""
    from metadrive_ped_torch.ops import npc_lidar as nl
    env = _mixed()
    act = torch.tensor([[0.0, 1.0]] * env.num_envs, device="cuda")
    collect = ("obs", "reward", "terminated", "truncated", "state")
    runs = []
    for roll in (env._rollout_eager, env.rollout):
        env.reset(seed=0)
        nl.launches = 0
        outs, _ = roll(8, actions=act, collect=collect)
        runs.append((_clone(outs), nl.launches))
    assert _equal_trees(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] == 8
    assert env._graphs.captures == 1 and env._graphs.replays == 8


def test_npc_lidar_reciprocal_is_ieee(cuda, tmp_path):
    """The kernel's reciprocal (csrc/npc_lidar.cu::rcp_rn, the fast path
    without its range check) equals the IEEE 1.0f / x in every bit, for
    every float x with 2^-126 <= |x| < 2^126: 4,227,858,432 values. The
    checker (tests/csrc/npc_lidar_rcp_check.cu) includes the kernel's
    source and builds here with the package's flags."""
    import ctypes
    import subprocess

    from metadrive_ped_torch.core import cuda_build
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "npc_lidar_rcp_check.cu")
    lib = str(tmp_path / "libnpc_lidar_rcp_check.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build._FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(lib).npc_lidar_rcp_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mismatches = torch.zeros(1, dtype=torch.int64, device="cuda")
    assert fn(mismatches.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    assert int(mismatches) == 0


# ---- the camera kernel (ops/camera.py, csrc/camera.cu) ---------------------

def _rgb84(**over):
    """The pg_rgb84 deployment's config (benchmarks/configs/pg_rgb84.json)."""
    import json
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "configs", "pg_rgb84.json")
    with open(path) as f:
        return dict(json.load(f)["config"], **over)


def _stepped(cfg, steps, seed=0):
    """An env of ``cfg`` on the card after ``steps`` replayed steps at full
    throttle (auto-resets among them)."""
    from metadrive_ped_torch import MetaDriveEnv
    env = MetaDriveEnv(cfg, device="cuda")
    act = torch.tensor([0.0, 1.0], device="cuda").expand(env.num_envs, 2).contiguous()
    env.reset(seed=seed)
    env.rollout(steps, actions=act, collect=("reward",))
    return env


def _same_frames(args, kw):
    """Every modality of the kernel's frame is the plain chain's (max abs
    difference 0.0), in one launch; the plain frame."""
    from metadrive_ped_torch.ops import camera
    gaps = chip_smoke.camera_gaps(args, kw)
    assert gaps == {k: (0.0, 0) for k in camera.MODALITIES}, gaps
    return camera.render_plain(*args, **kw)


def _classes(frame):
    from metadrive_ped_torch.ops import camera
    palette = camera._palette(frame["semantic"].device)
    sem = frame["semantic"].reshape(-1, 1, 3)
    return set(torch.nonzero((sem == palette).all(-1))[:, 1].tolist())


def _two_boxes_ahead(args):
    """``args`` with slots 0 and 1 of every row active and the same box,
    8 m ahead of the camera."""
    ego = args[2]
    fwd = torch.stack([torch.cos(ego.heading), torch.sin(ego.heading)], -1)
    pos, heading, active = args[3][0].clone(), args[3][1].clone(), args[3][4].clone()
    pos[:, 0] = pos[:, 1] = ego.pos + 8.0 * fwd
    heading[:, 0] = heading[:, 1] = ego.heading
    active[:, :2] = True
    length, width = args[3][2].clone(), args[3][3].clone()
    length[:, 1], width[:, 1] = length[:, 0], width[:, 0]
    return _with_targets(args, pos=pos, heading=heading, len=length, wid=width, active=active)


def _with_targets(args, **fields):
    """``args`` with target fields replaced (pos, heading, len, wid, active)."""
    names = ("pos", "heading", "len", "wid", "active")
    targets = tuple(fields.get(n, t) for n, t in zip(names, args[3]))
    return (*args[:3], targets, *args[4:])


def _random_case(env, seed, width, height, E=32, bodies=24):
    """`camera.render` arguments on ``env``'s scene and device: seeded
    random camera poses around its lanes (on and off the road), bodies
    (sizes, headings, a third inactive, some around the camera; 12 NPC
    slots, 4 objects of every kind, 8 pedestrians) and a pitch of 0, 4 or
    8 degrees."""
    import types
    g = torch.Generator().manual_seed(seed)
    scene = env.scene
    dev = scene.lane_kind.device
    sidx = torch.randint(0, scene.lane_kind.shape[0], (E,), generator=g, dtype=torch.int32)
    pos = scene.lane_p0.cpu()[sidx.long(), 0] + torch.randn(E, 2, generator=g) * 6.0
    ego = types.SimpleNamespace(pos=pos.to(dev), heading=(torch.rand(E, generator=g) * 6.3
                                                          - 3.15).to(dev),
                                params=types.SimpleNamespace(
                                    length=(4 + torch.rand(E, generator=g)).to(dev)))
    rand = lambda: torch.rand(E, bodies, generator=g)  # noqa: E731
    targets = (pos[:, None] + torch.randn(E, bodies, 2, generator=g) * 12.0,
               rand() * 6.3 - 3.15, 1 + 4 * rand(), 0.5 + 2 * rand(), rand() < 0.67)
    slices = dict(npc=slice(0, 12), obj=slice(12, 16), ped=slice(16, bodies))
    obj_kind = torch.randint(0, 4, (E, 4), generator=g, dtype=torch.int32)
    return ((scene, sidx.to(dev), ego, tuple(t.to(dev) for t in targets), slices,
             obj_kind.to(dev)), dict(width=width, height=height, pitch_deg=4.0 * (seed % 3)))


def _segment_distances(args, kw, row):
    """Distances [P, B] of env row ``row``'s ground points to every segment
    of its scenario, as the plain chain computes them
    (ops/camera.py::_segment_distances); inf where the pixel's ground point
    lies beyond FAR / 2 or its ray does not descend."""
    from metadrive_ped_torch.ops import camera
    scene, sidx, ego = args[:3]
    r = slice(row, row + 1)
    cam_h = kw.get("cam_height", 1.4)
    heading = ego.heading[r]
    dirs = camera.pixel_rays(heading, kw["width"], kw["height"], kw.get("fov_deg", 66.0),
                             kw.get("pitch_deg", 0.0), cam_h)
    fwd = torch.stack([torch.cos(heading), torch.sin(heading)], dim=-1)
    origin = ego.pos[r] + 0.25 * ego.params.length[r][:, None] * fwd
    t, px, py = camera._ground_points(origin, cam_h, dirs)
    d = camera._segment_distances(scene, sidx[r], px, py)[0]
    return torch.where((t[0] < camera.FAR / 2)[:, None], d, float("inf"))


@pytest.fixture(scope="module")
def rgb84_small():
    """The pg_rgb84 `small` state (64 envs) after 24 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return chip_smoke.camera_args(_stepped(_rgb84(num_envs=64), 24))


def test_camera_kernel_matches_plain_on_the_small_state(rgb84_small):
    """Bit-equal in all four modalities; one modality asked for is that
    modality's frame, and the others are not written."""
    from metadrive_ped_torch.ops import camera
    args, kw = rgb84_small
    ref = _same_frames(args, kw)
    assert {camera.SEM_SKY, camera.SEM_ROAD, camera.SEM_TERRAIN, camera.SEM_CAR} <= _classes(ref)
    for m in camera.MODALITIES:
        one = camera.render(*args, **kw, modalities=(m,))
        assert list(one) == [m] and torch.equal(one[m], ref[m]), m


def test_camera_kernel_matches_plain_at_1024_envs(cuda):
    """The benchmark's width (1024 envs, 16 maps), after 16 steps."""
    args, kw = chip_smoke.camera_args(_stepped(_rgb84(), 16))
    _same_frames(args, kw)


def test_camera_kernel_matches_plain_on_circular_lanes(cuda):
    """Maps of curves, an intersection and a roundabout: circular lanes
    decide much of the road (atan2f and the phase wraps)."""
    cfg = _rgb84(num_envs=64, map="CXOC", num_scenarios=4, traffic_density=0.1)
    env = _stepped(cfg, 20)
    assert int((env.scene.lane_kind == 1).sum()) > 100
    _same_frames(*chip_smoke.camera_args(env))


def test_camera_kernel_matches_plain_with_a_row_without_bodies(rgb84_small):
    """Row 0 with no active body, row 1 with every slot active."""
    args, kw = rgb84_small
    active = args[3][4].clone()
    active[0] = False
    active[1] = True
    _same_frames(_with_targets(args, active=active), kw)


def test_camera_kernel_keeps_the_first_of_two_equal_boxes(rgb84_small):
    """Slots 0 and 1 of every row the same box 8 m ahead of the camera:
    both at one distance, the first slot's instance colour shows, in the
    plain chain and the kernel."""
    from metadrive_ped_torch.ops import camera
    args, kw = rgb84_small
    ref = _same_frames(_two_boxes_ahead(args), kw)
    centre = ref["instance"][:, kw["height"] // 2 + 2, kw["width"] // 2]
    shows = lambda k: (centre - _colour(k, "cuda")).abs().amax(-1) < 1e-6  # noqa: E731
    assert int(shows(0).sum()) >= 0.9 * len(centre) and not bool(shows(1).any())
    assert camera.SEM_CAR in _classes(ref)


def test_camera_kernel_matches_plain_on_line_thresholds(rgb84_small):
    """Each valid segment's half width set to the distance of row 0's
    nearest ground pixel (as the plain chain computes it), so that pixel
    lies exactly on the segment's threshold."""
    import dataclasses
    args, kw = rgb84_small
    scene, sidx = args[0], args[1]
    d = _segment_distances(args, kw, row=0)        # [P, B]
    s = int(sidx[0])
    hw = scene.seg_halfwidth.clone()
    valid = scene.seg_valid[s]
    pix = (d - hw[s]).abs().argmin(0)                                 # [B]
    on = d.gather(0, pix[None])[0]
    hw[s] = torch.where(valid & torch.isfinite(on), on, hw[s])
    case = (dataclasses.replace(scene, seg_halfwidth=hw), *args[1:])
    ref = _same_frames(case, kw)
    assert int(valid.sum()) > 20 and 2 in _classes(ref)


def test_camera_kernel_walks_tables_larger_than_its_tiles(rgb84_small):
    """Segments, lanes and bodies repeated past the kernel's shared-memory
    tiles (512 segments, 256 lanes, 128 bodies): the same frame, the first
    copy of a body winning its tie."""
    import dataclasses
    args, kw = rgb84_small
    scene = args[0]
    rep = {f.name: torch.cat([getattr(scene, f.name)] * 3, dim=1)
           for f in dataclasses.fields(scene)
           if f.name.startswith(("seg_", "lane_")) and getattr(scene, f.name).dim() >= 2
           and getattr(scene, f.name).shape[1] in (scene.seg_type.shape[1],
                                                    scene.lane_kind.shape[1])}
    big = dataclasses.replace(scene, **rep)
    assert big.seg_type.shape[1] > 512 and big.lane_kind.shape[1] > 256
    _same_frames((big, *args[1:]), kw)
    T = args[3][0].shape[1]
    copies = -(-130 // T) + 1
    targets = tuple(torch.cat([t] * copies, dim=1) for t in args[3])
    _same_frames((*args[:3], targets, *args[4:]), kw)


def _colour(k, device):
    """The instance colour of target slot ``k`` (ops/camera.py)."""
    return torch.tensor([(k * 37 + 13) % 255, (k * 91 + 71) % 255, (k * 53 + 29) % 255],
                        device=device) / 255.0


@pytest.mark.parametrize("boxes_ahead", [False, True])
def test_the_camera_counts_the_box_pairs_its_kernel_tests(tracer, rgb84_small, boxes_ahead):
    """`camera.boxes_computed` is the kernel's own count of its box tests:
    every live pixel against every active slot of its row, and for each
    pixel that shows a body the slots up to the one it shows (the second
    pass, over the active slots in slot order); `camera.boxes_live` is the
    pixels times the active slots. On the small state, and with a box
    ahead of every camera (`_two_boxes_ahead`)."""
    from metadrive_ped_torch.ops import camera
    args, kw = rgb84_small
    if boxes_ahead:
        args = _two_boxes_ahead(args)
    active = args[3][4]
    E, T = active.shape
    P = kw["width"] * kw["height"]
    ref = camera.render_plain(*args, **kw)
    tracer.enable()
    tracer.clear()
    camera.render(*args, **kw)
    counters = tracer.records()["counters"]
    tracer.disable()
    colours = torch.stack([_colour(k, active.device) for k in range(T)])     # [T, 3]
    shown = ((ref["instance"].reshape(E, P, 1, 3) - colours).abs().amax(-1) < 1e-6)
    shows = shown.any(-1)                                                    # [E, P]
    slot = shown.int().argmax(-1)                                            # the first
    rank = active.long().cumsum(-1).gather(1, slot)                         # [E, P]
    assert int(shows.sum()) > (3000 if boxes_ahead else 100)
    assert bool(active.gather(1, slot)[shows].all())
    assert counters["camera.boxes_live"] == P * int(active.sum())
    assert counters["camera.boxes_computed"] == P * int(active.sum()) + int(rank[shows].sum())


def test_camera_kernel_matches_plain_on_random_poses(cuda):
    """Seeded random camera poses (on and off the road), bodies (sizes,
    headings, a third inactive, some overlapping the camera) and pitches,
    at 84x84 and at a ragged 100x37."""
    env = _stepped(_rgb84(num_envs=48), 2)
    for seed, (w, h) in enumerate(((84, 84), (100, 37))):
        args, kw = _random_case(env, seed, w, h)
        _same_frames(args, kw)


def test_camera_kernel_rejects_what_it_cannot_take(rgb84_small):
    from metadrive_ped_torch.ops import camera
    args, kw = rgb84_small
    import dataclasses
    scene, sidx, ego, targets, slices, obj_kind = args
    for case in ((scene, sidx.long(), ego, targets, slices, obj_kind),
                 (scene, sidx, ego, targets, slices, obj_kind.long()),
                 (scene, sidx, ego, targets, slices, obj_kind[:, :0]),
                 (scene, sidx, ego, (targets[0].double(), *targets[1:]), slices, obj_kind),
                 (scene, sidx, ego, (*targets[:4], targets[4].float()), slices, obj_kind),
                 (scene, sidx, ego, (*targets[:2], targets[2].cpu(), *targets[3:]), slices,
                  obj_kind),
                 (dataclasses.replace(scene, seg_valid=scene.seg_valid.float()), sidx, ego,
                  targets, slices, obj_kind),
                 (scene, sidx, ego, targets, dict(slices, ped=slice(0, None, 2)), obj_kind)):
        with pytest.raises(ValueError):
            camera.render(*case, **kw)
    with pytest.raises(ValueError):
        camera.render(*args, **dict(kw, width=0))
    with pytest.raises(ValueError):
        camera.render(*args, **kw, modalities=("lidar",))


def test_camera_launches_once_a_replayed_step_and_replay_equals_eager(cuda):
    """A replayed image rollout of 8 steps equals the eager one bit for
    bit, and each step launches the camera kernel once, replays included."""
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import camera
    env = MetaDriveEnv(IMAGE_CFG, device="cuda")
    act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
    runs = []
    for roll in (env._rollout_eager, env.rollout):
        env.reset(seed=0)
        camera.launches = 0
        outs, _ = roll(8, actions=act, collect=IMAGE_COLLECT)
        runs.append((_clone(outs), camera.launches))
    assert _equal_trees(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] == 8
    assert env._graphs.replays == 8


def test_a_traced_image_rollout_holds_one_camera_kernel_a_replay(tracer):
    """The card's counterpart of test_torch_trace.py's camera-stage test:
    each replay of a traced image rollout holds one `camera` span with no
    stages inside (the frame is one kernel), one camera launch, and the
    counters count every pixel and the live box pairs, at most the pairs
    the kernel's box tests computed."""
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import camera
    env = MetaDriveEnv(IMAGE_CFG, device="cuda")
    act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
    env.reset(seed=0)
    tracer.enable()
    env.rollout(2, actions=act, collect=("obs", "image"))       # the capture
    tracer.clear()
    camera.launches = 0
    env.rollout(5, actions=act, collect=("obs", "image"))
    recs = tracer.records()
    tracer.disable()
    spans = recs["spans"]
    replays_ = [i for i, s in enumerate(spans) if s["name"] == "replay"]
    cams = [i for i, s in enumerate(spans) if s["name"] == "camera"]
    assert len(replays_) == len(cams) == 5 and camera.launches == 5
    assert all(spans[i]["parent"] in replays_ for i in cams)
    assert not [s for s in spans if s["parent"] in cams]
    c = recs["counters"]
    assert c["camera.pixels"] == 64 * 32 * 32 * 5
    assert 0 < c["camera.boxes_live"] <= c["camera.boxes_computed"]
