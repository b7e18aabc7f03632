"""The port's data-parallel layer (metadrive_ped_torch/parallel): ShardedEnv
against the port's unsharded env, make_mesh, init_distributed, and the
counter offset of the threefry twin that lets a shard draw its rows of the
batch's noise.

A sharded env must give the unsharded env's numbers: obs within 1e-5,
reward within 1e-6 and every flag equal (tests/test_parallel.py's
tolerance for JAX's ShardedEnv); the largest gap seen is 0. Shards here
are CPU devices of one process, ``["cpu"] * n``, the same code path as
``["cuda:0"] * n``. tests/test_torch_parallel_jax.py holds the sharded
env against JAX's ShardedEnv."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_parity import surface_rows, to_np

import metadrive_ped_torch as port
from metadrive_ped_torch.core import prng
from metadrive_ped_torch.core.structs import tree_map
from metadrive_ped_torch.parallel import ShardedEnv, init_distributed, make_mesh
from metadrive_ped_torch.scenario import export_scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_TOL, REWARD_TOL = 1e-5, 1e-6
STEPS = 10

PG = dict(num_envs=16, map="S", num_scenarios=1, traffic_density=0.1)
NOISE = dict(PG, vehicle_config=dict(lidar=dict(gaussian_noise=0.05, dropout_prob=0.1)))
DETECTORS = dict(side_detector=dict(num_lasers=8, distance=50.0),
                 lane_line_detector=dict(num_lasers=6, distance=20.0))
SMALL = dict(num_envs=4, map="S", num_scenarios=2, traffic_density=0.2)
MARL = dict(num_envs=4, num_agents=4)


# the manual controller's script for row 0 (each env reads its own copy)
SCRIPT = [[0.3, -0.5], [-0.2, 1.0]] * 4

# name -> (class, config); every class of parallel.SHARDABLE
CASES = {
    "pg_detectors_noise": ("MetaDriveEnv", dict(
        NOISE, num_envs=8, map="SCS", num_scenarios=2,
        vehicle_config=dict(NOISE["vehicle_config"], **DETECTORS))),
    "protector_manual": ("MetaDriveEnv", dict(
        SMALL, use_AI_protector=True, save_level=0.5, manual_control=True, controller=SCRIPT,
        vehicle_config=dict(lidar=dict(num_others=4)))),
    "safe": ("SafeMetaDriveEnv", dict(SMALL)),
    "mixed_traffic": ("MixedTrafficEnv", dict(SMALL, traffic_density=0.3, rl_agent_ratio=0.5)),
    "varying_dynamics": ("VaryingDynamicsEnv", dict(SMALL)),
    "top_down_single": ("TopDownSingleFrameMetaDriveEnv", dict(SMALL)),
    "top_down": ("TopDownMetaDrive", dict(SMALL)),
    "top_down_v2": ("TopDownMetaDriveEnvV2", dict(SMALL)),
    "image_obs": ("MetaDriveEnv", dict(SMALL, image_observation=True, stack_size=3,
                                       sensors=dict(main_camera=("rgb", 16, 12)))),
    "marl": ("MultiAgentMetaDrive", MARL),
    "roundabout": ("MultiAgentRoundaboutEnv", dict(MARL, delay_done=2)),
    "intersection": ("MultiAgentIntersectionEnv", MARL),
    "bottleneck": ("MultiAgentBottleneckEnv", MARL),
    "bidirection": ("MultiAgentBidirectionEnv", MARL),
    "tollgate": ("MultiAgentTollgateEnv", MARL),
    "parking_lot": ("MultiAgentParkingLotEnv", MARL),
    "racing": ("MultiAgentRacingEnv", MARL),
    "tinyinter": ("MultiAgentTinyInter", dict(MARL, num_RL_agents=3)),
}


@pytest.fixture(scope="module")
def exported():
    """ScenarioDescriptions exported from the port's PG env, as
    tests/test_parallel.py exports them from the JAX package's."""
    src = port.MetaDriveEnv(dict(num_envs=2, map="CS", num_scenarios=2, traffic_density=0.5,
                                 traffic_mode="respawn"), device="cpu")
    src.reset(seed=0)
    return list(export_scenarios(src, 40, actions=np.tile([0.0, 0.7], (2, 1))).values())


def _make(name, cfg, exported=None):
    if name == "ScenarioEnv":
        cfg = dict(cfg, scenario_data=exported)
    return getattr(port, name)(cfg, device="cpu")


def _actions(env, steps, seed=0):
    shape = surface_rows(env).shape + (2,)
    rng = np.random.RandomState(seed)
    return np.clip(rng.normal([0.0, 0.6], [0.3, 0.4], (steps,) + shape), -1, 1).astype(np.float32)


def _gap(a, b):
    """Largest |a - b| over two outputs (tensors or dicts of them)."""
    if isinstance(a, dict):
        return max(_gap(a[k], b[k]) for k in a)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _assert_info_equal(ip, isd):
    assert set(ip) == set(isd)
    for k, v in ip.items():
        w = isd[k]
        if not torch.is_tensor(v):
            assert v == w, k
        elif v.dtype.is_floating_point:
            assert _gap(v, w) <= OBS_TOL, k
        else:
            assert torch.equal(v, w), k


def _pair(name, cfg, shards, exported=None, steps=STEPS):
    """The unsharded env and ShardedEnv over ``shards`` CPU devices, reset
    with one seed and stepped with the same actions: the largest obs and
    reward gaps, every flag and info key checked on the way; returns
    (obs gap, reward gap, plain env, sharded env)."""
    plain = _make(name, cfg, exported)
    sharded = ShardedEnv(_make(name, cfg, exported), ["cpu"] * shards)
    (op, ip), (osd, isd) = plain.reset(seed=3), sharded.reset(seed=3)
    obs_gap, rew_gap = _gap(op, osd), 0.0
    _assert_info_equal(ip, isd)
    for a in _actions(plain, steps):
        op, rp, tp, trp, ip = plain.step(a)
        osd, rsd, tsd, trsd, isd = sharded.step(a)
        obs_gap, rew_gap = max(obs_gap, _gap(op, osd)), max(rew_gap, _gap(rp, rsd))
        assert torch.equal(tp, tsd) and torch.equal(trp, trsd)
        _assert_info_equal(ip, isd)
    return obs_gap, rew_gap, plain, sharded


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_unsharded(name):
    cls, cfg = CASES[name]
    obs_gap, rew_gap, plain, sharded = _pair(cls, cfg, 2)
    assert obs_gap <= OBS_TOL and rew_gap <= REWARD_TOL, (obs_gap, rew_gap)
    # the shards hold the live state: the joined state is the unsharded one
    for a, b in zip(_leaves(plain._state), _leaves(sharded._state)):
        torch.testing.assert_close(a, b, rtol=0, atol=OBS_TOL)


@pytest.mark.parametrize("name", ["pg", "pg_detectors_noise", "scenario_reactive", "roundabout"])
def test_four_shards_match_unsharded(name, exported):
    scenario = ("ScenarioEnv", dict(num_envs=16, reactive_traffic=True))
    cls, cfg = dict(CASES, pg=("MetaDriveEnv", PG), scenario_reactive=scenario)[name]
    obs_gap, rew_gap, _, _ = _pair(cls, cfg, 4, exported)
    assert obs_gap <= OBS_TOL and rew_gap <= REWARD_TOL, (obs_gap, rew_gap)


def test_sharded_scenario_curriculum(exported):
    """ScenarioEnv's own curriculum levels up on the host, once, from the
    whole batch's outcomes, and the shards' scenario band follows."""
    cfg = dict(num_envs=8, reactive_traffic=True, curriculum_level=2, target_success_rate=0.0,
               episodes_to_evaluate_curriculum=1, horizon=5)
    _, _, plain, sharded = _pair("ScenarioEnv", cfg, 2, exported, steps=12)
    assert plain.current_level == sharded.current_level == 1
    assert torch.equal(plain._state.scenario_cap, sharded._state.scenario_cap)


def test_curriculum_wrapper_over_shards():
    """CurriculumWrapper outside ShardedEnv: its level-up narrows and
    widens every shard's band as the unsharded env's."""
    cfg = dict(PG, num_envs=8, num_scenarios=4, horizon=6)
    plain = port.CurriculumWrapper(port.MetaDriveEnv(cfg, device="cpu"), curriculum_level=2)
    sharded = port.CurriculumWrapper(ShardedEnv(port.MetaDriveEnv(cfg, device="cpu"),
                                                ["cpu"] * 2), curriculum_level=2)
    plain.reset(seed=1), sharded.reset(seed=1)
    assert sharded.env.num_scenarios == 2
    for i, a in enumerate(_actions(plain.env, 14)):
        if i == 4:
            plain.level_up(), sharded.level_up()
        op, rp, *_ = plain.step(a)
        osd, rsd, *_ = sharded.step(a)
        assert _gap(op, osd) <= OBS_TOL and _gap(rp, rsd) <= REWARD_TOL
    assert torch.equal(plain.env._state.scenario_cap, sharded.env._state.scenario_cap)
    assert int(sharded.env._state.scenario_cap[0]) == 4


def test_sharded_rollout_matches_unsharded():
    """`rollout` with fixed actions and with a policy that draws over the
    whole batch from one key (train_ppo's pattern): collected fields, the
    mean reward and the final state are the unsharded env's."""
    def policy(obs, state):
        key = prng.fold_in(prng.prng_key(7), state.step_count.sum())
        return torch.tanh(obs[:, :2] + 0.3 * prng.normal(key, (obs.shape[0], 2)))

    collect = ("reward", "obs", "terminated", "step_count", "state")
    for kw in (dict(actions=np.tile([0.1, 0.9], (16, 1))), dict(policy_fn=policy)):
        plain = port.MetaDriveEnv(NOISE, device="cpu")
        sharded = ShardedEnv(port.MetaDriveEnv(NOISE, device="cpu"), ["cpu"] * 2)
        plain.reset(seed=2), sharded.reset(seed=2)
        out_p, mean_p = plain.rollout(8, collect=collect, **kw)
        out_s, mean_s = sharded.rollout(8, collect=collect, **kw)
        assert mean_p == mean_s
        for k in collect[:-1]:
            assert _gap(out_p[k], out_s[k]) == 0.0, k
        for a, b in zip(_leaves(out_p["state"]), _leaves(out_s["state"])):
            assert torch.equal(a, b)
        assert _gap(plain._last_obs, sharded._last_obs) == 0.0


def test_sharded_state_methods():
    """The methods that read or write the state work on the whole batch:
    snapshot and restore, record and replay, break-down by global rows,
    render of the joined state; mean_metrics over every row."""
    plain = port.MetaDriveEnv(PG, device="cpu")
    sharded = ShardedEnv(port.MetaDriveEnv(PG, device="cpu"), ["cpu"] * 2)
    with pytest.raises(RuntimeError, match="reset"):
        sharded.snapshot()
    for env in (plain, sharded):
        env.reset(seed=0)
        env.rollout(3, actions=np.tile([0.0, 1.0], (16, 1)))
    snap_p, snap_s = plain.snapshot(), sharded.snapshot()
    for a, b in zip(_leaves(snap_p), _leaves(snap_s)):
        np.testing.assert_array_equal(a, b)
    rows = [1, 9, 14]
    for env in (plain, sharded):
        env.set_break_down(rows)
        env.rollout(2)
    assert torch.equal(plain._state.ego.break_down, sharded._state.ego.break_down)
    assert int(sharded._state.ego.break_down.sum()) == 3
    rec_p, rec_s = plain.record_episode(4), sharded.record_episode(4)
    np.testing.assert_array_equal(rec_p["obs"], rec_s["obs"])
    assert _gap(plain.replay_frame(rec_p, 2), sharded.replay_frame(rec_s, 2)) == 0.0
    plain.restore(snap_p), sharded.restore(snap_s)
    assert _gap(plain._last_obs, sharded._last_obs) == 0.0
    op, rp, *_, ip = plain.step(np.zeros((16, 2)))
    osd, rsd, *_, isd = sharded.step(np.zeros((16, 2)))
    assert _gap(op, osd) == 0.0
    np.testing.assert_array_equal(plain.render("topdown", size=64),
                                  sharded.render("topdown", size=64))
    assert sharded._state is not None and sharded.env._state is None
    assert float(sharded.mean_metrics(isd)["step_reward"]) == float(ip["step_reward"].mean())
    assert sharded.get_map_features(0).keys() == plain.get_map_features(0).keys()


def test_shard_moves_every_tensor(exported):
    """A shard moved to the meta device holds no tensor elsewhere: every
    constant of every shardable class (scene, line table, class table,
    seeds, expert parameters, textures, per-row tables, scenario
    difficulty) and every per-row buffer of a reset env moves."""
    from metadrive_ped_torch.parallel.mesh import SHARDABLE
    seen_classes = set()
    meta = torch.device("meta")

    def walk(x, path, seen):
        if torch.is_tensor(x):
            assert x.device == meta, path
            return
        if id(x) in seen or isinstance(x, (str, bytes, int, float, type, np.ndarray)):
            return
        seen.add(id(x))
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]", seen)
        elif isinstance(x, (list, tuple, set)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]", seen)
        elif hasattr(x, "__dict__") and not callable(x):
            for k, v in vars(x).items():
                walk(v, f"{path}.{k}", seen)

    scenario = ("ScenarioEnv", dict(num_envs=4, reactive_traffic=True))
    for name, cfg in list(CASES.values()) + [scenario]:
        env = _make(name, cfg, exported)
        env.reset(seed=0)
        if hasattr(env, "_map_textures"):
            env._map_textures()
        rows = env.num_envs
        view = env._shard(rows // 2, rows, meta)
        assert view.num_envs == rows - rows // 2 and view._row_offset == rows // 2
        walk(vars(view), type(env).__name__, set())
        assert view._state.ego.pos.shape[0] == rows - rows // 2
        seen_classes.add(type(env))
    assert seen_classes == set(SHARDABLE)


def test_refusals(monkeypatch):
    with pytest.raises(AssertionError, match="must divide over 4 devices"):
        ShardedEnv(port.MetaDriveEnv(dict(PG, num_envs=6), device="cpu"), ["cpu"] * 4)
    with pytest.raises(AssertionError, match="num_envs=3 must divide over 2 devices"):
        ShardedEnv(port.MultiAgentRoundaboutEnv(dict(num_envs=3, num_agents=2), device="cpu"),
                   ["cpu"] * 2)
    wrapped = port.CurriculumWrapper(port.MetaDriveEnv(PG, device="cpu"), curriculum_level=1)
    with pytest.raises(TypeError, match="CurriculumWrapper"):
        ShardedEnv(wrapped, ["cpu"] * 2)
    gym_cls = port.createGymWrapper(port.MetaDriveEnv)
    with pytest.raises(TypeError, match=gym_cls.__name__):
        ShardedEnv(gym_cls(PG, device="cpu"), ["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEnv(port.MetaDriveEnv(PG, device="cpu"))
    assert make_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert init_distributed() == (0, 1)


@pytest.mark.parametrize("fn", ["uniform", "normal", "random_bits"])
def test_draw_offset_slices_the_full_draw(fn):
    """A draw at counter ``offset`` is the slice of the whole draw from
    that flat position on, which JAX's whole draw also gives."""
    key = prng.fold_in(prng.prng_key(0), 123)
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), 123)
    if fn == "random_bits":
        full = prng.random_bits(key, 60)
        part = prng.random_bits(key, 15, offset=20)
        np.testing.assert_array_equal(to_np(part), to_np(full)[20:35])
        return
    full = getattr(prng, fn)(key, (12, 5))
    part = getattr(prng, fn)(key, (3, 5), offset=20)
    np.testing.assert_array_equal(to_np(part), to_np(full)[4:7])
    jfull = np.asarray(getattr(jax.random, fn)(jkey, (12, 5)))
    np.testing.assert_allclose(to_np(part), jfull[4:7], rtol=0, atol=1e-6)


# ---- two processes -----------------------------------------------------------
def test_two_process_distributed(tmp_path):
    """Two ranks of a gloo group on the CPU, met through a ``file://`` store
    (no port bound and released): each steps its own env batch over its
    stride of the scenario set, and both all-gather the same mean rewards.
    Every wait has a timeout."""
    worker = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
    store = tmp_path / "store"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", f"file://{store}"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT, env=env) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    results = {}
    for out in outs:
        lines = [line for line in out.splitlines() if line.startswith("RESULT")]
        assert lines, f"worker produced no RESULT:\n{out[-2000:]}"
        _, rank, world, seeds, mine, gathered = lines[0].split()
        results[int(rank)] = (int(world), set(seeds.split(",")), mine, gathered)
        assert "backend gloo" in out
    assert set(results) == {0, 1}
    assert all(r[0] == 2 for r in results.values())
    assert results[0][1] and results[1][1] and results[0][1].isdisjoint(results[1][1])
    assert results[0][3] == results[1][3], "all-gathered rewards must agree"
    assert results[0][3].split(",") == [results[0][2], results[1][2]]
