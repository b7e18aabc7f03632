"""The trainer's surface of the port against the JAX package: gymnasium
spaces, the legacy gym wrapper, fault injection, snapshot/restore,
record/replay, map dumps, PG map features and `draw_map`.

Small sizes: 4 envs on map "S" (or 2 on "SC" / "CS"). Fault injection is
held to JAX at 1e-5 over 20 + 40 + 30 steps; snapshots, replays and dumped
packs are bit-equal."""
import os
import pickle

import gymnasium as gym
import numpy as np
import pytest
import torch
from _torch_parity import assert_trees_close, np_tree, to_np

from metadrive_ped_torch import MetaDriveEnv as TorchEnv
from metadrive_ped_torch import MultiAgentRoundaboutEnv as TorchRoundabout
from metadrive_ped_torch import createGymWrapper as torch_gym
from metadrive_ped_torch.core.convert import state_to_numpy
from metadrive_ped_torch.core.structs import tree_map
from metadrive_ped_torch.scenario.utils import draw_map
from metadrive_ped_tpu import MetaDriveEnv as JaxEnv
from metadrive_ped_tpu import MultiAgentRoundaboutEnv as JaxRoundabout
from metadrive_ped_tpu import createGymWrapper as jax_gym

BREAK_CFG = dict(num_envs=4, map="S", num_scenarios=1, traffic_density=0.0, auto_reset=False)
SNAP_CFG = dict(num_envs=4, map="S", num_scenarios=1, traffic_density=0.2,
                vehicle_config=dict(side_detector=dict(num_lasers=8),
                                    lane_line_detector=dict(num_lasers=4)))
FULL = np.tile([0.0, 1.0], (4, 1)).astype(np.float32)


@pytest.mark.parametrize("cls_pair, cfg", [
    ((JaxEnv, TorchEnv), dict()),
    ((JaxEnv, TorchEnv), dict(discrete_action=True)),
    ((JaxEnv, TorchEnv), dict(discrete_action=True, use_multi_discrete=True,
                              discrete_steering_dim=3, discrete_throttle_dim=7)),
    ((JaxRoundabout, TorchRoundabout), dict(num_agents=4)),
], ids=["continuous", "discrete", "multi_discrete", "roundabout"])
def test_spaces_equal_jax(cls_pair, cfg):
    jcls, tcls = cls_pair
    cfg = dict(dict(num_envs=2, map="S", num_scenarios=1, traffic_density=0.0), **cfg)
    if jcls is JaxRoundabout:
        cfg.pop("map")
    jenv, tenv = jcls(cfg), tcls(cfg, device="cpu")
    for name in ("observation_space", "action_space"):
        a, b = getattr(jenv, name), getattr(tenv, name)
        assert type(a) is type(b) and a == b, (name, a, b)
        if isinstance(a, gym.spaces.Box):
            np.testing.assert_array_equal(a.low, b.low)
            np.testing.assert_array_equal(a.high, b.high)
            assert a.dtype == b.dtype
    assert tenv.observation_space.shape == (tenv.observation_dim,)


def test_gym_wrapper_four_tuple():
    """reset gives the obs alone and step the 4-tuple (obs, reward, done,
    info) with done = terminated | truncated, equal to JAX's wrapper."""
    cfg = dict(num_envs=2, map="S", num_scenarios=1, traffic_density=0.0, horizon=3)
    jenv, tenv = jax_gym(JaxEnv)(cfg), torch_gym(TorchEnv)(cfg, device="cpu")
    assert type(tenv).__name__ == "GymMetaDriveEnv"
    assert tenv.default_config()["num_envs"] == TorchEnv.default_config()["num_envs"]
    np.testing.assert_allclose(to_np(tenv.reset(seed=0)), np.asarray(jenv.reset(seed=0)),
                               rtol=0, atol=1e-6)
    act = np.tile([0.0, 0.5], (2, 1))
    for _ in range(3):
        jout, tout = jenv.step(act), tenv.step(act)
        assert len(tout) == 4 and tout[2].dtype == torch.bool
        np.testing.assert_allclose(to_np(tout[0]), np.asarray(jout[0]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(to_np(tout[1]), np.asarray(jout[1]), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(to_np(tout[2]), np.asarray(jout[2]))
    assert bool(tout[2].all()), "horizon 3 truncates every env at the third step"
    assert tenv.num_envs == 2  # attribute passthrough
    tenv.close()


@pytest.fixture(scope="module")
def break_down_runs():
    """Both packages: 20 steps, rows [0, 1] broken for 40, row 0 repaired for
    30 more; the state after each stage."""
    out = []
    for env in (JaxEnv(BREAK_CFG), TorchEnv(BREAK_CFG, device="cpu")):
        env.reset(seed=0)
        states = []
        for rows, flag, steps in ((None, None, 20), ([0, 1], True, 40), ([0], False, 30)):
            if rows is not None:
                env.set_break_down(rows, break_down=flag)
            for _ in range(steps):
                env.step(FULL)
            states.append(np_tree(env._state) if env.__class__ is JaxEnv
                          else state_to_numpy(env._state))
        out.append(states)
    return out


def test_set_break_down_matches_jax(break_down_runs):
    jax_states, torch_states = break_down_runs
    for a, b in zip(jax_states, torch_states):
        assert_trees_close(a, b, atol=1e-5)
    speed = [s["ego"]["speed"] for s in torch_states]
    assert (speed[1][:2] < speed[0][:2] - 1.5).all(), "broken rows coast down"
    assert (speed[1][2:] > speed[0][2:] + 1.5).all(), "healthy rows keep driving"
    assert speed[2][0] > speed[1][0] + 1.5 and speed[2][1] < speed[1][1] - 0.5


def test_set_break_down_takes_a_mask_and_needs_a_reset():
    env = TorchEnv(BREAK_CFG, device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        env.set_break_down()
    env.reset(seed=0)
    env.set_break_down(np.array([False, True, False, True]))
    assert to_np(env._state.ego.break_down).tolist() == [False, True, False, True]
    # a mask or an index tensor already on the env's device is used there
    env.set_break_down(torch.tensor([True, False, False, False], device=env.device))
    assert to_np(env._state.ego.break_down).tolist() == [True, True, False, True]
    env.set_break_down(torch.tensor([1, 3], device=env.device), break_down=False)
    assert to_np(env._state.ego.break_down).tolist() == [True, False, False, False]
    env.set_break_down([2])
    assert to_np(env._state.ego.break_down).tolist() == [True, False, True, False]
    env.set_break_down()
    assert bool(env._state.ego.break_down.all())
    env.set_break_down(break_down=False)
    assert not bool(env._state.ego.break_down.any())


def test_snapshot_restore_round_trip():
    """A snapshot is a numpy tree of the state; restoring it and stepping
    again gives bit-equal obs, reward and state, and restore recomputes the
    last obs as JAX's does (`_observe` at zero offsets)."""
    env = TorchEnv(SNAP_CFG, device="cpu")
    env.reset(seed=0)
    for _ in range(10):
        env.step(FULL)
    snap = env.snapshot()
    assert isinstance(snap.ego.pos, np.ndarray) and snap.rng.dtype == np.int64
    runs = []
    for _ in range(2):
        steps = [env.step(FULL)[:2] for _ in range(15)]
        runs.append((steps, state_to_numpy(env._state)))
        env.restore(snap)
    for (o1, r1), (o2, r2) in zip(runs[0][0], runs[1][0]):
        assert torch.equal(o1, o2) and torch.equal(r1, r2)
    assert_trees_close(runs[0][1], runs[1][1], atol=0.0)
    restored = env.snapshot()
    assert restored.rng.dtype == np.int64 and restored.ego.break_down.dtype == np.bool_
    assert_trees_close(state_to_numpy(tree_map(torch.as_tensor, snap)),
                       state_to_numpy(tree_map(torch.as_tensor, restored)), atol=0.0)
    zeros = torch.zeros(4)
    assert torch.equal(env._last_obs, env._observe(env._state, zeros, zeros))


def test_record_episode_and_replay_frame():
    """record_episode(10), then replay_frame(rec, 4) and one step equal to
    recorded frame 5, bit for bit; the recording pickles."""
    env = TorchEnv(SNAP_CFG, device="cpu")
    env.reset(seed=0)
    rec = env.record_episode(10, actions=FULL)
    assert set(rec) == {"state", "obs", "reward", "terminated", "truncated", "ego_action"}
    assert rec["reward"].shape == (10, 4) and rec["obs"].shape == (10, 4, env.observation_dim)
    assert isinstance(rec["state"].ego.pos, np.ndarray) and rec["state"].ego.pos.shape[0] == 10
    obs4 = env.replay_frame(rec, 4)
    assert obs4.shape == (4, env.observation_dim)
    obs, reward, *_ = env.step(FULL)
    np.testing.assert_array_equal(to_np(obs), rec["obs"][5])
    np.testing.assert_array_equal(to_np(reward), rec["reward"][5])
    assert_trees_close(state_to_numpy(tree_map(torch.as_tensor, tree_map(lambda x: x[5],
                                                                          rec["state"]))),
                       state_to_numpy(env._state), atol=0.0)
    rec2 = pickle.loads(pickle.dumps(rec))
    np.testing.assert_array_equal(rec["state"].ego.pos, rec2["state"].ego.pos)
    np.testing.assert_array_equal(rec["obs"], rec2["obs"])


PACK_CFG = dict(num_envs=2, map="SC", num_scenarios=2, traffic_density=0.2)


def _assert_packs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_dump_all_maps_reloads_bit_equal(tmp_path, writer):
    """A pack dumped by either package loads in the port bit-equal, and the
    reloaded env steps as the original."""
    src = TorchEnv(PACK_CFG, device="cpu") if writer == "torch" else JaxEnv(PACK_CFG)
    path = src.dump_all_maps(str(tmp_path / "maps.pkl"))
    with open(path, "rb") as f:
        blob = f.read()
    # numpy and Python objects only: nothing the port would have to import
    # from the JAX package to unpickle it
    assert b"metadrive_ped" not in blob
    dumped = pickle.loads(blob)
    assert dumped["num_scenarios"] == 2 and dumped["start_seed"] == 0
    env = TorchEnv(dict(PACK_CFG, map_pack_file=path), device="cpu")
    _assert_packs_equal(src._pack, env._pack)
    ref = TorchEnv(PACK_CFG, device="cpu")
    _assert_packs_equal(ref._pack, env._pack)
    act = np.tile([0.0, 0.7], (2, 1))
    for e in (ref, env):
        e.reset(seed=0)
    for _ in range(3):
        assert torch.equal(ref.step(act)[0], env.step(act)[0])


def test_get_map_features_and_draw_map(tmp_path):
    """get_map_features of map "CS" equals JAX's (same keys, types and
    polylines), and draw_map writes a non-empty PNG of it."""
    cfg = dict(num_envs=2, map="CS", num_scenarios=2, traffic_density=0.0)
    jenv, tenv = JaxEnv(cfg), TorchEnv(cfg, device="cpu")
    for i in range(2):
        mj, mt = jenv.get_map_features(i), tenv.get_map_features(i)
        assert mj.keys() == mt.keys()
        for k in mj:
            assert set(mj[k]) == set(mt[k]), k
            for f in mj[k]:
                if isinstance(mj[k][f], np.ndarray):
                    np.testing.assert_array_equal(mt[k][f], mj[k][f], err_msg=f"{k}.{f}")
                else:
                    assert mt[k][f] == mj[k][f], (k, f)
    mf = tenv.get_map_features(1)
    assert len([v for v in mf.values() if "LANE" in str(v["type"]).upper()]) >= 6
    out = str(tmp_path / "map.png")
    draw_map(mf, save_path=out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 1000
