"""The port's MetaDriveEnv against the JAX package's, step for step.

16 envs on map "SCS" (2 scenarios, traffic 0.1) with the side detector (8
lasers) and the lane-line detector (6 lasers), as tests/test_env.py:129-137
configures them, for 50 steps of the same random actions. Observations,
rewards and float info match at atol 1e-4; terminated, truncated and every
bool info flag match exactly. The yaw-rate feature is compared through
cos(0.1 * f) (tests/_torch_parity.py::obs_gap)."""
import numpy as np
import pytest
import torch
from _torch_parity import assert_trees_close, np_tree, obs_gap, to_np, yaw_column

from metadrive_ped_torch import MetaDriveEnv as TorchEnv
from metadrive_ped_torch.core.convert import state_from_numpy, state_to_numpy
from metadrive_ped_tpu import MetaDriveEnv as JaxEnv

CFG = dict(num_envs=16, map="SCS", num_scenarios=2, traffic_density=0.1,
           vehicle_config=dict(side_detector=dict(num_lasers=8, distance=50.0),
                               lane_line_detector=dict(num_lasers=6, distance=20.0)))
STEPS = 50
HANDOVER_STEPS = 10
ATOL = 1e-4
YAW = yaw_column(CFG["vehicle_config"])


def _actions(seed, steps, E):
    rng = np.random.RandomState(seed)
    return np.clip(rng.normal([0.0, 0.6], [0.3, 0.4], (steps, E, 2)), -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """Both envs from reset through STEPS steps, then the port stepping on
    from the JAX state handed over mid-episode."""
    je, te = JaxEnv(CFG), TorchEnv(CFG, device="cpu")
    E = CFG["num_envs"]
    out = dict(reset=(je.reset(seed=0), te.reset(seed=0)),
               reset_state=(np_tree(je._state), state_to_numpy(te._state)), steps=[])
    for a in _actions(0, STEPS, E):
        out["steps"].append((je.step(a), te.step(a)))
    out["final_state"] = (np_tree(je._state), state_to_numpy(te._state))
    # handover: a fresh port env continues from the JAX env's state
    te2 = TorchEnv(CFG, device="cpu")
    te2._state = state_from_numpy(np_tree(je._state), "cpu")
    out["handover"] = [(je.step(a), te2.step(a)) for a in _actions(1, HANDOVER_STEPS, E)]
    return out


def test_reset_obs_equal(runs):
    (oj, ij), (ot, it) = runs["reset"]
    assert ot.shape == (16, 9 + 6 + 5 + 10 + 240)
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to_np(it["env_seed"]), np.asarray(ij["env_seed"]))


def test_reset_state_equal(runs):
    """Same seed, same scenarios and spawn slots (the threefry twin)."""
    assert_trees_close(*runs["reset_state"], atol=1e-6)


def _check_step(jax_out, torch_out):
    oj, rj, tj, trj, ij = jax_out
    ot, rt, tt, trt, it = torch_out
    assert obs_gap(oj, ot, YAW) <= ATOL
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(to_np(tt), np.asarray(tj))
    np.testing.assert_array_equal(to_np(trt), np.asarray(trj))
    assert set(it) == set(ij)
    for k in ij:
        a, b = np.asarray(ij[k]), to_np(it[k])
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            # episode totals grow with the episode: one float32 rounding each
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("chunk", range(5))
def test_steps_match(runs, chunk):
    """Steps 10*chunk .. 10*chunk+9."""
    for i in range(chunk * 10, chunk * 10 + 10):
        _check_step(*runs["steps"][i])


def test_episodes_end_in_both(runs):
    done = sum(int(np.asarray(j[2]).sum()) for j, _ in runs["steps"])
    assert done > 0, "the comparison should cover terminations and auto-resets"


def test_final_state_close(runs):
    assert_trees_close(*runs["final_state"], atol=ATOL)


def test_state_from_numpy_mid_episode(runs):
    for jax_out, torch_out in runs["handover"]:
        _check_step(jax_out, torch_out)


def test_rollout_equals_step_loop():
    cfg = dict(CFG, num_envs=6)
    a, b = TorchEnv(cfg, device="cpu"), TorchEnv(cfg, device="cpu")
    a.reset(seed=3)
    b.reset(seed=3)
    act = torch.tensor([[0.1, 0.9]] * 6)
    outs, mean_reward = a.rollout(12, actions=act, collect=("reward", "obs", "terminated", "state"))
    rewards, obs, terms = [], [], []
    for _ in range(12):
        o, r, term, _, _ = b.step(act)
        rewards.append(r)
        obs.append(o)
        terms.append(term)
    torch.testing.assert_close(outs["reward"], torch.stack(rewards), rtol=0, atol=0)
    torch.testing.assert_close(outs["obs"], torch.stack(obs), rtol=0, atol=0)
    torch.testing.assert_close(outs["terminated"], torch.stack(terms), rtol=0, atol=0)
    torch.testing.assert_close(outs["state"].ego.pos[-1], b._state.ego.pos, rtol=0, atol=0)
    assert mean_reward == pytest.approx(float(torch.stack(rewards).mean()))


EXPERT_LIDAR = dict(lidar=dict(num_lasers=240, num_others=4))


@pytest.mark.parametrize("override", [
    dict(agent_policy="lane_change", discrete_action=True),
    dict(use_AI_protector=True, vehicle_config=EXPERT_LIDAR),
    dict(manual_control=True, controller=[[0.2, 1.0]] * 2),
    dict(rl_agent_ratio=0.3, traffic_density=0.3),
    dict(vehicle_config=dict(lidar=dict(gaussian_noise=0.1))),
    dict(vehicle_config=dict(lidar=dict(dropout_prob=0.1))),
], ids=["lane_change", "AI_protector", "manual_control", "rl_agent_ratio", "gaussian_noise",
        "dropout_prob"])
def test_ported_options_step(override):
    """Each option of the agent-policy slice constructs, resets and steps
    (tests/test_torch_policies.py and test_torch_mixed_traffic.py hold them
    against the JAX package)."""
    env = TorchEnv(dict(dict(num_envs=2, map="S", traffic_density=0.0), **override), device="cpu")
    obs, _ = env.reset(seed=0)
    act = np.ones(2, np.int64) if env.config["discrete_action"] else np.tile([0.0, 0.8], (2, 1))
    for _ in range(3):
        obs, *_ = env.step(act)
    assert obs.shape == (2, env.observation_dim) and bool(torch.isfinite(obs).all())


@pytest.mark.parametrize("override", [dict(image_observation=True)])
def test_options_outside_the_slice_raise(override):
    """image_observation was outside the port until the camera slice; it
    now constructs, resets and steps, giving {"image", "state"}
    (tests/test_torch_camera.py holds it against the JAX package)."""
    env = TorchEnv(dict(num_envs=2, map="S", traffic_density=0.0, **override), device="cpu")
    obs, _ = env.reset(seed=0)
    obs, *_ = env.step(np.tile([0.0, 0.8], (2, 1)))
    assert set(obs) == {"image", "state"}
    assert tuple(obs["image"].shape) == (2, 84, 84, 3, 3)
    assert obs["state"].shape == (2, env.observation_dim)


@pytest.mark.parametrize("method", ["render", "snapshot", "record_episode", "dump_all_maps"])
def test_methods_outside_the_slice_raise(method, tmp_path):
    """render, snapshot, record_episode and dump_all_maps are ported:
    render gives a uint8 RGB frame (tests/test_torch_camera.py holds its
    modes against the JAX package); a snapshot
    restores the state bit for bit, a recorded frame replays into the next
    recorded frame, and a dumped pack reloads bit-equal
    (tests/test_torch_surface.py holds them against the JAX package)."""
    cfg = dict(num_envs=2, map="S", traffic_density=0.1)
    env = TorchEnv(cfg, device="cpu")
    env.reset(seed=0)
    act = np.tile([0.0, 0.8], (2, 1)).astype(np.float32)
    if method == "render":
        frame = env.render()
        assert frame.dtype == np.uint8 and frame.shape == (512, 512, 3)
    elif method == "snapshot":
        env.step(act)
        snap = env.snapshot()
        before = state_to_numpy(env._state)
        for _ in range(3):
            env.step(act)
        env.restore(snap)
        assert_trees_close(before, state_to_numpy(env._state), atol=0.0)
    elif method == "record_episode":
        rec = env.record_episode(5, actions=act)
        env.replay_frame(rec, 2)
        obs, *_ = env.step(act)
        np.testing.assert_array_equal(to_np(obs), rec["obs"][3])
    else:
        path = env.dump_all_maps(str(tmp_path / "x.pkl"))
        again = TorchEnv(dict(cfg, map_pack_file=path), device="cpu")
        for k in env._pack:
            np.testing.assert_array_equal(again._pack[k], env._pack[k], err_msg=k)
