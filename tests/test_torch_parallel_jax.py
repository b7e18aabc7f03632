"""The port's ShardedEnv against the JAX package's, step for step: the
port's over 2 CPU devices, JAX's over the conftest's 8 virtual devices,
for the PG env (with and without lidar noise and dropout), ScenarioEnv
with reactive traffic on PG exports and the multi-agent roundabout, at
tests/_torch_parity.py's tolerances; and the port's replayed sharded
rollout (each shard's graphs, run by tests/test_torch_graph.py's
stand-in) against JAX's sharded steps. tests/test_torch_parallel.py holds
the sharded env against the port's unsharded one."""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_trees_close, check_run, np_tree, obs_gap, run_pair, to_np, yaw_column,
)
from test_torch_parallel import NOISE, PG, STEPS, _actions, _gap, _make, exported  # noqa: F401

import metadrive_ped_tpu as jpkg
from metadrive_ped_torch.core import graph
from metadrive_ped_torch.core.convert import state_to_numpy
from metadrive_ped_torch.parallel import ShardedEnv
from metadrive_ped_tpu.parallel import ShardedEnv as JaxShardedEnv

ATOL = 1e-4  # tests/_torch_parity.py::check_run's default

JAX_CASES = {
    "pg": ("MetaDriveEnv", PG),
    "pg_noise": ("MetaDriveEnv", NOISE),
    "scenario_reactive": ("ScenarioEnv", dict(num_envs=16, reactive_traffic=True)),
    "roundabout": ("MultiAgentRoundaboutEnv", dict(num_envs=8, num_agents=8)),
}


@pytest.fixture(scope="module")
def jax_pg():
    """JAX's ShardedEnv of the "pg" case, shared by the tests of this
    module, so that its compiled step serves both."""
    return JaxShardedEnv(jpkg.MetaDriveEnv(PG))


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_matches_jax_sharded(name, exported, jax_pg):
    """The port's ShardedEnv over 2 CPU devices against JAX's over the 8
    virtual devices, step for step (`_torch_parity.check_run`)."""
    if len(jax.devices()) < 8:
        pytest.fail("the conftest gives JAX 8 virtual CPU devices")
    cls, cfg = JAX_CASES[name]
    if cls == "ScenarioEnv":
        from metadrive_ped_tpu.envs.scenario_env import ScenarioEnv as JaxScenarioEnv
        cfg = dict(cfg, scenario_data=exported)
        jenv = JaxShardedEnv(JaxScenarioEnv(cfg))
    elif name == "pg":
        jenv = jax_pg
    else:
        jenv = JaxShardedEnv(getattr(jpkg, cls)(cfg))
    tenv = ShardedEnv(_make(cls, cfg, exported), ["cpu"] * 2)
    run = run_pair(jenv, tenv, list(_actions(tenv, STEPS)), seed=3)
    (oj, _), (ot, _) = run["reset"]
    assert _gap(torch.as_tensor(np.array(oj)), ot) <= 1e-6
    assert len(jenv.env._state.ego.pos.sharding.device_set) == 8
    if cls != "ScenarioEnv":
        assert check_run(run, tenv, yaw_column(tenv.config["vehicle_config"])) == 0
        return
    # tests/test_torch_scenario.py's comparison: the yaw rate and the two
    # lateral offsets through obs_gap, lateral_dist through its signed square
    yaw, lat = 12 + 5, (12 + 6, 12 + 7 + 18)
    for (oj, rj, tj, trj, ij), (ot, rt, tt, trt, it), _, _ in run["steps"]:
        assert obs_gap(oj, ot, yaw, lat) <= ATOL
        np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(to_np(tt), np.asarray(tj))
        np.testing.assert_array_equal(to_np(trt), np.asarray(trj))
        assert set(it) == set(ij)
        for k in ij:
            a, b = np.asarray(ij[k]), to_np(it[k])
            if k == "lateral_dist":
                a, b = a * np.abs(a), b * np.abs(b)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a, err_msg=k)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=ATOL, err_msg=k)


def test_replayed_sharded_rollout_matches_jax_sharded(jax_pg, monkeypatch):
    """The port's sharded rollout with each shard's step replayed
    (tests/test_torch_graph.py's `EagerGraph` in place of CUDA graphs)
    against JAX's ShardedEnv stepped with the same fixed actions (its
    compiled step, as the "pg" case above): obs (yaw through cos), reward
    and the final state within tests/_torch_parity.py's 1e-4, flags equal."""
    from test_torch_graph import EagerGraph
    monkeypatch.setattr(graph, "capture_backend", lambda device: EagerGraph)
    tenv = ShardedEnv(_make("MetaDriveEnv", PG), ["cpu"] * 2)
    act = _actions(tenv, 1, seed=1)[0]
    jax_pg.reset(seed=3)
    tenv.reset(seed=3)
    collect = ("obs", "reward", "terminated", "truncated")
    touts, _ = tenv.rollout(STEPS, actions=torch.from_numpy(act), collect=collect)
    assert tenv._graphs.replays == STEPS and tenv._graphs.shard_replays == [STEPS] * 2
    yaw = yaw_column(tenv.config["vehicle_config"])
    for t in range(STEPS):
        oj, rj, tj, trj, _ = jax_pg.step(act)
        assert obs_gap(np.asarray(oj), to_np(touts["obs"][t]), yaw) <= ATOL
        np.testing.assert_allclose(to_np(touts["reward"][t]), np.asarray(rj), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(to_np(touts["terminated"][t]), np.asarray(tj))
        np.testing.assert_array_equal(to_np(touts["truncated"][t]), np.asarray(trj))
    assert_trees_close(np_tree(jax_pg._state), state_to_numpy(tenv._state), atol=ATOL)
