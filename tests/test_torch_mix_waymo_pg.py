"""The port's MixWaymoPGEnv against the JAX package's: from the same config
(3 small synthetic scenarios and a PG map "S", 4 envs) both visit the same
suite sequence over 4 resets (the flips and the PG initial speeds come from
np.random.RandomState(0) on the host), and each reset's episode matches
within 1e-4 over 10 steps: obs (the yaw-rate and lateral-offset features
through `obs_gap`), reward and done flags."""
import numpy as np
import pytest
from _torch_parity import obs_gap, to_np, yaw_column

from metadrive_ped_torch import MixWaymoPGEnv as TorchMix
from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
from metadrive_ped_tpu import MixWaymoPGEnv as JaxMix

E, RESETS, STEPS, ATOL = 4, 4, 10, 1e-4
VEHICLE = dict(side_detector=dict(num_lasers=8), lane_line_detector=dict(num_lasers=4))


def _columns(real):
    """(yaw column, lateral-offset columns) of either suite's observation."""
    if real:
        side = VEHICLE["side_detector"]["num_lasers"]
        return side + 5, (side + 6, side + 7 + 18)
    return yaw_column(VEHICLE), ()


@pytest.fixture(scope="module")
def runs():
    sds = [synthetic_waymo_sd(s, T=40, n_tracks=12, lane_pts=40) for s in range(3)]
    cfg = dict(num_envs=E, scenario_data=sds, map="S", traffic_density=0.1,
               vehicle_config=VEHICLE)
    out = []
    for env in (JaxMix(cfg), TorchMix(cfg, device="cpu")):
        assert env.real_data_ratio == 0.5
        episodes = []
        rng = np.random.RandomState(7)
        for i in range(RESETS):
            obs, _ = env.reset(seed=i)
            speed = to_np(env.pg_env._state.ego.speed) if not env.is_current_real_data else None
            steps = []
            for a in np.clip(rng.normal([0.0, 0.6], [0.3, 0.3], (STEPS, E, 2)), -1, 1):
                steps.append(tuple(to_np(x) for x in env.step(a.astype(np.float32))[:4]))
            episodes.append((env.is_current_real_data, to_np(obs), speed, steps))
        out.append(episodes)
    return out


def test_same_suite_sequence(runs):
    jax_eps, torch_eps = runs
    suites = [e[0] for e in torch_eps]
    assert suites == [e[0] for e in jax_eps]
    assert set(suites) == {True, False}, "both suites within 4 resets"
    for (real, _, sj, _), (_, _, st, _) in zip(jax_eps, torch_eps):
        if not real:
            np.testing.assert_array_equal(st, sj)  # randint(0, 10) initial speeds
            assert st.dtype == np.float32


@pytest.mark.parametrize("reset", range(RESETS))
def test_episode_matches_jax(runs, reset):
    (real, oj, _, sj), (_, ot, _, st) = runs[0][reset], runs[1][reset]
    yaw, lat = _columns(real)
    assert obs_gap(oj, ot, yaw, lat) <= ATOL
    for (o1, r1, t1, tr1), (o2, r2, t2, tr2) in zip(sj, st):
        assert obs_gap(o1, o2, yaw, lat) <= ATOL
        np.testing.assert_allclose(r2, r1, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(t2, t1)
        np.testing.assert_array_equal(tr2, tr1)
