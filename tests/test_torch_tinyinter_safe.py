"""The port's MultiAgentTinyInter (rule-based rows, the RL-only surface, the
CommunicationObservation with and without add_others_navi),
SafeMetaDriveEnv (accident scenes, cylinder bodies, crashes that cost
instead of ending the episode) and VaryingDynamicsEnv against the JAX
package's, step for step; tolerances as in
tests/_torch_parity.py::check_run."""
import numpy as np
import pytest
from _torch_parity import check_run, obs_gap, run_pair, surface_rows, to_np, yaw_column
from test_torch_marl import ATOL, full_throttle, random_actions

import metadrive_ped_torch as T
import metadrive_ped_tpu as JP
from metadrive_ped_tpu.envs import marl_envs as J

TINY_VC = dict(lidar=dict(num_lasers=24, distance=40.0, num_others=0))
CASES = {
    "tinyinter_rule_rows": ("MultiAgentTinyInter",
                            dict(num_envs=2, num_agents=6, num_RL_agents=3, vehicle_config=TINY_VC),
                            40, random_actions),
    "tinyinter_comm": ("MultiAgentTinyInter",
                       dict(num_envs=1, num_agents=5, num_RL_agents=5, use_communication_obs=True,
                            vehicle_config=TINY_VC), 30, random_actions),
    "tinyinter_comm_navi": ("MultiAgentTinyInter",
                            dict(num_envs=1, num_agents=5, num_RL_agents=3,
                                 use_communication_obs=True,
                                 vehicle_config=dict(lidar=dict(TINY_VC["lidar"],
                                                                add_others_navi=True))),
                            30, random_actions),
    # dense accidents: cones, warnings and parked cars that cost, not end
    "safe": ("SafeMetaDriveEnv", dict(num_envs=16, num_scenarios=16,
                                      vehicle_config=dict(lidar=dict(num_lasers=36))),
             120, full_throttle),
    "varying_dynamics": ("VaryingDynamicsEnv",
                         dict(num_envs=8, num_scenarios=2, map="SC", traffic_density=0.1,
                              horizon=30, vehicle_config=dict(lidar=dict(num_lasers=36))),
                         60, random_actions),
}
_RUNS = {}


def get_run(name):
    if name not in _RUNS:
        cls, cfg, steps, acts = CASES[name]
        jcls = getattr(J, cls, None) or getattr(JP, cls)
        je, te = jcls(cfg), getattr(T, cls)(cfg, device="cpu")
        _RUNS[name] = (je, te, run_pair(je, te, acts(surface_rows(te).shape, steps)))
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_env_matches_jax(name):
    je, te, run = get_run(name)
    (oj, _), (ot, _) = run["reset"]
    assert tuple(ot.shape) == surface_rows(te).shape + (te.observation_dim,)
    D = te.observation_dim
    assert obs_gap(np.asarray(oj).reshape(-1, D), to_np(ot).reshape(-1, D),
                   yaw_column(te.config["vehicle_config"])) <= ATOL
    check_run(run, te, yaw_column(te.config["vehicle_config"]), atol=ATOL)


def test_tinyinter_rule_rows_advance():
    """Rule rows move along their lane at the target speed; the surface
    shows only the RL columns."""
    je, te, run = get_run("tinyinter_rule_rows")
    assert tuple(run["steps"][0][1][0].shape[:2]) == (2, 3)
    A, K = 6, 3
    before = to_np(run["steps"][0][3].ego.pos).reshape(2, A, 2)
    after = to_np(run["steps"][5][3].ego.pos).reshape(2, A, 2)
    moved = np.linalg.norm(after - before, axis=-1)
    step = te.config["target_speed"] / 3.6 * 0.1
    assert (moved[:, K:] > 4 * step).all()


def test_tinyinter_comm_layout():
    for name, res in (("tinyinter_comm", 5), ("tinyinter_comm_navi", 9)):
        je, te, run = get_run(name)
        A = te.agents_per_env
        assert te.observation_dim == 19 + 24 + A * res
        (_, _), (ot, _) = run["reset"]
        comm = to_np(ot)[0][:, 19:19 + A * res].reshape(-1, A, res)
        # every live slot carries its id; the own slot sits at the centre
        np.testing.assert_allclose(comm[:, :, 0], np.tile((np.arange(A) + 1) / A, (len(comm), 1)),
                                   rtol=0, atol=1e-6)
        for a in range(len(comm)):
            np.testing.assert_allclose(comm[a, a, 1:3], 0.5, rtol=0, atol=1e-6)


def test_safe_crashes_cost_and_do_not_end():
    je, te, run = get_run("safe")
    assert te._has_cylinders
    info = [s[1][4] for s in run["steps"]]
    crashes = sum(int(to_np(i[k]).sum()) for i in info
                  for k in ("crash_vehicle", "crash_object", "crash_human"))
    assert crashes > 0
    ends = np.stack([to_np(s[1][2]) for s in run["steps"]])
    obj = np.stack([to_np(i["crash_object"]) | to_np(i["crash_vehicle"]) for i in info])
    assert (obj & ~ends).any(), "a crash must cost without ending the episode"
    assert max(float(to_np(i["total_cost"]).max()) for i in info) >= 1.0


def test_varying_dynamics_differ_per_episode():
    je, te, run = get_run("varying_dynamics")
    gains = to_np(run["steps"][0][3].ego.params.accel_gain)
    assert len(np.unique(gains)) == len(gains)
