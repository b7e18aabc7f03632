"""The port's multi-agent scenes against the JAX package's, step for step:
bottleneck and bidirection (side and lane-line detectors on the per-scenario
line table), tollgate (the 156-dim TollGateObservation with both detector
clouds from one call, the toll bookkeeping, the overspeed reward and the
rush-through done), parking lot (reverse, crossable white lines, per-slot
destinations) and racing (guardrails, the idle done). Tolerances as in
tests/_torch_parity.py::check_run."""
import numpy as np
import pytest
from _torch_parity import check_run, obs_gap, run_pair, surface_rows, to_np, yaw_column
from test_torch_marl import ATOL, full_throttle, random_actions

import metadrive_ped_torch as T
from metadrive_ped_tpu.envs import marl_envs as J


def standing(shape, steps):
    return [np.zeros(shape + (2,), np.float32)] * steps


CASES = {
    "bottleneck": ("MultiAgentBottleneckEnv", dict(num_envs=1, num_agents=8), 60, random_actions),
    "bidirection": ("MultiAgentBidirectionEnv", dict(num_envs=1, num_agents=8), 60,
                    random_actions),
    # full throttle through the plaza: overspeed and rush-through dones
    "tollgate_rush": ("MultiAgentTollgateEnv", dict(num_envs=2, num_agents=4), 90, full_throttle),
    "tollgate_random": ("MultiAgentTollgateEnv", dict(num_envs=1, num_agents=8), 110,
                        random_actions),
    "parking_lot": ("MultiAgentParkingLotEnv", dict(num_envs=1, num_agents=6), 60,
                    lambda shape, steps: random_actions(shape, steps, mean=(0.0, 0.3),
                                                        std=(0.5, 0.8))),
    "racing": ("MultiAgentRacingEnv", dict(num_envs=1, num_agents=6), 60, random_actions),
    # standing still for IDLE_STEPS ends the episode as idle
    "racing_idle": ("MultiAgentRacingEnv", dict(num_envs=1, num_agents=2, allow_respawn=False),
                    104, standing),
}
_RUNS = {}


def get_run(name):
    if name not in _RUNS:
        cls, cfg, steps, acts = CASES[name]
        je, te = getattr(J, cls)(cfg), getattr(T, cls)(cfg, device="cpu")
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


def test_tollgate_observation_and_rush_through():
    je, te, run = get_run("tollgate_rush")
    assert te.observation_dim == 156  # 72 side + 6 core + 4 lane-line + 72 lidar + 2 toll
    table, counts = te._line_table
    assert bool((counts[:, 1] > counts[:, 0]).all()), "the lane-line detector sees broken lines"
    # the toll flags turn on inside the plaza
    toll = np.stack([to_np(s[1][0])[..., -2] for s in run["steps"]])
    assert toll.max() == 1.0
    # rushing through latches aux[:, 2] and ends the episode as out_of_road
    rushed = np.stack([s[2]["aux"][:, 2] for s in run["steps"][1:]]) > 0.5
    assert rushed.any(), "full-throttle agents must rush through the plaza"
    oor = np.stack([np.asarray(s[0][4]["out_of_road"]).reshape(-1) for s in run["steps"][:-1]])
    assert (oor & rushed).any()
    # overspeeding inside the plaza is penalized
    rewards = np.stack([np.asarray(s[0][1]).reshape(-1) for s in run["steps"]])
    assert (rewards < 0).any()


def test_racing_idle_done():
    je, te, run = get_run("racing_idle")
    idle = np.stack([to_np(s[1][4]["idle"]).reshape(-1) for s in run["steps"]])
    first = int(np.nonzero(idle.any(1))[0][0])
    assert first == 99, "the 100th still step is idle"
    term = np.stack([to_np(s[1][2]).reshape(-1) for s in run["steps"]])
    assert term[first].all()


def test_racing_guardrails_and_reverse_parking():
    je, te, run = get_run("racing")
    side = np.stack([to_np(s[1][4]["crash_sidewalk"]).reshape(-1) for s in run["steps"]])
    assert "progress" in run["steps"][0][1][4] and side.any(), "racers must brush the rails"
    je, te, run = get_run("parking_lot")
    assert te.config["vehicle_config"]["enable_reverse"]
    speed = np.stack([to_np(s[3].ego.speed) for s in run["steps"][1:]])
    assert (speed < 0).any(), "parking agents must reverse"
