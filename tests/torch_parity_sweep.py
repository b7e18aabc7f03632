#!/usr/bin/env python3
"""Free-running parity sweep of metadrive_ped_torch against the JAX package
over env configurations beyond the test suite's; a script, not a test.

    JAX_PLATFORMS=cpu python tests/torch_parity_sweep.py [--steps 60]

Both envs start from the same seed and take the same random actions; for
each configuration it prints the largest obs and reward gaps (yaw-rate
feature compared through cos(0.1 * f), as in the tests), the first step
where a discrete flag or the state departs, and which leaf departs most.
Departures come from float32 differences (XLA fuses multiply-adds; the
port rounds each op) reaching a threshold; ROADMAP.md queue 3 logs them.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import np_tree, obs_gap, to_np, yaw_column  # noqa: E402

from metadrive_ped_torch import MetaDriveEnv as TorchEnv  # noqa: E402
from metadrive_ped_torch.core.convert import state_to_numpy  # noqa: E402
from metadrive_ped_tpu import MetaDriveEnv as JaxEnv  # noqa: E402

CONFIGS = {
    "map3_traffic": dict(num_envs=32, map=3, num_scenarios=8, traffic_density=0.15),
    "respawn_ramps": dict(num_envs=16, map="SCrRTXO", num_scenarios=2, traffic_density=0.2,
                          traffic_mode="respawn"),
    "accidents_pedestrians": dict(num_envs=16, map=4, num_scenarios=3, accident_prob=0.8,
                                  pedestrian_density=0.5, traffic_density=0.1),
    "traffic_lights": dict(num_envs=16, map="SXS", num_scenarios=2, pg_traffic_lights=True,
                           traffic_density=0.3, traffic_mode="hybrid"),
    "random_dynamics": dict(num_envs=16, map=3, num_scenarios=4, random_agent_model=True,
                            random_dynamics=dict(max_engine_force=(500, 1000),
                                                 max_steering=(30, 50), wheel_friction=(0.6, 1.2)),
                            vehicle_config=dict(lidar=dict(num_lasers=60, num_others=3))),
    "discrete_reverse": dict(num_envs=16, map=2, num_scenarios=2, discrete_action=True,
                             use_lateral_reward=True, horizon=30,
                             vehicle_config=dict(enable_reverse=True, max_speed_km_h=60.0)),
    "workers_no_reset": dict(num_envs=8, map="CCC", num_scenarios=2, num_workers=2,
                             worker_index=1, start_seed=3, auto_reset=False),
}


def leaf_gaps(a, b, path=""):
    out = []
    for k in a:
        name = f"{path}.{k}" if path else k
        if isinstance(a[k], dict):
            out += leaf_gaps(a[k], b[k], name)
            continue
        x, y = a[k], b[k]
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
        if x.size:
            out.append((float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()), name))
    return out


def sweep(name, cfg, steps, seed):
    je, te = JaxEnv(cfg), TorchEnv(cfg, device="cpu")
    E = je.num_envs
    je.reset(seed=seed)
    te.reset(seed=seed)
    yaw = yaw_column(cfg.get("vehicle_config", {}), cfg.get("random_agent_model", False))
    rng = np.random.RandomState(seed)
    worst_obs = worst_rew = 0.0
    first_flag = first_state = None
    for step in range(steps):
        if cfg.get("discrete_action"):
            a = rng.randint(0, 25, E)
        else:
            a = np.clip(rng.normal([0.0, 0.7], [0.4, 0.5], (E, 2)), -1, 1).astype(np.float32)
        oj, rj, tj, trj, ij = je.step(a)
        ot, rt, tt, trt, it = te.step(a)
        worst_obs = max(worst_obs, obs_gap(oj, ot, yaw))
        worst_rew = max(worst_rew, float(np.abs(np.asarray(rj) - to_np(rt)).max()))
        flags = [k for k in ij if np.asarray(ij[k]).dtype == bool
                 and not np.array_equal(np.asarray(ij[k]), to_np(it[k]))]
        if first_flag is None and flags:
            first_flag = (step, flags)
        gap, leaf = max(leaf_gaps(np_tree(je._state), state_to_numpy(te._state)))
        if first_state is None and gap > 1e-3:
            first_state = (step, leaf, gap)
    gap, leaf = max(leaf_gaps(np_tree(je._state), state_to_numpy(te._state)))
    print(f"{name}: obs {worst_obs:.3g} reward {worst_rew:.3g} first flag {first_flag} "
          f"first state > 1e-3 {first_state} final worst {leaf} {gap:.3g}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    for i, (name, cfg) in enumerate(CONFIGS.items()):
        sweep(name, cfg, args.steps, seed=i)


if __name__ == "__main__":
    main()
