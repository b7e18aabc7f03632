"""ScenarioEnv demo on a self-generated dataset
(reference: examples/drive_in_real_env.py replays bundled nuScenes data;
here PG rollouts are exported to ScenarioDescription pickles and replayed:
the same record -> export -> replay loop, with no download).

    python -m metadrive_ped_torch.examples.drive_in_real_env [--reactive] [--cpu]
"""
import argparse
import tempfile

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--reactive", action="store_true",
                        help="reactive traffic (TrajectoryIDMPolicy) instead of pure replay")
    parser.add_argument("--steps", "-n", default=60, type=int)
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch import MetaDriveEnv, ScenarioEnv
    from metadrive_ped_torch.scenario import export_scenarios
    from metadrive_ped_torch.scenario.utils import save_dataset

    src = MetaDriveEnv(dict(num_envs=4, num_scenarios=4, map=3, traffic_density=0.1),
                       device=device)
    src.reset(seed=0)
    scenarios = list(export_scenarios(src, n_steps=100).values())
    with tempfile.TemporaryDirectory() as d:
        save_dataset(scenarios, d)
        env = ScenarioEnv(dict(num_envs=4, num_scenarios=len(scenarios), data_directory=d,
                               reactive_traffic=args.reactive), device=device)
    env.reset(seed=0)
    act = torch.tensor([0.0, 0.4], device=device).expand(4, 2)
    rtot = torch.zeros((), device=device)
    for _ in range(args.steps):
        obs, r, term, trunc, info = env.step(act)
        rtot += r.sum()
    print(f"replayed {len(scenarios)} exported scenarios for {args.steps} steps, "
          f"reward {float(rtot):.1f}, "
          f"route completion {float(info['route_completion'].mean()):.2f}")
    return obs


if __name__ == "__main__":
    main()
