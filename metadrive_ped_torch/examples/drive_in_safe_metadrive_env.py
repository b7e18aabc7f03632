"""SafeMetaDriveEnv demo: accident scenes and episode cost accounting
(reference: examples/drive_in_safe_metadrive_env.py).

    python -m metadrive_ped_torch.examples.drive_in_safe_metadrive_env [--cpu]
"""
import argparse

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", "-n", default=200, type=int)
    parser.add_argument("--num-envs", "-e", default=16, type=int)
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch import SafeMetaDriveEnv

    env = SafeMetaDriveEnv(dict(num_envs=args.num_envs, num_scenarios=10), device=device)
    env.reset(seed=0)
    act = torch.tensor([0.0, 1.0], device=device).expand(args.num_envs, 2)
    cost_total = torch.zeros((), device=device)
    for _ in range(args.steps):
        obs, r, term, trunc, info = env.step(act)
        cost_total += info["cost"].sum()
    print(f"{args.num_envs} envs x {args.steps} full-throttle steps")
    print(f"accumulated cost {float(cost_total):.1f} (crashes don't terminate in the safe env)")
    return float(cost_total)


if __name__ == "__main__":
    main()
