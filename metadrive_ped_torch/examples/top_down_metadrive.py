"""Top-down BEV observation demo (reference: examples/top_down_metadrive.py).

    python -m metadrive_ped_torch.examples.top_down_metadrive [--cpu] [-n 50]
"""
import argparse

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", "-n", default=50, type=int)
    parser.add_argument("--num-envs", "-e", default=4, type=int)
    parser.add_argument("--quick", action="store_true", help="2 envs on a one-block map, 5 steps")
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch import TopDownMetaDrive

    cfg = dict(num_envs=args.num_envs, num_scenarios=4)
    if args.quick:
        args.steps, cfg = 5, dict(num_envs=2, num_scenarios=1, map="S")
    env = TopDownMetaDrive(cfg, device=device)
    obs, _ = env.reset(seed=0)
    print("BEV obs:", tuple(obs.shape), obs.dtype)  # [E, 84, 84, 5]
    act = torch.tensor([0.0, 0.8], device=device).expand(env.num_envs, 2)
    for _ in range(args.steps):
        obs, r, term, trunc, info = env.step(act)
    print(f"after {args.steps} steps: occupancy {float((obs > 0).float().mean()):.3f}, "
          f"max {float(obs.max()):.2f}")
    return tuple(obs.shape)


if __name__ == "__main__":
    main()
