"""Multi-agent throughput profiling (reference:
examples/profile_metadrive_marl.py): agent-steps/s over the
MultiAgentRoundaboutEnv.

    python -m metadrive_ped_torch.examples.profile_metadrive_marl [--cpu]
"""
import argparse
import time

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-steps", "-n", default=100, type=int)
    parser.add_argument("--num-envs", "-e", default=64, type=int)
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    from metadrive_ped_torch import MultiAgentRoundaboutEnv

    env = MultiAgentRoundaboutEnv(dict(num_envs=args.num_envs), device=device)
    obs, _ = env.reset(seed=0)
    E, A = obs.shape[:2]
    act = torch.tensor([0.0, 0.5], device=device).expand(E, A, 2)
    env.step(act)  # warm-up
    sync()
    start = time.perf_counter()
    for _ in range(args.num_steps):
        env.step(act)
    sync()
    rate = args.num_steps * E * A / (time.perf_counter() - start)
    print(f"{A} agents x {E} envs: {rate:,.0f} agent-steps/s")
    return rate


if __name__ == "__main__":
    main()
