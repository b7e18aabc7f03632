"""Throughput profiling, after the reference protocol
(examples/profile_metadrive.py:14-41: PG maps from start_seed 1010,
traffic_density 0.05, full-throttle action, time excluding reset) over a
lockstep env batch with auto-reset, so the rate is aggregate env-steps/s.

    python -m metadrive_ped_torch.examples.profile_metadrive [--cpu]
"""
import argparse
import time

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-steps", "-n", default=200, type=int,
                        help="per-env steps to profile")
    parser.add_argument("--num-envs", "-e", default=1024, type=int)
    parser.add_argument("--num-scenarios", default=100, type=int,
                        help="reference uses 1000; map compile is host-side")
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    from metadrive_ped_torch import MetaDriveEnv

    print(f"Profiling: {args.num_envs} lockstep envs, "
          f"{args.num_scenarios} maps, traffic_density=0.05")
    env = MetaDriveEnv(dict(num_envs=args.num_envs, num_scenarios=args.num_scenarios,
                            start_seed=1010, traffic_density=0.05), device=device)
    env.reset(seed=0)
    action = torch.tensor([0.0, 1.0], device=device).expand(args.num_envs, 2)
    env.step(action)  # warm-up
    sync()
    start = time.perf_counter()
    for s in range(args.num_steps):
        env.step(action)  # auto-reset handles terminations in the step
        if (s + 1) % 50 == 0:
            sync()
            fps = (s + 1) * args.num_envs / (time.perf_counter() - start)
            print(f"Finish {s + 1}/{args.num_steps} steps. Aggregate env-steps/s: {fps:,.0f}")
    sync()
    dt = time.perf_counter() - start
    rate = args.num_steps * args.num_envs / dt
    print(f"Total Time Elapse: {dt:.3f}, aggregate env-steps/s: {rate:,.0f}")
    return rate


if __name__ == "__main__":
    main()
