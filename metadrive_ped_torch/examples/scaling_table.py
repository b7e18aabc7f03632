"""Sharding-overhead study: the same total batch unsharded and through
`ShardedEnv` over a mesh of one device repeated n times.

Every shard sits on the same device, so an n-shard run does the same work
as the unsharded run of the same TOTAL env count, and any difference in
throughput is the cost of the data-parallel layer (on the card: the host's
launches, since each shard launches the whole step). For each n it runs
the same total batch twice:

  unsharded: E = n * envs_per_device, one env
  sharded:   E = n * envs_per_device, ShardedEnv(env, [device] * n)

and prints one JSON row per run, then a markdown table of sharded over
unsharded throughput. One process; on the GPU unless --device cpu.

    python -m metadrive_ped_torch.examples.scaling_table [--envs-per-device 256]
        [--steps 30] [--devices 1 2 4 8] [--config pg|scenario] [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch

from metadrive_ped_torch.core.device import resolve_device


def scenario_data(device):
    """Four episodes of a PG env on map "CS" with respawn traffic, exported
    at throttle 0.7: the scenes of the `scenario` config."""
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.scenario import export_scenarios
    src = MetaDriveEnv(dict(num_envs=4, map="CS", num_scenarios=4, traffic_density=0.4,
                            traffic_mode="respawn"), device=device)
    src.reset(seed=0)
    return list(export_scenarios(
        src, 60, actions=np.tile([0.0, 0.7], (4, 1)).astype(np.float32)).values())


def make_env(config, num_envs, device, sds=None):
    from metadrive_ped_torch import MetaDriveEnv, ScenarioEnv
    if config == "scenario":
        return ScenarioEnv(dict(num_envs=num_envs, scenario_data=sds, reactive_traffic=True),
                           device=device)
    return MetaDriveEnv(dict(num_envs=num_envs, map=3, num_scenarios=8, traffic_density=0.05),
                        device=device)


def run(n, num_envs, steps, config, device, sds=None):
    """One row: env-steps/s of the second of two `rollout`s of ``steps``
    steps, unsharded for n = 1, else over ``[device] * n``."""
    from metadrive_ped_torch.parallel import ShardedEnv, make_mesh
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    env = make_env(config, num_envs, device, sds)
    if n > 1:
        env = ShardedEnv(env, make_mesh([device] * n))
    env.reset(seed=0)
    acts = np.tile([0.0, 1.0], (num_envs, 1)).astype(np.float32)
    env.rollout(steps, actions=acts)  # warm-up: builds the kernel at first use
    sync()
    t0 = time.perf_counter()
    env.rollout(steps, actions=acts)
    sync()
    dt = time.perf_counter() - t0
    env.close()
    row = dict(devices=n, num_envs=num_envs, steps_per_s=num_envs * steps / dt,
               device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs-per-device", type=int, default=256)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--config", default="pg", choices=("pg", "scenario"),
                   help="env family: the PG env or reactive replay of PG exports")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sds = scenario_data(device) if args.config == "scenario" else None

    rows = []
    for n in args.devices:
        total = n * args.envs_per_device
        base = run(1, total, args.steps, args.config, device, sds)  # same total, unsharded
        shard = run(n, total, args.steps, args.config, device, sds) if n > 1 else base
        rows.append((n, total, base["steps_per_s"], shard["steps_per_s"]))

    print("\n| devices | total envs | unsharded steps/s | sharded steps/s | overhead |")
    print("|---|---|---|---|---|")
    for n, total, b, s in rows:
        print(f"| {n} | {total} | {b:,.0f} | {s:,.0f} | {1 - s / b:+.1%} |")
    return rows


if __name__ == "__main__":
    main()
