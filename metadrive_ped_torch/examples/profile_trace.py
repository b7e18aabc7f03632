"""Device-op profiling: trace one rollout with torch.profiler and print the
per-kernel time table (on the CPU, the per-operator table), then run one
more with the port's tracer on (core/trace.py) and print its stage table:
each device span of the step (replay, advance and its stages, observe and
its stages, the write-back; on the card from the stamps inside the
replayed graph), each host span, and the useful-work counters.

    python -m metadrive_ped_torch.examples.profile_trace --config pg
    python -m metadrive_ped_torch.examples.profile_trace --config scenario_waymo --num-envs 512

The Waymo-scale scenes of the scenario_waymo and scenario_replay configs
come from `scenario.synthetic.synthetic_waymo_sd` (the shapes of the
reference's Waymo FPS protocol). ``--trace PATH`` also writes the Chrome
trace.
"""
import argparse
import tempfile
import time

import torch

from metadrive_ped_torch.core import trace
from metadrive_ped_torch.examples import example_device, force_cpu_flag

CONFIGS = ("pg", "marl", "scenario", "scenario_waymo", "scenario_replay")


def make_env(config, num_envs, scenarios, device):
    import metadrive_ped_torch as port
    if config == "pg":
        return port.MetaDriveEnv(dict(num_envs=num_envs, map=3, num_scenarios=scenarios,
                                      traffic_density=0.05), device=device)
    if config == "marl":
        return port.MultiAgentRoundaboutEnv(dict(num_envs=num_envs), device=device)
    if config == "scenario":
        from metadrive_ped_torch.scenario import export_scenarios
        from metadrive_ped_torch.scenario.utils import save_dataset
        src = port.MetaDriveEnv(dict(num_envs=scenarios, num_scenarios=scenarios, map=3,
                                     traffic_density=0.1), device=device)
        src.reset(seed=0)
        with tempfile.TemporaryDirectory() as d:
            save_dataset(list(export_scenarios(src, n_steps=100).values()), d)
            return port.ScenarioEnv(dict(num_envs=num_envs, num_scenarios=scenarios,
                                         data_directory=d, reactive_traffic=True), device=device)
    from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
    sds = [synthetic_waymo_sd(s) for s in range(scenarios)]
    if config == "scenario_waymo":
        return port.ScenarioEnv(dict(num_envs=num_envs, scenario_data=sds, reactive_traffic=True),
                                device=device)
    if config == "scenario_replay":
        # the reference's Waymo-replay FPS protocol: replay ego, 120 + 160 + 12 lasers
        return port.ScenarioEnv(dict(
            num_envs=num_envs, scenario_data=sds, replay_ego=True,
            vehicle_config=dict(lidar=dict(num_lasers=120), side_detector=dict(num_lasers=160),
                                lane_line_detector=dict(num_lasers=12))), device=device)
    raise ValueError(config)


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="pg", choices=CONFIGS)
    p.add_argument("--num-envs", "-e", type=int, default=1024)
    p.add_argument("--num-steps", "-n", type=int, default=50)
    p.add_argument("--num-scenarios", type=int, default=16)
    p.add_argument("--trace", default=None, help="write the Chrome trace here")
    force_cpu_flag(p)
    args = p.parse_args(argv)
    device = example_device(args)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    env = make_env(args.config, args.num_envs, args.num_scenarios, device)
    env.reset(seed=0)
    rows = env.num_envs
    acts = torch.tensor([0.0, 1.0], device=device).expand(rows, 2).contiguous()
    env.rollout(args.num_steps, actions=acts, collect=())  # warm-up
    sync()
    t0 = time.perf_counter()
    env.rollout(args.num_steps, actions=acts, collect=())
    sync()
    dt = time.perf_counter() - t0
    print(f"{rows * args.num_steps / dt:,.0f} env-steps/s "
          f"({rows} envs x {args.num_steps} steps in {dt * 1e3:.1f} ms)")

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        env.rollout(args.num_steps, actions=acts, collect=())
        sync()
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")
    sort_by = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    table = prof.key_averages().table(sort_by=sort_by, row_limit=25)
    print(table)

    # the stage table: the first traced call captures the stamped graph,
    # the second is read (on the card in the slower phase that follows a
    # capture, PERF.md §2)
    recs = trace.read(lambda: env.rollout(args.num_steps, actions=acts, collect=()))
    print(trace.table(recs, args.num_steps))
    return table


if __name__ == "__main__":
    main()
