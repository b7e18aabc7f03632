"""Throughput benchmark of the PyTorch/CUDA port (metadrive_ped_torch).

bench.py's protocol on one GPU: the same seven env families at the same
configs and default widths, full-throttle action on every row, one untimed
`rollout` (it warms up and builds the kernel at first use), then one timed
`rollout` between `torch.cuda.synchronize()` calls; the rate is rows x
steps / seconds (agent rows in the multi-agent families).

    python3 bench_torch.py [--quick] [--config all|pg|...] [--device cpu]

Prints the card's name and power limit (nvidia-smi), one JSON line per
family (rows, steps, seconds, rate, the ray-segment kernel's launches
during the timed call, and ``graph``: whether every step of the timed call
was a CUDA-graph replay, metadrive_ped_torch/core/graph.py), and last
bench.py's line:
{"metric", "value": <pg>, "unit", "vs_baseline", "configs": {...}}, where
vs_baseline is against the reference's ~1500 env-steps/s in one process
(documentation/source/index.rst:18). It runs on the GPU and raises without
one unless --device cpu is given; a family that fails raises.
"""
import argparse
import json
import subprocess
import tempfile
import time

import numpy as np

REFERENCE_FPS = 1500.0  # the reference's single-process speed
FAMILIES = ("pg", "safe", "marl", "marl_40", "scenario", "scenario_replay", "scenario_recorded")
DEFAULT_RUN = FAMILIES[:-1]
# bench.py's default widths: pg at 8192 envs, safe and the Waymo-scale
# scenario families at 4096, marl 512 envs x 8 agents, marl_40 256 x 40,
# scenario_recorded (small PG exports) at 1024
DEFAULT_ENVS = dict(pg=8192, safe=4096, marl=512, marl_40=256, scenario=4096,
                    scenario_replay=4096, scenario_recorded=1024)
RECORDED_STEPS = 100


def make_env(family, num_envs, scenarios, device=None):
    """One env of a bench family on ``device`` (CUDA unless the caller asks
    for another)."""
    import metadrive_ped_torch as port
    if family == "pg":
        return port.MetaDriveEnv(dict(num_envs=num_envs, map=3, num_scenarios=scenarios,
                                      traffic_density=0.05, horizon=1000), device=device)
    if family == "safe":
        return port.SafeMetaDriveEnv(dict(num_envs=num_envs, num_scenarios=scenarios,
                                          horizon=1000), device=device)
    if family == "marl":
        # 8 agents an env (the class default is the reference's 40)
        return port.MultiAgentRoundaboutEnv(dict(num_envs=num_envs, num_agents=8), device=device)
    if family == "marl_40":
        # the reference's default roundabout crowd (marl_inout_roundabout.py:23)
        return port.MultiAgentRoundaboutEnv(dict(num_envs=num_envs), device=device)
    if family in ("scenario", "scenario_replay"):
        from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
        sds = [synthetic_waymo_sd(s) for s in range(scenarios)]
        if family == "scenario":
            # Waymo-scale synthetic scenes replayed with reactive IDM traffic
            return port.ScenarioEnv(dict(num_envs=num_envs, scenario_data=sds,
                                         reactive_traffic=True), device=device)
        # the reference's Waymo-replay FPS protocol
        # (tests/benchmark_FPS/benchmark_waymo.py:15-46): the ego replayed,
        # lidar 120 + side 160 + lane-line 12 lasers
        return port.ScenarioEnv(dict(
            num_envs=num_envs, scenario_data=sds, replay_ego=True,
            vehicle_config=dict(lidar=dict(num_lasers=120), side_detector=dict(num_lasers=160),
                                lane_line_detector=dict(num_lasers=12))), device=device)
    if family == "scenario_recorded":
        # small PG scenes exported by the port's own PG env and read back as a dataset
        from metadrive_ped_torch.scenario.recorder import export_scenarios
        from metadrive_ped_torch.scenario.utils import save_dataset
        src = port.MetaDriveEnv(dict(num_envs=scenarios, num_scenarios=scenarios, map=3,
                                     traffic_density=0.1), device=device)
        src.reset(seed=0)
        sds = list(export_scenarios(src, n_steps=RECORDED_STEPS).values())
        with tempfile.TemporaryDirectory() as d:
            save_dataset(sds, d)
            return port.ScenarioEnv(dict(num_envs=num_envs, num_scenarios=scenarios,
                                         data_directory=d, reactive_traffic=True), device=device)
    raise ValueError(family)


def measure(env, steps):
    """bench.py's timing of one env: reset, one untimed `rollout` (on the
    card it captures the step), one timed. Returns (rows, seconds,
    ray-segment kernel launches of the timed call, whether each of its
    steps replayed a graph)."""
    import torch

    from metadrive_ped_torch.ops import ray_segment
    sync = torch.cuda.synchronize if env.device.type == "cuda" else (lambda: None)
    env.reset(seed=0)
    # agent rows in the multi-agent families (num_envs is E*A after construction)
    rows = env.num_envs
    actions = np.tile(np.array([0.0, 1.0], np.float32), (rows, 1))
    env.rollout(steps, actions=actions)
    sync()
    ray_segment.launches = 0
    replays = env._graphs.replays if env._graphs is not None else 0
    t0 = time.perf_counter()
    env.rollout(steps, actions=actions)
    sync()
    seconds = time.perf_counter() - t0
    launches = ray_segment.launches
    graph = env._graphs is not None and env._graphs.replays - replays == steps
    env.close()
    return rows, seconds, launches, graph


def card_name_and_power():
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="small sizes for smoke testing")
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--scenarios", type=int, default=None)
    p.add_argument("--density", type=float, default=0.05, help="parsed and unused, as in bench.py")
    p.add_argument("--config", default="all", choices=("all",) + FAMILIES,
                   help="env family; 'all' measures every family but scenario_recorded "
                        "(value = the pg number)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Run the benchmark; returns bench.py's line as a dict."""
    from metadrive_ped_torch.core.device import resolve_device
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(card_name_and_power() if device.type == "cuda" else "cpu", flush=True)
    steps = args.steps or (30 if args.quick else 200)
    scenarios = args.scenarios or (4 if args.quick else 16)
    families = DEFAULT_RUN if args.config == "all" else (args.config,)

    results = {}
    for fam in families:
        quick_envs = 64 if fam == "marl_40" else 256
        num_envs = args.num_envs or (quick_envs if args.quick else DEFAULT_ENVS[fam])
        env = make_env(fam, num_envs, scenarios, device)
        rows, seconds, launches, graph = measure(env, steps)
        rate = rows * steps / seconds
        print(json.dumps(dict(family=fam, device=str(device), num_envs=num_envs, rows=rows,
                              scenarios=scenarios, steps=steps, seconds=seconds, rate=rate,
                              unit="agent-steps/s" if fam.startswith("marl") else "env-steps/s",
                              ray_segment_launches=launches, graph=graph)), flush=True)
        results[fam] = round(rate, 1)

    lead = families[0] if args.config != "all" else "pg"
    out = {
        "metric": "env_steps_per_s_1chip" if lead == "pg" else f"env_steps_per_s_1chip_{lead}",
        "value": results[lead],
        "unit": "env-steps/s" if lead != "marl" else "agent-steps/s",
        "vs_baseline": round(results[lead] / REFERENCE_FPS, 2),
    }
    if len(results) > 1:
        # marl and marl_40 count agent-steps/s, the rest env-steps/s
        out["configs"] = results
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
