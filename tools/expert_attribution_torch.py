"""Expert failure attribution on random PG maps, with the PyTorch/CUDA port.

The vendored PPO expert (metadrive_ped_torch/policies/expert.py, actions
clipped to [-1, 1]) drives every env of a PG batch. This script splits every
episode end by cause (success / crash_vehicle / out_of_road / timeout) per
seed and traffic density, and names the block sequence of each failing
seed (maps are seed-exact, so the block string identifies the geometry the
expert fails on).

Reference protocol analog: tests/test_policy/test_expert_performance.py:37-41
drives the expert over a traffic grid and asserts aggregate success; this
adds the attribution that the test's single number hides.

    python3 tools/expert_attribution_torch.py [--seeds 16] [--envs 64] [--device cpu]

It runs on the GPU and raises without one unless --device cpu is given.
"""
import argparse
import os
import sys
from collections import Counter, defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAUSES = ("success", "crash_vehicle", "out_of_road", "timeout")
COLLECT = ("terminated", "truncated", "arrive_dest", "crash_vehicle", "out_of_road", "env_seed")


def attribute(terminated, truncated, arrive_dest, crash_vehicle, out_of_road, env_seed):
    """Episode ends by cause, from [steps, envs] arrays of a rollout: each
    step where an env terminated or truncated is one episode, counted as
    success if it arrived, else crash_vehicle if it crashed into a vehicle,
    else out_of_road if it left the road, else timeout. Returns (the totals
    by cause, the counts by cause of each env seed)."""
    term = np.asarray(terminated) | np.asarray(truncated)
    cause = np.where(np.asarray(arrive_dest), 0,
                     np.where(np.asarray(crash_vehicle), 1,
                              np.where(np.asarray(out_of_road), 2, 3)))
    seeds = np.asarray(env_seed)
    tot, per_seed = Counter(), defaultdict(Counter)
    for t, e in zip(*np.nonzero(term)):
        c = CAUSES[cause[t, e]]
        tot[c] += 1
        per_seed[int(seeds[t, e])][c] += 1
    return tot, per_seed


def block_names(seeds, map_cfg):
    """The block string of each seed's map (the first block left out)."""
    from metadrive_ped_torch.mapgen.big import generate_map
    names = {}
    for s in seeds:
        _, blks = generate_map(s, dict(config=map_cfg, lane_width=3.5, lane_num=3,
                                       exit_length=50.0))
        names[s] = "".join(b.ID for b in blks[1:])
    return names


def report(density, tot, per_seed, blocks):
    """The report of one density, as lines."""
    n = sum(tot.values())
    lines = [f"\n== density {density}: {n} episodes =="]
    for c in CAUSES:
        lines.append(f"  {c:14s} {tot[c]:4d}  ({tot[c] / max(n, 1):.1%})")
    lines.append("  worst seeds (success rate | blocks | cause mix):")
    rows = sorted(per_seed.items(),
                  key=lambda kv: kv[1]["success"] / max(sum(kv[1].values()), 1))
    for s, cnt in rows[:8]:
        sr = cnt["success"] / max(sum(cnt.values()), 1)
        mix = " ".join(f"{k}:{v}" for k, v in cnt.items() if k != "success")
        lines.append(f"    seed {s:3d}  {sr:.2f}  {blocks.get(s, '?'):10s}  {mix}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16, help="num_scenarios")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--density", type=float, nargs="*", default=[0.0, 0.05, 0.1])
    ap.add_argument("--map", default="3")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.core.device import resolve_device
    from metadrive_ped_torch.policies.expert import expert_action, load_expert_params

    device = resolve_device(args.device)
    params = load_expert_params(device=device)
    pol = lambda obs, state: torch.clamp(expert_action(params, obs), -1, 1)
    map_cfg = int(args.map) if args.map.isdigit() else args.map

    results = {}
    for density in args.density:
        env = MetaDriveEnv(dict(
            num_envs=args.envs, map=map_cfg, num_scenarios=args.seeds,
            traffic_density=density, horizon=1000,
            vehicle_config=dict(lidar=dict(num_lasers=240, num_others=4)),
        ), device=device)
        env.reset(seed=0)
        outs, _ = env.rollout(args.steps, policy_fn=pol, collect=COLLECT)
        tot, per_seed = attribute(*(outs[k].cpu().numpy() for k in COLLECT))
        print("\n".join(report(density, tot, per_seed, block_names(per_seed, map_cfg))),
              flush=True)
        results[density] = (tot, per_seed)
        env.close()
    return results


if __name__ == "__main__":
    main()
