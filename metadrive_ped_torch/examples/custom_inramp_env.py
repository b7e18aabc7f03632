"""Custom single-block (InRampOnStraight) environment
(reference: metadrive/examples/custom_inramp_env.py): a one-block "r" map
with a single lane, driven by the expert (the reference flips
expert_takeover; here the expert is the rollout policy, there is no
realtime window).

    python -m metadrive_ped_torch.examples.custom_inramp_env [--cpu]
"""
import argparse
import random

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--start-seed", type=int, default=None)
    force_cpu_flag(p)
    args = p.parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.policies.expert import expert_action, load_expert_params

    # the reference's "Solution 2" config: explicit block sequence + lane_num
    # (map_config type="block_sequence" config="r" == map="r")
    env = MetaDriveEnv(dict(
        num_envs=args.num_envs, map="r",
        map_config=dict(lane_num=1, lane_width=3.5, exit_length=50.0),
        start_seed=args.start_seed if args.start_seed is not None else random.randint(0, 1000),
        num_scenarios=1, traffic_density=0.1,
        vehicle_config=dict(lidar=dict(num_lasers=240, num_others=4)),
    ), device=device)
    obs, _ = env.reset(seed=0)
    print("The observation is an array with shape:", tuple(obs.shape))
    params = load_expert_params(device=device)
    outs, mean_r = env.rollout(
        args.steps, policy_fn=lambda o, s: torch.clamp(expert_action(params, o), -1, 1),
        collect=("reward", "terminated", "arrive_dest"))
    term = outs["terminated"]
    print(f"episodes finished: {int(term.sum())}, "
          f"successes: {int((term & outs['arrive_dest']).sum())}, "
          f"mean step reward: {mean_r:.3f}")
    env.close()
    return outs


if __name__ == "__main__":
    main()
