"""Drive MetaDriveEnv with the built-in PPO expert
(reference: examples/drive_in_single_agent_env.py, which drives one windowed
env manually; headless here, batched, expert-driven).

    python -m metadrive_ped_torch.examples.drive_in_single_agent_env [--cpu] [--render OUT.png]
"""
import argparse

from metadrive_ped_torch.examples import example_device, force_cpu_flag, save_image


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-envs", "-e", default=16, type=int)
    parser.add_argument("--steps", "-n", default=1500, type=int)
    parser.add_argument("--render", metavar="OUT.png", default=None,
                        help="save a top-down frame of env 0 at the end")
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.policies.expert import make_expert_policy

    env = MetaDriveEnv(dict(
        num_envs=args.num_envs, map=7, num_scenarios=20, traffic_density=0.1,
        vehicle_config=dict(lidar=dict(num_lasers=240, num_others=4)),
    ), device=device)
    env.reset(seed=0)
    outs, mean_reward = env.rollout(args.steps, policy_fn=make_expert_policy(device=device),
                                    collect=("reward", "arrive_dest", "terminated"))
    term = outs["terminated"]
    print(f"{args.num_envs} envs x {args.steps} steps with the PPO expert")
    print(f"mean step reward: {mean_reward:.4f}")
    print(f"episodes finished: {int(term.sum())}, "
          f"at destination: {int((term & outs['arrive_dest']).sum())}")
    print(f"total reward collected: {float(outs['reward'].sum()):.1f}")
    if args.render:
        print("wrote", save_image(env.render("topdown"), args.render))
    return outs


if __name__ == "__main__":
    main()
