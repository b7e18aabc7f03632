"""Drive a multi-agent scene env
(reference: examples/drive_in_multi_agent_env.py: picks a MARL scene by
name and steps it). Obs, reward and done come back as [E, A, ...] tensors.

    python -m metadrive_ped_torch.examples.drive_in_multi_agent_env --env tollgate [--cpu]
"""
import argparse

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag

ENVS = dict(roundabout="MultiAgentRoundaboutEnv", intersection="MultiAgentIntersectionEnv",
            tollgate="MultiAgentTollgateEnv", bottleneck="MultiAgentBottleneckEnv",
            parkinglot="MultiAgentParkingLotEnv", bidirection="MultiAgentBidirectionEnv",
            racing="MultiAgentRacingEnv")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="roundabout", choices=tuple(ENVS))
    parser.add_argument("--steps", "-n", default=100, type=int)
    parser.add_argument("--num-envs", "-e", default=4, type=int)
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)

    import metadrive_ped_torch

    env = getattr(metadrive_ped_torch, ENVS[args.env])(dict(num_envs=args.num_envs),
                                                      device=device)
    obs, _ = env.reset(seed=0)
    E, A = obs.shape[:2]
    print(f"{args.env}: {A} agents x {E} envs, obs dim {obs.shape[-1]}")
    actions = torch.tensor([0.0, 0.5], device=device).expand(E, A, 2)
    total_r = torch.zeros((), device=device)
    dones = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(args.steps):
        obs, r, term, trunc, info = env.step(actions)
        total_r += r.sum()
        dones += info["__all__"].sum()
    print(f"total reward {float(total_r):.1f}, __all__ terminations {int(dones)}")
    return obs


if __name__ == "__main__":
    main()
