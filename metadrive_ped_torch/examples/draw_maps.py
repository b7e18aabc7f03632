"""Render top-down images of procedurally generated maps
(reference: examples/draw_maps.py draws 16 maps with matplotlib).

    python -m metadrive_ped_torch.examples.draw_maps [--cpu] [--num 4] [--out maps.png]
"""
import argparse

import numpy as np

from metadrive_ped_torch.examples import example_device, force_cpu_flag, save_image


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num", default=4, type=int, help="maps to draw")
    parser.add_argument("--blocks", default=3, type=int, help="blocks per map")
    parser.add_argument("--out", default="maps.png")
    parser.add_argument("--quick", action="store_true", help="two maps of two blocks")
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    if args.quick:
        args.num, args.blocks = 2, 2
    device = example_device(args)

    from metadrive_ped_torch import MetaDriveEnv

    env = MetaDriveEnv(dict(num_envs=args.num, map=args.blocks, num_scenarios=args.num,
                            traffic_density=0.0), device=device)
    env.reset(seed=0)
    grid = np.concatenate([env.render("topdown", env_index=i) for i in range(args.num)], axis=1)
    path = save_image(grid, args.out)
    print("wrote", path, grid.shape)
    return grid.shape


if __name__ == "__main__":
    main()
