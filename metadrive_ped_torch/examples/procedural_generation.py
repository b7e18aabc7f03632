"""Procedural map generation demo: compile scenes, dump and reload a map
pack (reference: examples/procedural_generation.py renders BIG maps; here
the artifact is the compiled scene pack).

    python -m metadrive_ped_torch.examples.procedural_generation [--cpu]
"""
import argparse
import os
import tempfile

import numpy as np

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-maps", default=8, type=int)
    parser.add_argument("--blocks", default=5, type=int)
    force_cpu_flag(parser)
    args = parser.parse_args(argv)
    device = example_device(args)

    from metadrive_ped_torch import MetaDriveEnv

    cfg = dict(num_envs=2, map=args.blocks, num_scenarios=args.num_maps)
    env = MetaDriveEnv(cfg, device=device)
    pack = env._pack
    print(f"compiled {args.num_maps} maps of {args.blocks} blocks:")
    print(f"  lanes per scene:    {pack['lane_kind'].shape[1]}")
    print(f"  roads per scene:    {pack['road_lane0'].shape[1]}")
    print(f"  boundary segments:  {pack['seg_p0'].shape[1]}")
    with tempfile.TemporaryDirectory() as d:
        path = env.dump_all_maps(os.path.join(d, "maps.pkl"))
        size = os.path.getsize(path)
        env2 = MetaDriveEnv(dict(cfg, map_pack_file=path), device=device)
    for k in pack:
        np.testing.assert_array_equal(pack[k], env2._pack[k], err_msg=k)
    env2.reset(seed=0)
    print(f"  pack dump/reload OK ({size / 1e6:.2f} MB)")
    return size


if __name__ == "__main__":
    main()
