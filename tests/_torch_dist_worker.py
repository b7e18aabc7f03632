"""One rank of the two-process gloo run of
tests/test_torch_parallel.py::test_two_process_distributed.

    python tests/_torch_dist_worker.py RANK WORLD_SIZE file:///path/to/fresh/store

The rank joins the group through `parallel.init_distributed` (60 s
timeout), steps its own PG batch over its stride of the scenario set
(worker_index = rank, num_workers = world size), all-gathers each rank's
mean reward and prints one RESULT line: rank, world size, its scenario
seeds, its mean reward, the gathered mean rewards.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    rank, world, init_method = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np
    import torch
    import torch.distributed as dist

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.parallel import init_distributed

    rank, world = init_distributed(init_method, world, rank, backend="gloo", timeout=60)
    try:
        env = MetaDriveEnv(dict(num_envs=8, map="S", num_scenarios=4, traffic_density=0.0,
                                worker_index=rank, num_workers=world), device="cpu")
        env.reset(seed=rank)
        for _ in range(3):
            _, reward, _, _, info = env.step(np.tile([0.0, 1.0], (8, 1)))
        seeds = sorted(set(info["env_seed"].tolist()))
        mine = reward.mean().reshape(1)
        gathered = [torch.zeros(1) for _ in range(world)]
        dist.all_gather(gathered, mine)
        print("RESULT", rank, world, ",".join(map(str, seeds)), f"{float(mine):.6f}",
              ",".join(f"{float(g):.6f}" for g in gathered), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
