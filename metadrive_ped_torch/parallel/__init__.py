from metadrive_ped_torch.parallel.mesh import ShardedEnv, init_distributed, make_mesh

__all__ = ["ShardedEnv", "make_mesh", "init_distributed"]
