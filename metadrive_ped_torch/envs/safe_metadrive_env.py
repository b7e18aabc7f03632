"""SafeMetaDriveEnv — the safe-RL variant (vectorized).

The reference's config deltas (metadrive/envs/safe_metadrive_env.py:7-35):
dense accident scenes, crashes cost instead of terminating, per-episode
cost accounting (info["total_cost"], accumulated in SimState.episode_cost).
"""
from metadrive_ped_torch.envs.metadrive_env import MetaDriveEnv


class SafeMetaDriveEnv(MetaDriveEnv):
    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                num_scenarios=100,
                accident_prob=0.8,
                traffic_density=0.05,
                crash_vehicle_done=False,
                crash_object_done=False,
            )
        )
        return config
