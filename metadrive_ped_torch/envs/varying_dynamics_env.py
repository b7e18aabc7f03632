"""VaryingDynamicsEnv — per-episode randomized ego dynamics.

The reference's metadrive/envs/varying_dynamics_env.py:14-60: each episode
draws engine/brake/steering/mass/friction from the configured ranges. The
draw happens in the spawn from the per-env random key, so an auto-reset
draws anew, as the reference resamples per seed."""
from metadrive_ped_torch.envs.metadrive_env import MetaDriveEnv


class VaryingDynamicsEnv(MetaDriveEnv):
    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(
            dict(
                random_dynamics=dict(
                    max_engine_force=(100.0, 3000.0),
                    max_brake_force=(20.0, 600.0),
                    wheel_friction=(0.1, 2.5),
                    max_steering=(10.0, 80.0),
                    mass=(300.0, 3000.0),
                )
            )
        )
        return config
