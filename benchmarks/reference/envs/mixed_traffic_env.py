"""MixedTrafficEnv: PG driving with a share of expert-driven NPCs.

Reference: metadrive/envs/legacy_envs/mixed_traffic_env.py, a MetaDriveEnv
whose traffic manager is MixedPGTrafficManager: each spawned traffic
vehicle is driven by ExpertPolicy with probability ``rl_agent_ratio`` and
by IDMPolicy otherwise (manager/traffic_manager.py:367-418). The expert
slots' observations and actions come from ops/mixed_traffic.py.
"""
from benchmarks.reference.envs.metadrive_env import MetaDriveEnv


class MixedTrafficEnv(MetaDriveEnv):
    @classmethod
    def default_config(cls):
        config = super().default_config()
        config["rl_agent_ratio"] = 0.0  # opt-in, like the reference default
        return config
