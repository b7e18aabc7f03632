from benchmarks.reference.envs.marl_envs.marl_env import MultiAgentRoundaboutEnv

__all__ = ["MultiAgentRoundaboutEnv"]
