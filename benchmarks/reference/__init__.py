"""A frozen copy of the plain PyTorch and NumPy modules of
metadrive_ped_torch that the benchmark's envs run: the PG env, its mixed
traffic, the multi-agent roundabout, the host map compiler and the ops.

It is the reference that decides a run's ``correct``. It imports nothing
of the program: it steps op by op on any device (no CUDA graph) and
computes the detector clouds by their plain version (no hand kernel). It
rebuilds the map pack and the state from the config and the seed that the
benchmark hands both sides. It was copied from the program, which the
repository's tests hold against the JAX package, and is not edited when
the program changes: the program is held to it.
"""
from benchmarks.reference.envs.marl_envs import MultiAgentRoundaboutEnv
from benchmarks.reference.envs.metadrive_env import MetaDriveEnv
from benchmarks.reference.envs.mixed_traffic_env import MixedTrafficEnv

__all__ = ["MetaDriveEnv", "MixedTrafficEnv", "MultiAgentRoundaboutEnv"]
