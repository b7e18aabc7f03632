"""metadrive_ped_torch — the PyTorch/CUDA port of metadrive_ped_tpu.

Same design as the JAX package: all per-object state lives in dataclasses
of tensors batched over an env axis ``[E, ...]`` on one device, and one
``step`` advances every environment in lockstep. Maps are compiled on the
host (numpy) into fixed-size scene packs. The detector clouds run on a
hand-written CUDA kernel (csrc/ray_segment.cu) on the GPU. `ScenarioEnv`
replays logged ScenarioDescriptions (scenario/); the multi-agent envs fold
their agents into rows and take and give ``[E, A, ...]`` arrays.
`MixedTrafficEnv` drives a share of the NPCs with the PPO expert
(policies/expert.py), and `CurriculumWrapper` widens an env's scenario band
as its success rate grows. `MixWaymoPGEnv` alternates scenario replay and
PG episodes between resets; `createGymWrapper` gives any env class the
legacy gym API. The PG and multi-agent envs carry gymnasium spaces,
fault injection (`set_break_down`) and snapshot/record/replay. The
top-down envs (`TopDownMetaDrive` and its variants) observe a BEV raster;
``image_observation=True`` gives any PG env a camera or mini-map frame
stack beside the state vector, and `env.render` draws a frame of one env.

    >>> from metadrive_ped_torch import MetaDriveEnv
    >>> env = MetaDriveEnv(dict(num_envs=1024, map="SCS"), device="cuda")
    >>> obs, info = env.reset(seed=0)
    >>> obs, reward, terminated, truncated, info = env.step(actions)
"""
from metadrive_ped_torch.envs.curriculum import CurriculumWrapper
from metadrive_ped_torch.envs.gym_wrapper import createGymWrapper
from metadrive_ped_torch.envs.marl_envs import (
    MultiAgentBidirectionEnv, MultiAgentBottleneckEnv, MultiAgentIntersectionEnv,
    MultiAgentMetaDrive, MultiAgentParkingLotEnv, MultiAgentRacingEnv, MultiAgentRoundaboutEnv,
    MultiAgentTinyInter, MultiAgentTollgateEnv,
)
from metadrive_ped_torch.envs.metadrive_env import MetaDriveEnv
from metadrive_ped_torch.envs.mix_waymo_pg_env import MixWaymoPGEnv
from metadrive_ped_torch.envs.mixed_traffic_env import MixedTrafficEnv
from metadrive_ped_torch.envs.safe_metadrive_env import SafeMetaDriveEnv
from metadrive_ped_torch.envs.scenario_env import ScenarioEnv
from metadrive_ped_torch.envs.top_down_env import (
    TopDownMetaDrive, TopDownMetaDriveEnvV2, TopDownSingleFrameMetaDriveEnv,
)
from metadrive_ped_torch.envs.varying_dynamics_env import VaryingDynamicsEnv
from metadrive_ped_torch.version import VERSION, __version__

__all__ = [
    "MetaDriveEnv", "SafeMetaDriveEnv", "VaryingDynamicsEnv", "ScenarioEnv", "MixedTrafficEnv",
    "CurriculumWrapper", "MixWaymoPGEnv", "createGymWrapper",
    "TopDownSingleFrameMetaDriveEnv", "TopDownMetaDrive", "TopDownMetaDriveEnvV2",
    "MultiAgentMetaDrive", "MultiAgentRoundaboutEnv", "MultiAgentIntersectionEnv",
    "MultiAgentBottleneckEnv", "MultiAgentBidirectionEnv", "MultiAgentTollgateEnv",
    "MultiAgentParkingLotEnv", "MultiAgentRacingEnv", "MultiAgentTinyInter",
    "VERSION", "__version__",
]
