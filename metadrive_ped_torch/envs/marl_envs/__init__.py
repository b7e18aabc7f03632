from metadrive_ped_torch.envs.marl_envs.marl_env import (
    MultiAgentBidirectionEnv, MultiAgentBottleneckEnv, MultiAgentIntersectionEnv,
    MultiAgentMetaDrive, MultiAgentRoundaboutEnv,
)
from metadrive_ped_torch.envs.marl_envs.marl_parking_lot import MultiAgentParkingLotEnv
from metadrive_ped_torch.envs.marl_envs.marl_racing import MultiAgentRacingEnv
from metadrive_ped_torch.envs.marl_envs.marl_tollgate import MultiAgentTollgateEnv
from metadrive_ped_torch.envs.marl_envs.tinyinter import MultiAgentTinyInter

__all__ = [
    "MultiAgentMetaDrive", "MultiAgentRoundaboutEnv", "MultiAgentIntersectionEnv",
    "MultiAgentBottleneckEnv", "MultiAgentBidirectionEnv", "MultiAgentTollgateEnv",
    "MultiAgentParkingLotEnv", "MultiAgentRacingEnv", "MultiAgentTinyInter",
]
