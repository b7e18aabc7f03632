"""Top-down (BEV) observation envs.

Reference: metadrive/envs/top_down_env.py:7-75 (TopDownSingleFrameMetaDriveEnv
returns one 84x84 frame; TopDownMetaDrive stacks frames). The map layers
are baked by the host rasterizer when the env is built; the per-step crop
runs on the env's device inside the step.
"""
import numpy as np
import torch

from metadrive_ped_torch.envs.metadrive_env import MetaDriveEnv
from metadrive_ped_torch.obs import top_down


class TopDownSingleFrameMetaDriveEnv(MetaDriveEnv):
    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(dict(frame_stack=1, resolution=84, max_distance=50.0),
                      allow_add_new_key=True)
        return config

    def __init__(self, config=None, device=None):
        super().__init__(config, device=device)
        self._map_textures()  # bake the map layers now, not in the first step

    @property
    def observation_dim(self):
        r = self.config["resolution"]
        return (r, r, top_down.CHANNELS)

    @property
    def observation_space(self):
        import gymnasium as gym
        return gym.spaces.Box(0.0, 1.0, shape=self.observation_dim, dtype=np.float32)

    def _observe(self, state, ego_long, ego_lat):
        return top_down.observe_top_down(
            *self._map_textures(), state.sidx, state.ego, state.npc,
            state.ego.past_pos, resolution=self.config["resolution"],
            max_distance=self.config["max_distance"])


class TopDownMetaDrive(TopDownSingleFrameMetaDriveEnv):
    """Multi-channel stacked BEV (reference TopDownMultiChannel,
    obs/top_down_obs_multi_channel.py:27-279 + envs/top_down_env.py:39-49):
    ``2 + frame_stack`` grayscale channels —

      0: road network (drivable area + lane lines, doubled intensity, with
         the ego route shaded in as the reference draws navigation onto the
         background canvas at gray 64)
      1: past ego positions, ego-frame dots
      2..: traffic flow at t, t-frame_skip, t-2*frame_skip, ... (newest
         first, _get_stack_indices order, :293-299)

    The traffic-flow history is a ring of the last (frame_stack - 1) *
    frame_skip + 1 frames on the device, newest last: it rolls every step,
    is cleared on `reset` (and refilled with the first frame), and the rows
    whose episode ended take the current frame in every slot
    (``_should_fill_stack``, :243-249). `rollout` returns the single-frame
    channels, as the JAX package's does."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config.update(dict(frame_stack=3, frame_skip=5, post_stack=5, max_distance=30.0),
                      allow_add_new_key=True)
        return config

    _ROW_AXES = dict(TopDownSingleFrameMetaDriveEnv._ROW_AXES, _tf_ring=1)

    def __init__(self, config=None, device=None):
        super().__init__(config, device=device)
        self._tf_ring = None  # [(frame_stack - 1) * frame_skip + 1, E, R, R]

    @property
    def observation_dim(self):
        r = self.config["resolution"]
        return (r, r, 2 + self.config["frame_stack"])

    def _assemble(self, frame, done=None):
        """The stacked observation [E, R, R, 2 + frame_stack] of a
        single-frame observation [E, R, R, 5]; ``done`` [E] marks the rows
        whose history restarts."""
        road = torch.clamp(frame[..., 0] * 2.0, 0.0, 1.0)
        road = torch.maximum(road, torch.clamp(frame[..., 1] * (64.0 / 255.0) * 2.0, 0.0, 1.0))
        tf = frame[..., 2]
        K, skip = self.config["frame_stack"], self.config["frame_skip"]
        buflen = (K - 1) * skip + 1
        if self._tf_ring is None:
            self._tf_ring = tf[None].expand(buflen, *tf.shape)
        ring = torch.cat([self._tf_ring[1:], tf[None]])
        if done is not None:
            ring = torch.where(done[None, :, None, None], tf[None], ring)
        self._tf_ring = ring
        # newest first: slots buflen-1, buflen-1-skip, ...
        chans = [road, frame[..., 4]] + [ring[buflen - 1 - i * skip] for i in range(K)]
        return torch.stack(chans, dim=-1)

    def _frame_obs(self, obs, terminated=None, truncated=None, graphs=None):
        if terminated is None:
            self._tf_ring = None
            return self._assemble(obs)
        return self._assemble(obs, terminated | truncated)


class TopDownMetaDriveEnvV2(TopDownMetaDrive):
    """reference envs/top_down_env.py:52-75: the multi-channel env with the
    lidar stripped from the vehicle config (the observation is image-only)."""

    @classmethod
    def default_config(cls):
        config = super().default_config()
        config["vehicle_config"]["lidar"].update(dict(num_lasers=0, distance=0.0))
        return config
