"""CameraMetaDriveEnv — the PG env with the camera observation
(``image_observation=True``): the reference of a camera deployment.

The reference `MetaDriveEnv` refuses ``image_observation``; this class
builds it with the flag off and sets it again after, then renders the image
source's frame of every stepped state (ops/camera.py, op by op) and rolls
the frame stack [E, H, W, C, stack_size], newest last, as upstream's
ImageObservation.observe does: at `reset` the stack starts from zeros, and
in `step` and every step of the eager `rollout` it rolls by one, across
auto-resets. `rollout` collects the stack as ``"image"``. The mini map
(``image_source`` of modality "mini_map") is not carried.
"""
import torch

from benchmarks.reference.core.structs import tree_map
from benchmarks.reference.envs.metadrive_env import MetaDriveEnv
from benchmarks.reference.ops import camera


class CameraMetaDriveEnv(MetaDriveEnv):

    def __init__(self, config=None, device=None):
        config = dict(config or {})
        image = bool(config.pop("image_observation", False))
        super().__init__(config, device=device)
        self.config["image_observation"] = image
        self._img_stack = None
        if image and self._sensor_spec()[0] == "mini_map":
            raise ValueError("the reference carries no mini map")

    def _sensor_spec(self):
        cfg = self.config
        modality, w, h = cfg["sensors"][cfg["image_source"]]
        return str(modality), int(w), int(h)

    def _frame(self, state):
        """The image source's frame [E, H, W, C] of ``state``: float32 in
        [0, 1], or without norm_pixel uint8, frame * 255 truncated."""
        modality, w, h = self._sensor_spec()
        targets, _ = self._lidar_targets(state)
        cam = self.config["camera"]
        frame = camera.render(
            self.scene, state.sidx, state.ego, targets, self._target_slices,
            self.scene.obj_kind[state.sidx.long()], width=w, height=h, fov_deg=cam["fov"],
            pitch_deg=cam["pitch"], cam_height=cam["height"], max_dist=cam["max_dist"])[modality]
        return frame if self.config["norm_pixel"] else (frame * 255).to(torch.uint8)

    def _rolled(self, stack, state):
        frame = self._frame(state)
        if stack is None:
            stack = frame.new_zeros(frame.shape + (self.config["stack_size"],))
        return torch.cat([stack[..., 1:], frame[..., None]], dim=-1)

    def _frame_obs(self, obs, terminated=None, truncated=None, graphs=None):
        """{"image": the frame stack, "state": obs}; the stack starts from
        zeros at reset (no done flags)."""
        if not self.config["image_observation"]:
            return obs
        if terminated is None:
            self._img_stack = None
        self._img_stack = self._rolled(self._img_stack, self._state)
        return {"image": self._img_stack, "state": obs}

    def _rollout_eager(self, n_steps, policy_fn=None, actions=None, collect=("reward",)):
        """The base class's eager loop, with the frame of every step's state
        rendered and the stack rolled; ``"image"`` collects the stack."""
        if not self.config["image_observation"]:
            return super()._rollout_eager(n_steps, policy_fn, actions, collect)
        fixed = self._fixed_actions(actions)
        state, obs = self._state, self._last_obs
        outs = {k: [] for k in collect}
        for _ in range(n_steps):
            act = policy_fn(obs, state) if policy_fn is not None else fixed
            state, obs, reward, term, trunc, info = self._step_impl(state, act)
            self._img_stack = self._rolled(self._img_stack, state)
            special = dict(reward=reward, obs=obs, terminated=term, truncated=trunc,
                           image=self._img_stack, **self._rollout_fields(state))
            for k in collect:
                outs[k].append(special[k] if k in special else info[k])
        self._state, self._last_obs = state, obs
        outs = {k: tree_map(lambda *xs: torch.stack(xs), *v) for k, v in outs.items()}
        mean_reward = float(outs["reward"].mean()) if "reward" in outs else 0.0
        return outs, mean_reward
