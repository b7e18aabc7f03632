"""PPO expert policy (batched torch forward).

Architecture of the reference numpy expert
(metadrive/examples/ppo_expert/numpy_expert.py:1-80): 275 -> 256 -> 256 ->
4 with tanh activations; the output splits into (mean, log_std); the obs
correction flips dims 10 and 15 (a coordinate-convention fix). The
reference's released checkpoint is read from the raw file that the program
ships, metadrive_ped_torch/assets/expert_weights.npz (both sides read the
same file; nothing of the program is imported); a missing checkpoint is a hard error unless zero-init is asked
for explicitly (allow_zero_init=True).

The three products are plain float32 `torch.matmul`s. On the card they run
in full float32 only while `torch.get_float32_matmul_precision()` is
"highest" (PyTorch's default, no TF32), which the 1e-4 parity of the
expert-driven paths needs.
"""
import os

import numpy as np
import torch

from benchmarks.reference.core import prng
from benchmarks.reference.core.device import resolve_device
from benchmarks.reference.core.logger import get_logger

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
VENDORED_WEIGHTS = os.path.join(_CHECKOUT, "metadrive_ped_torch", "assets", "expert_weights.npz")
OBS_DIM = 275
# parameter name -> array name in the checkpoint
_CHECKPOINT_KEYS = dict(
    w1="default_policy/fc_1/kernel", b1="default_policy/fc_1/bias",
    w2="default_policy/fc_2/kernel", b2="default_policy/fc_2/bias",
    w3="default_policy/fc_out/kernel", b3="default_policy/fc_out/bias",
)


def params_from_arrays(arrays, device):
    """The expert's parameters as float32 tensors on ``device`` from the
    checkpoint's arrays (an opened npz, or any mapping of its names)."""
    return {k: torch.as_tensor(np.asarray(arrays[name], np.float32)).to(device)
            for k, name in _CHECKPOINT_KEYS.items()}


def load_expert_params(path=None, allow_zero_init=False, device=None):
    """dict of tensors (w1, b1, w2, b2, w3, b3) from ``path`` or the vendored
    checkpoint, on ``device`` (CUDA unless the caller asks for another).

    Raises FileNotFoundError when the checkpoint is missing, unless
    allow_zero_init=True (action = straight coast, smoke-driving only)."""
    device = resolve_device(device)
    path = path or VENDORED_WEIGHTS
    if os.path.exists(path):
        with np.load(path) as w:
            return params_from_arrays(w, device)
    if not allow_zero_init:
        raise FileNotFoundError(
            f"expert_weights.npz not found at {path}; pass allow_zero_init=True for an "
            "explicit zero-initialized smoke policy"
        )
    get_logger().warning(
        "expert weights zero-initialized (allow_zero_init=True): the policy coasts straight; "
        "the checkpoint was not loaded", extra={"log_once": True},
    )
    zeros = lambda *shape: torch.zeros(shape, device=device)
    return dict(w1=zeros(OBS_DIM, 256), b1=zeros(256), w2=zeros(256, 256), b2=zeros(256),
                w3=zeros(256, 4), b3=zeros(4))


def obs_correction(obs):
    """Flip dims 10 and 15 (numpy_expert.py:36-40); ``obs`` is not changed."""
    x = obs.clone()
    x[..., 15] = 1.0 - obs[..., 15]
    x[..., 10] = 1.0 - obs[..., 10]
    return x


def expert_forward(params, obs):
    """Batched expert MLP: obs [B, 275] -> (mean [B, 2], log_std [B, 2])."""
    x = obs_correction(obs)
    x = torch.tanh(x @ params["w1"] + params["b1"])
    x = torch.tanh(x @ params["w2"] + params["b2"])
    x = x @ params["w3"] + params["b3"]
    return x[..., :2], x[..., 2:]


def expert_action(params, obs, rng=None, deterministic=True):
    """Batched expert forward: obs [B, 275] -> actions [B, 2]; with
    ``deterministic=False`` and a key ``rng`` the mean plus exp(log_std)
    times a normal draw of `prng.normal`."""
    mean, log_std = expert_forward(params, obs)
    if deterministic or rng is None:
        return mean
    return mean + torch.exp(log_std) * prng.normal(rng, tuple(mean.shape))


def make_expert_policy(path=None, deterministic=True, device=None):
    """policy_fn(obs, state) -> actions for `rollout`."""
    params = load_expert_params(path, device=device)

    def policy_fn(obs, state):
        return expert_action(params, obs, deterministic=deterministic)

    return policy_fn
