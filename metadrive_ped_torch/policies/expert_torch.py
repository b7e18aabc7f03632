"""The reference's torch entry point to the PPO expert
(metadrive/examples/ppo_expert/torch_expert.py:39-95), as thin names over
policies/expert.py: the same vendored checkpoint, the same 275 -> 256 ->
256 -> 4 tanh MLP and obs correction (flip dims 10 and 15), batched over
the env axis."""
import numpy as np
import torch

from metadrive_ped_torch.policies.expert import _CHECKPOINT_KEYS, expert_forward, load_expert_params


def load_torch_expert_weights(path=None, device=None):
    """The checkpoint as tensors keyed by its array names
    (numpy_to_torch, torch_expert.py:21-33), on ``device`` (CUDA unless
    the caller asks for another)."""
    params = load_expert_params(path, device=device)
    return {name: params[k] for k, name in _CHECKPOINT_KEYS.items()}


def torch_expert_action(obs, deterministic=True, path=None, device=None):
    """Batched expert forward: obs [E, 275] (numpy or tensor) -> actions
    [E, 2] numpy (torch_expert, torch_expert.py:39-95, without the
    per-vehicle observe). With ``deterministic=False`` the mean is
    perturbed by exp(log_std) times a standard normal draw."""
    params = load_expert_params(path, device=device)
    dev = params["w1"].device
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(obs), dtype=torch.float32).to(dev)
        mean, log_std = expert_forward(params, x if x.ndim > 1 else x[None])
        if not deterministic:
            mean = mean + torch.exp(log_std) * torch.randn_like(mean)
        return mean.cpu().numpy()
