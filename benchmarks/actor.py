"""The benchmark's seeded actor: a trainer's policy MLP, obs -> 256 -> 256
-> 2, tanh after each layer (the widths of the PPO example's policy), with
a fixed output bias (the traffic's ``actor_bias``: a throttle bias makes
every seed's cars drive, as a trained policy's do). It is the
benchmark's, not the program's: it hands the env its actions."""
import math

import torch


class Actor:
    """Weights drawn from ``seed`` on ``device``, one draw a layer, float32."""

    def __init__(self, obs_dim, seed, device, hidden=(256, 256), bias=(0.0, 0.0)):
        gen = torch.Generator(device=device).manual_seed(seed)
        dims = (obs_dim, *hidden, 2)
        self.layers = [(torch.randn((i, o), generator=gen, device=device) / math.sqrt(i),
                        torch.zeros(o, device=device)) for i, o in zip(dims[:-1], dims[1:])]
        self.layers[-1][1].copy_(torch.tensor(bias, dtype=torch.float32))

    def __call__(self, obs):
        x = obs
        for w, b in self.layers:
            x = torch.tanh(x @ w + b)
        return x
