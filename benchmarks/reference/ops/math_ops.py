"""Small batched math helpers (elementwise)."""
import math

import torch


def wrap_to_pi(x):
    """Wrap radians to (-pi, pi] (reference: metadrive/utils/math.py:29-41)."""
    x = x % (2.0 * math.pi)
    return x - 2.0 * math.pi * (x > math.pi)


def clip01(x):
    return torch.clamp(x, 0.0, 1.0)


def heading_vec(theta):
    """Unit heading vector(s); stacks on the last axis."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def rhs_vec(theta):
    """Right-hand-side unit vector of a heading (x-forward frame where the
    right-hand perpendicular of (dx,dy) is (dy,-dx) — matches the reference's
    direction_lateral convention, straight_lane.py:46)."""
    return torch.stack([torch.sin(theta), -torch.cos(theta)], dim=-1)
