"""The CUDA kernel on the card: it builds, agrees with its plain version,
counts its launches, and carries the env's detector clouds. These tests
need an NVIDIA GPU with nvcc and skip elsewhere. On the card, where JAX is
not installed, run them without tests/conftest.py (which imports jax):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _case(E, R, B, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *s: torch.rand(*s, device="cuda", generator=g)
    ang = u(E, R) * 2 * math.pi
    p0 = (u(E, B, 2) - 0.5) * 60
    return ((u(E, 2) - 0.5) * 10, torch.cos(ang), torch.sin(ang), p0,
            p0 + (u(E, B, 2) - 0.5) * 20, u(E, B) > 0.2)


@pytest.mark.parametrize("E,R,B", [(64, 160, 540), (33, 12, 1), (7, 300, 777), (129, 160, 1500)])
def test_kernel_matches_plain(cuda, E, R, B):
    from metadrive_ped_torch.ops import ray_segment as rs
    origin, dx, dy, p0, p1, valid = _case(E, R, B, seed=E)
    before = rs.launches
    out = rs.ray_segment_sweep(origin, dx, dy, 50.0, p0, p1, valid)
    ref = rs.ray_segment_fraction(origin, None, 50.0, p0, p1, valid, dirs=(dx, dy))
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-5
    assert bool((out < 1).any())


def test_kernel_rejects_what_it_cannot_take(cuda):
    from metadrive_ped_torch.ops import ray_segment as rs
    origin, dx, dy, p0, p1, valid = _case(4, 8, 16, seed=1)
    with pytest.raises(ValueError):
        rs.ray_segment_sweep(origin, dx, dy, 50.0, p0.double(), p1, valid)
    with pytest.raises(ValueError):
        rs.ray_segment_sweep(origin, dx.t().contiguous().t(), dy, 50.0, p0, p1, valid)


def test_env_steps_through_the_kernel(cuda):
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import ray_segment as rs
    env = MetaDriveEnv(dict(num_envs=64, map="SCS", num_scenarios=2, traffic_density=0.1,
                            vehicle_config=dict(side_detector=dict(num_lasers=16),
                                                lane_line_detector=dict(num_lasers=6))),
                       device="cuda")
    rs.launches = 0
    env.reset(seed=0)
    act = torch.tensor([[0.0, 1.0]] * 64, device="cuda")
    for _ in range(10):
        obs, *_ = env.step(act)
    assert rs.launches == 2 * 10 + 2
    assert bool(torch.isfinite(obs).all())
