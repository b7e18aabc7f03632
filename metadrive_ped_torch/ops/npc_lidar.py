"""The per-NPC lidar of the expert traffic: the plain version, the fan
table and the CUDA kernel's wrapper.

Every NPC slot of an env casts the expert's ray fan against the env's
vehicles, the C candidates of `mixed_traffic.vehicle_candidates`: its N
slots, then the ego. Slot n does not see candidate n, itself.
`npc_lidar_plain` is the broadcast chain over [E*N, R, C] ray-box tests
through `raycast.lidar_cloud`, as the JAX package computes it
(metadrive_ped_tpu/ops/mixed_traffic.py, with jnp broadcasts: no TPU kernel).
`npc_lidar` computes the same cloud, in one launch of the hand-written
kernel in csrc/npc_lidar.cu for CUDA tensors, or by the plain version for
CPU tensors. On a CUDA tensor it launches the kernel or raises.
"""
import collections
import ctypes
import math
import sys

import torch

from metadrive_ped_torch.core import cuda_build, launches as launch_counts
from metadrive_ped_torch.ops import raycast
from metadrive_ped_torch.ops.ray_segment import _check

# launches of the kernel since the last reset (set to 0 to start counting),
# in all and by device index (clear to start counting); this module is the
# counter `core.launches.record` keeps, replays of a captured step included
launches = 0
launches_by_device = collections.Counter()

_FLT_MIN, _FLT_MAX = torch.finfo(torch.float32).tiny, torch.finfo(torch.float32).max


def npc_lidar_plain(pos, heading, length, width, active, num_slots, num_lasers, distance):
    """Plain torch version of `npc_lidar`: the candidates repeated for each
    slot, the slot itself masked out, and `raycast.lidar_cloud` over
    [E*N, num_lasers, C]."""
    E, C = active.shape
    N = num_slots
    rep = lambda a: a.repeat_interleave(N, dim=0)                        # [E,C] -> [E*N,C]
    not_self = ~torch.eye(N, C, dtype=torch.bool, device=pos.device)
    return raycast.lidar_cloud(
        pos[:, :N].reshape(E * N, 2), heading[:, :N].reshape(E * N), num_lasers, distance,
        rep(pos), rep(heading), rep(length), rep(width), rep(active) & not_self.repeat(E, 1),
    ).reshape(E, N, num_lasers)


def fan_table(num_rays, device):
    """cos and sin [R] of the fan angles 2*pi*i/R, as `raycast._fan_dirs`
    forms them at offset 0."""
    i = torch.arange(num_rays, dtype=torch.float32, device=device)
    phi = (2.0 * math.pi / num_rays) * i
    return torch.cos(phi), torch.sin(phi)


def _kernel_lib():
    lib = cuda_build.library("npc_lidar")
    fn = lib.npc_lidar_launch
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, f32, ptr, i32, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
    return fn


def npc_lidar(pos, heading, length, width, active, num_slots, num_lasers, distance):
    """The lidar cloud [E, N, num_lasers] of every NPC slot: the fraction of
    ``distance`` to the nearest other vehicle along each ray of its fan.

    pos [E,C,2]; heading, length, width [E,C] float32; active [E,C] bool:
    the C candidates of each env, the first ``num_slots`` = N of them its
    NPC slots, each the origin of one fan.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    (none when E*N or num_lasers is 0), on their own device's current
    stream, after torch computes the cos and sin of the headings and the
    fan table: every input must lie on pos's device."""
    if pos.device.type == "cpu":
        return npc_lidar_plain(pos, heading, length, width, active, num_slots, num_lasers,
                               distance)
    if pos.device.type != "cuda":
        raise ValueError(f"npc_lidar runs on cpu or cuda, not {pos.device}")
    if heading.dim() != 2:
        raise ValueError(f"heading must be [E, C], not {tuple(heading.shape)}")
    E, C = heading.shape
    N, R = int(num_slots), int(num_lasers)
    dev = pos.device
    _check("pos", pos, dev, torch.float32, (E, C, 2))
    for name, t in (("heading", heading), ("length", length), ("width", width)):
        _check(name, t, dev, torch.float32, (E, C))
    _check("active", active, dev, torch.bool, (E, C))
    if pos.data_ptr() % 8:
        raise ValueError("pos must be 8-byte aligned (read as float2)")
    if not (0 <= N <= C and R >= 0 and E * N < 2 ** 31):
        raise ValueError(f"need 0 <= num_slots <= C = {C}, num_lasers >= 0 and E * num_slots "
                         f"< 2**31; got num_slots {N}, num_lasers {R}, E {E}")
    if not (_FLT_MIN <= distance <= _FLT_MAX):
        raise ValueError(f"distance must be a positive normal float32, not {distance}")
    out = torch.empty((E, N, R), dtype=torch.float32, device=dev)
    if E * N == 0 or R == 0:
        return out
    cos_h, sin_h = torch.cos(heading), torch.sin(heading)
    cphi, sphi = fan_table(R, dev)
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pos.data_ptr(), cos_h.data_ptr(), sin_h.data_ptr(), length.data_ptr(),
                 width.data_ptr(), active.data_ptr(), cphi.data_ptr(), sphi.data_ptr(),
                 float(distance), out.data_ptr(), E, N, C, R, stream)
    if err != 0:
        raise RuntimeError(f"npc_lidar kernel launch failed: cudaError {err}")
    launch_counts.record(sys.modules[__name__], dev.index)
    return out
