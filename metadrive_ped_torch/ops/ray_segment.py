"""Ray-vs-segment min-hit sweep: the plain version and the CUDA kernel's
wrapper (the counterpart of metadrive_ped_tpu/ops/pallas_raycast.py).

The side and lane-line detector clouds reduce [E, R, B] ray-segment
intersections to per-ray min hit fractions [E, R]. `ray_segment_fraction`
is the plain torch version; `ray_segment_sweep` is the wrapper of the
hand-written kernel in csrc/ray_segment.cu. The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
"""
import ctypes

import torch

from metadrive_ped_torch.core import cuda_build

# launches of the kernel since the last reset (set to 0 to start counting)
launches = 0


def ray_segment_fraction(origin, angles, max_dist, p0, p1, valid, dirs=None):
    """Min hit fraction of rays against 2D segments, plain torch (the
    side/lane-line detectors' rayTestClosest against lane-line ghosts,
    distance_detector.py:27-85 + SideDetector :194).

    origin [E,2]; angles [E,R] (or unit directions ``dirs`` = (dx, dy));
    p0/p1 [E,B,2]; valid [E,B] -> [E,R].
    """
    dx0, dy0 = dirs if dirs is not None else (torch.cos(angles), torch.sin(angles))
    dx = dx0[:, :, None]              # [E,R,1]
    dy = dy0[:, :, None]
    ax = p0[..., 0][:, None, :]       # [E,1,B]
    ay = p0[..., 1][:, None, :]
    sx = (p1[..., 0] - p0[..., 0])[:, None, :]
    sy = (p1[..., 1] - p0[..., 1])[:, None, :]
    ox = origin[:, 0][:, None, None]
    oy = origin[:, 1][:, None, None]
    # solve o + t*d = a + u*s
    denom = dx * sy - dy * sx
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    rel_x = ax - ox
    rel_y = ay - oy
    t = (rel_x * sy - rel_y * sx) / denom
    u = (rel_x * dy - rel_y * dx) / denom
    hit = (t >= 0) & (u >= 0) & (u <= 1) & valid[:, None, :]
    frac = torch.where(hit, torch.clamp(t / max_dist, 0.0, 1.0), 1.0)
    return frac.amin(dim=2)


def _kernel_lib():
    lib = cuda_build.library("ray_segment")
    fn = lib.ray_segment_launch
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_float, ptr, ptr, ptr, ptr,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ray_segment_sweep(origin, dx, dy, max_dist, p0, p1, valid):
    """Min hit fraction [E,R] of rays (origin [E,2], unit directions dx/dy
    [E,R]) against segments p0/p1 [E,B,2] masked by valid [E,B].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    if origin.device.type == "cpu":
        return ray_segment_fraction(origin, None, max_dist, p0, p1, valid, dirs=(dx, dy))
    if origin.device.type != "cuda":
        raise ValueError(f"ray_segment_sweep runs on cpu or cuda, not {origin.device}")
    E, R = dx.shape
    B = p0.shape[1]
    dev = origin.device
    _check("origin", origin, dev, torch.float32, (E, 2))
    _check("dx", dx, dev, torch.float32, (E, R))
    _check("dy", dy, dev, torch.float32, (E, R))
    _check("p0", p0, dev, torch.float32, (E, B, 2))
    _check("p1", p1, dev, torch.float32, (E, B, 2))
    _check("valid", valid, dev, torch.bool, (E, B))
    if p0.data_ptr() % 8 or p1.data_ptr() % 8:
        raise ValueError("p0/p1 must be 8-byte aligned (read as float2)")
    out = torch.empty((E, R), dtype=torch.float32, device=dev)
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(origin.data_ptr(), dx.data_ptr(), dy.data_ptr(), float(max_dist),
                 p0.data_ptr(), p1.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 E, R, B, stream)
    if err != 0:
        raise RuntimeError(f"ray_segment kernel launch failed: cudaError {err}")
    launches += 1
    return out
