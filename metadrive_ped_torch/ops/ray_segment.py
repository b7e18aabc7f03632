"""Ray-vs-segment min-hit sweep of the side and lane-line detector clouds:
the plain version, the per-scenario line table and the CUDA kernel's
wrapper (the counterpart of metadrive_ped_tpu/ops/pallas_raycast.py).

The detector clouds reduce [E, R, B] ray-segment intersections to per-ray
min hit fractions [E, R]. `ray_segment_fraction` is the plain torch
version over per-env endpoints. `build_line_table` packs each scenario's
lane lines once, continuous lines first; `detector_clouds` computes both
clouds from that table, in one launch of the hand-written kernel in
csrc/ray_segment.cu for CUDA tensors, or by the plain version for CPU
tensors. On a CUDA tensor it launches the kernel or raises.
"""
import collections
import ctypes
import sys

import torch

from metadrive_ped_torch.constants import SEG_BROKEN_LINE, SEG_WHITE_LINE, SEG_YELLOW_LINE
from metadrive_ped_torch.core import cuda_build, launches as launch_counts

# launches of the kernel since the last reset (set to 0 to start counting),
# in all and by device index (clear to start counting); this module is the
# counter `core.launches.record` keeps, replays of a captured step included
launches = 0
launches_by_device = collections.Counter()


def _min_hit_fraction(origin, dx, dy, max_dist, ax, ay, sx, sy, valid):
    """Min over segments of the hit fraction: rays o + t*d [E,R] against
    segments a + u*s [E,B] masked by valid [E,B] -> [E,R]."""
    dx, dy = dx[:, :, None], dy[:, :, None]               # [E,R,1]
    ax, ay = ax[:, None, :], ay[:, None, :]               # [E,1,B]
    sx, sy = sx[:, None, :], sy[:, None, :]
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


def ray_segment_fraction(origin, angles, max_dist, p0, p1, valid, dirs=None):
    """Min hit fraction of rays against 2D segments, plain torch (the
    side/lane-line detectors' rayTestClosest against lane-line ghosts,
    distance_detector.py:27-85 + SideDetector :194).

    origin [E,2]; angles [E,R] (or unit directions ``dirs`` = (dx, dy));
    p0/p1 [E,B,2]; valid [E,B] -> [E,R].
    """
    dx, dy = dirs if dirs is not None else (torch.cos(angles), torch.sin(angles))
    return _min_hit_fraction(origin, dx, dy, max_dist, p0[..., 0], p0[..., 1],
                             p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1], valid)


def build_line_table(scene, include_broken, points=None):
    """Each scenario's lane-line segments, for the detector clouds.

    Returns ``table`` [S, Bl, 4] float32, rows (ax, ay, sx, sy) with
    a = p0 and s = p1 - p0 of ``points`` = (p0, p1) [S, B, 2], by default
    the dequantized endpoints `Scene.seg_points` gives (the same ops in the
    same order, so bit-equal), and ``counts`` [S, 2] int32,
    (n_cont, n_any). Within a scenario the valid continuous lines (yellow,
    white) come first, then, with ``include_broken``, the valid broken
    lines; each group keeps its order. Rows from n_any to Bl are zero;
    Bl = max(1, max n_any). The sweep's result is a min, which no order
    changes, so the table gives the same clouds as the per-env masks."""
    S = scene.num_scenarios
    p0, p1 = points if points is not None else scene.seg_points(
        torch.arange(S, device=scene.seg_type.device))
    rows = torch.cat([p0, p1 - p0], dim=-1)                               # [S,B,4]
    typ, valid = scene.seg_type, scene.seg_valid
    cont = ((typ == SEG_YELLOW_LINE) | (typ == SEG_WHITE_LINE)) & valid
    broken = (typ == SEG_BROKEN_LINE) & valid if include_broken else torch.zeros_like(cont)
    # group 0 = continuous, 1 = broken, 2 = dropped; a stable sort keeps
    # the order within each group
    group = torch.where(cont, 0, torch.where(broken, 1, 2))
    order = torch.sort(group, dim=1, stable=True).indices
    n_cont = cont.sum(1)
    n_any = n_cont + broken.sum(1)
    Bl = max(1, int(n_any.max()))
    n = min(Bl, rows.shape[1])
    table = torch.zeros((S, Bl, 4), dtype=torch.float32, device=rows.device)
    table[:, :n] = torch.gather(rows, 1, order[:, :n, None].expand(S, n, 4))
    keep = torch.arange(Bl, device=rows.device)[None, :] < n_any[:, None]
    table = torch.where(keep[..., None], table, 0.0)
    counts = torch.stack([n_cont, n_any], dim=1).to(torch.int32)
    return table, counts


def detector_clouds_plain(origin, sidx, side_dirs, lane_dirs, side_dist, lane_dist, table, counts):
    """Plain torch version of `detector_clouds`: gathers each env's table
    rows and masks row j < n_cont (side) and j < n_any (lane-line)."""
    s = sidx.long()
    rows, c = table[s], counts[s]                                         # [E,Bl,4], [E,2]
    j = torch.arange(table.shape[1], device=table.device)[None, :]
    ax, ay, sx, sy = rows.unbind(-1)
    side = _min_hit_fraction(origin, *side_dirs, side_dist, ax, ay, sx, sy, j < c[:, 0:1])
    lane = _min_hit_fraction(origin, *lane_dirs, lane_dist, ax, ay, sx, sy, j < c[:, 1:2])
    return side, lane


def _kernel_lib():
    lib = cuda_build.library("ray_segment")
    fn = lib.detector_clouds_launch
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, f32, f32, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, ptr]
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


def detector_clouds(origin, sidx, side_dirs, lane_dirs, side_dist, lane_dist, table, counts):
    """The side and lane-line detector clouds, (side [E,Rs], lane [E,Rl]).

    origin [E,2]; sidx [E] int32; side_dirs / lane_dirs = (dx, dy) unit
    ray directions, [E,Rs] / [E,Rl] each (Rs or Rl may be 0); the line
    table and counts of `build_line_table`. The side detector sees rows
    [0, n_cont) of its scenario, the lane-line detector rows [0, n_any).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    once (none when Rs = Rl = 0), on their own device's current stream:
    every input must lie on origin's device. sidx must lie in [0, S): the kernel
    writes NaN for an env whose sidx does not."""
    if origin.device.type == "cpu":
        return detector_clouds_plain(origin, sidx, side_dirs, lane_dirs, side_dist, lane_dist,
                                     table, counts)
    if origin.device.type != "cuda":
        raise ValueError(f"detector_clouds runs on cpu or cuda, not {origin.device}")
    (sdx, sdy), (ldx, ldy) = side_dirs, lane_dirs
    E, Rs, Rl = origin.shape[0], sdx.shape[-1], ldx.shape[-1]
    S, Bl = table.shape[0], table.shape[1]
    dev = origin.device
    _check("origin", origin, dev, torch.float32, (E, 2))
    _check("sidx", sidx, dev, torch.int32, (E,))
    for name, d, R in (("side dx", sdx, Rs), ("side dy", sdy, Rs),
                       ("lane dx", ldx, Rl), ("lane dy", ldy, Rl)):
        _check(name, d, dev, torch.float32, (E, R))
    _check("table", table, dev, torch.float32, (S, Bl, 4))
    _check("counts", counts, dev, torch.int32, (S, 2))
    if table.data_ptr() % 16 or origin.data_ptr() % 8 or counts.data_ptr() % 8:
        raise ValueError("table must be 16-byte aligned and origin and counts 8-byte "
                         "aligned (read as float4, float2 and int2)")
    if not (side_dist > 0 and lane_dist > 0):
        raise ValueError("side_dist and lane_dist must be positive")
    side = torch.empty((E, Rs), dtype=torch.float32, device=dev)
    lane = torch.empty((E, Rl), dtype=torch.float32, device=dev)
    if E == 0 or Rs + Rl == 0:
        return side, lane
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(origin.data_ptr(), sidx.data_ptr(), sdx.data_ptr(), sdy.data_ptr(),
                 ldx.data_ptr(), ldy.data_ptr(), float(side_dist), float(lane_dist),
                 table.data_ptr(), counts.data_ptr(), side.data_ptr(), lane.data_ptr(),
                 E, Rs, Rl, S, Bl, stream)
    if err != 0:
        raise RuntimeError(f"ray_segment kernel launch failed: cudaError {err}")
    launch_counts.record(sys.modules[__name__], dev.index)
    return side, lane
