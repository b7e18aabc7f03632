"""The camera frame's least time on the card, from the work a frame must do.

Copied from the program's tools (chip_smoke.py's `camera_bound`,
`CAMERA_OPS` and `CAMERA_OUT_FLOATS`; its formula is `pairs_bound`'s here),
at `yardstick`'s peaks, so that the yardstick stays fixed while the
program changes. `frame_bound` counts
only the (pixel, primitive) pairs that can count, from the env's state and
scene, never from the program's counters, so it reads the same work
whatever implements the camera:

- the ground: each pixel whose ray meets the z=0 plane, against each
  valid lane (the on-road test) and each valid boundary segment (the line
  and sidewalk tests) of its row's scenario;
- the bodies: every pixel against each active target slot of its row (NPC
  vehicles, traffic objects, pedestrians).

A camera that culls primitives by space (a tile's lanes, the boxes in its
view) could do less than this count and read above 100%: a `benchmark`
change then corrects the count first.
"""
import torch

from benchmarks.reference.ops.camera import pixel_rays
from benchmarks.yardstick import PEAK_BYTES, PEAK_FP32_OPS

# float32 operations of the camera (ops/camera.py) per pixel and primitive,
# a transcendental (atan2, sqrt, reciprocal) counted as one, so the bound
# is a least time: a (pixel, segment) pair 25 (offsets 2, projection 6,
# closest point 6, distance 4, threshold 2, masks 5), a (pixel, lane) pair
# 52 (local_coordinates 43, the region test 9), a (pixel, box) pair 50
# (rotation 7, three slabs 30, entry / exit / hit 8, nearest 5)
CAMERA_OPS = dict(segment=25, lane=52, box=50)
CAMERA_OUT_FLOATS = 10  # depth 1, semantic 3, rgb 3, instance 3 per pixel


def camera_bound(E, P, L, B, T):
    """Least time (ms) of one camera frame of E envs at P pixels over L
    lanes, B segments and T boxes, every pair padded, and what sets it."""
    return pairs_bound(E * P, E * P * L, E * P * B, E * P * T)


def pairs_bound(pixels, lane_pairs, segment_pairs, box_pairs):
    """Least time (ms) of one camera frame over counted (pixel, primitive)
    pairs, and what sets it: CAMERA_OPS operations per pair against the
    float32 peak, or the frame's outputs written once (the per-env tables
    it reads are under 0.1% of them)."""
    ops = (CAMERA_OPS["segment"] * segment_pairs + CAMERA_OPS["lane"] * lane_pairs
           + CAMERA_OPS["box"] * box_pairs)
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = pixels * CAMERA_OUT_FLOATS * 4 / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ground_pixels(width, height, fov_deg, pitch_deg, cam_height):
    """How many of a camera's pixels have a ray that meets the ground (its
    z component below -1e-6, as the ground hit tests it; the heading does
    not change it)."""
    dirs = pixel_rays(torch.zeros(1), width, height, fov_deg, pitch_deg, cam_height)
    return int((dirs[0, :, 2] < -1e-6).sum())


def frame_pairs(env, state=None):
    """(pixels, lane pairs, segment pairs, box pairs) of one camera frame of
    ``env``'s rows at ``state`` (default: the env's own)."""
    state = env._state if state is None else state
    cfg, scene = env.config, env.scene
    _, w, h = cfg["sensors"][cfg["image_source"]]
    cam = cfg["camera"]
    P = int(w) * int(h)
    G = ground_pixels(int(w), int(h), cam["fov"], cam["pitch"], cam["height"])
    s = state.sidx.long()
    E = s.shape[0]
    lanes = int(scene.lane_valid[s].sum())
    segments = int(scene.seg_valid[s].sum())
    bodies = (int(state.npc.active.sum()) + int(scene.obj_valid[s].sum())
              + int(state.ped.active.sum()))
    return E * P, G * lanes, G * segments, P * bodies


def frame_bound(env, state=None):
    """(ms, what sets it) of one camera frame of ``env`` at ``state``."""
    return pairs_bound(*frame_pairs(env, state))
