"""Verify camera image observations: shapes, dtypes, content and speed.

Twin of the reference's verify_image_observation.py (builds an env per
camera type with ``image_observation=True``, steps it, checks the obs and
prints the image rate). Every camera here is the ray-cast renderer
(ops/camera.py), so the sweep covers rgb / depth / semantic / instance and
the MiniMap BEV sensor, the frame stack, and both norm_pixel dtypes.

    python -m metadrive_ped_torch.examples.verify_image_observation [--cpu]
    python -m metadrive_ped_torch.examples.verify_image_observation --camera rgb
"""
import argparse
import time

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag

CAMERAS = ("rgb", "depth", "semantic", "instance", "mini_map")


def run_camera(camera, res, num_envs, steps, norm_pixel, stack_size, device):
    """Build, check and time one camera; returns images per second."""
    from metadrive_ped_torch import MetaDriveEnv

    if camera == "mini_map":
        sensors, source, channels = dict(mini_map=("mini_map", *res)), "mini_map", 3
    else:
        source = f"{camera}_camera"
        sensors, channels = {source: (camera, *res)}, 1 if camera == "depth" else 3

    env = MetaDriveEnv(dict(num_envs=num_envs, num_scenarios=1, start_seed=1010, map="SCS",
                            traffic_density=0.0, image_observation=True, norm_pixel=norm_pixel,
                            stack_size=stack_size, image_source=source, sensors=sensors),
                       device=device)
    obs, _ = env.reset(seed=0)
    if set(obs) != {"image", "state"}:
        raise AssertionError(f"observation keys {set(obs)}")
    img = obs["image"]
    w, h = res
    if tuple(img.shape) != (num_envs, h, w, channels, stack_size):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if norm_pixel:
        if img.dtype != torch.float32 or float(img.min()) < 0.0 or float(img.max()) > 1.0:
            raise AssertionError("float image out of [0, 1]")
    elif img.dtype != torch.uint8 or int(img.max()) <= 1:
        raise AssertionError("uint8 image without content")
    # instance colours stay uniform until a body enters the frame, so the
    # content check is for the other modalities
    if camera != "instance" and float(img[..., -1].float().std()) <= 0:
        raise AssertionError("the latest frame has no content")
    action = torch.tensor([0.0, 0.1], device=device).expand(num_envs, 2)
    env.step(action)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        obs, r, te, tr, info = env.step(action)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = steps * num_envs / dt
    print(f"  {camera:9s} {w}x{h}x{channels} stack={stack_size} dtype={obs['image'].dtype} -> "
          f"{rate:,.0f} images/s ({steps * num_envs} frames / {dt:.2f} s)")
    return rate


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--camera", choices=CAMERAS + ("all",), default="all")
    p.add_argument("--width", type=int, default=84)
    p.add_argument("--height", type=int, default=60)
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--quick", action="store_true", help="2 envs, 32x24, 2 steps")
    force_cpu_flag(p)
    args = p.parse_args(argv)
    if args.quick:
        args.num_envs, args.width, args.height, args.steps = 2, 32, 24, 2
    device = example_device(args)

    cams = CAMERAS if args.camera == "all" else (args.camera,)
    res = (args.width, args.height)
    print(f"verifying image observations at {res[0]}x{res[1]}, {args.num_envs} envs:")
    rates = {cam: run_camera(cam, res, args.num_envs, args.steps, True, 3, device)
             for cam in cams}
    # the uint8 frames of norm_pixel=False, with a stack of one
    rates["rgb_uint8"] = run_camera("rgb", res, args.num_envs, args.steps, False, 1, device)
    print("all image observation checks passed")
    return rates


if __name__ == "__main__":
    main()
