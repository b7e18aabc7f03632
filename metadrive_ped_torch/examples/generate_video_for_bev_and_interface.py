"""Generate temporally aligned BEV and dashboard videos of one episode.

Twin of the reference's generate_video_for_bev_and_interface.py (drives one
episode with the expert and writes ``0_bev.mp4`` and ``0_interface.mp4``).
There is no interface window here: the "interface" video is the ray-cast
camera frame with the dashboard panel (obs/render.py::render_dashboard)
below it; the BEV frames come from env.render("topdown").

    python -m metadrive_ped_torch.examples.generate_video_for_bev_and_interface [--cpu]

Writes <out>/0_bev and <out>/0_interface as .mp4 with imageio and its
ffmpeg plugin, else as .gif (imageio or PIL), else as .npy frame stacks.
"""
import argparse
import os
from datetime import datetime

import numpy as np
import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def save_video(frames, path_base, fps=25):
    """Write frames [T, H, W, 3] uint8; returns the path written."""
    try:
        import imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(path_base + ".mp4", frames, fps=fps)
            return path_base + ".mp4"
        except ValueError:  # no ffmpeg backend
            imageio.mimwrite(path_base + ".gif", frames, duration=1.0 / fps)
            return path_base + ".gif"
    try:
        from PIL import Image
    except ImportError:
        np.save(path_base + ".npy", np.stack(frames))
        return path_base + ".npy"
    first, *rest = [Image.fromarray(f) for f in frames]
    first.save(path_base + ".gif", save_all=True, append_images=rest,
               duration=int(1000 / fps))
    return path_base + ".gif"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100, help="horizon, like the reference's 100")
    p.add_argument("--bev-size", type=int, default=512)
    p.add_argument("--out", default=None)
    p.add_argument("--quick", action="store_true", help="3 steps, small frames")
    force_cpu_flag(p)
    args = p.parse_args(argv)
    cam_size, dash_h = (320, 180), 80
    if args.quick:
        args.steps, args.bev_size, cam_size, dash_h = 3, 64, (64, 36), 16
    device = example_device(args)

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.policies.expert import expert_action, load_expert_params

    folder = args.out or "example_video_{}".format(datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(folder, exist_ok=True)
    env = MetaDriveEnv(dict(num_envs=1, num_scenarios=1, start_seed=100, map=3,
                            traffic_density=0.1, crash_vehicle_done=False, horizon=args.steps,
                            vehicle_config=dict(lidar=dict(num_lasers=240, num_others=4))),
                       device=device)
    obs, _ = env.reset(seed=0)
    params = load_expert_params(device=device)

    video_bev, video_interface = [], []
    for _ in range(args.steps):
        obs, r, term, trunc, info = env.step(torch.clamp(expert_action(params, obs), -1, 1))
        video_bev.append(env.render("topdown", env_index=0, size=args.bev_size))
        cam = env.render("rgb_array", env_index=0, width=cam_size[0], height=cam_size[1])
        dash = env.render("dashboard", env_index=0, width=cam_size[0], height=dash_h)
        # the camera view with the dashboard panel below it
        video_interface.append(np.concatenate([cam, dash], axis=0))
        if bool(term[0]):
            break

    p_bev = save_video(video_bev, os.path.join(folder, "0_bev"))
    p_int = save_video(video_interface, os.path.join(folder, "0_interface"))
    print(f"wrote {len(video_bev)} frames:")
    print(f"  {p_bev}")
    print(f"  {p_int}")
    return p_bev, p_int


if __name__ == "__main__":
    main()
