"""Installation self-check (reference: examples/verify_headless_installation.py
checks offscreen rendering; here: the device, the build of every CUDA
kernel on a GPU, an env step with the detectors on, the observation's
invariants, and a camera observation).

    python -m metadrive_ped_torch.examples.verify_headless_installation [--cpu]
"""
import argparse

import torch

from metadrive_ped_torch.examples import example_device, force_cpu_flag


def main(argv=None):
    parser = argparse.ArgumentParser()
    force_cpu_flag(parser)
    device = example_device(parser.parse_args(argv))
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", device)
    if device.type == "cuda":
        from metadrive_ped_torch.core import cuda_build
        print("card:", torch.cuda.get_device_name(device))
        print(f"CUDA kernels built in {cuda_build.build_all():.1f} s")

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import ray_segment

    env = MetaDriveEnv(dict(num_envs=2, map="CS", num_scenarios=1, traffic_density=0.1,
                            vehicle_config=dict(side_detector=dict(num_lasers=16),
                                                lane_line_detector=dict(num_lasers=4))),
                       device=device)
    ray_segment.launches = 0
    obs, _ = env.reset(seed=0)
    act = torch.tensor([0.0, 1.0], device=device).expand(2, 2)
    for _ in range(5):
        obs, r, term, trunc, info = env.step(act)
    if not (bool(torch.isfinite(obs).all()) and bool(((obs >= 0) & (obs <= 1)).all())):
        raise AssertionError("observation not finite or out of [0, 1]")
    print("vector obs OK:", tuple(obs.shape))
    if device.type == "cuda":
        if ray_segment.launches != 6:
            raise AssertionError(f"the detector kernel launched {ray_segment.launches} times, "
                                 "expected 6")
        print("detector kernel OK: one launch a step")

    cam = MetaDriveEnv(dict(num_envs=2, map="S", num_scenarios=1, image_observation=True,
                            sensors=dict(main_camera=("rgb", 64, 64))), device=device)
    obs, _ = cam.reset(seed=0)
    img = obs["image"]
    if tuple(img.shape[1:3]) != (64, 64) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"camera image {tuple(img.shape)} not finite or of the wrong size")
    print("camera obs OK:", tuple(img.shape))
    print("Successfully verify the headless installation!")
    return tuple(obs["state"].shape), tuple(img.shape)


if __name__ == "__main__":
    main()
