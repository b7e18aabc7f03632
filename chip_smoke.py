#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (metadrive_ped_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from any working directory (it puts its own directory on sys.path),
needs one CUDA device, and prints one JSON line per phase:

1. device        the card (nvidia-smi name and power limit), torch and CUDA
2. build         nvcc of every kernel, its seconds and ptxas registers/smem
3. kernel_vs_plain  the ray-segment kernel against its plain torch version
                 at the main path's shapes (E=8192, R=160 and R=12, B of
                 the compiled pack) and at ragged shapes; max_abs_err must
                 be <= 1e-5; kernel, plain and roofline-bound times
4. env           the main path at full width: the `pg` bench protocol
                 (bench.py:28-32, 8192 envs) with lidar 240, side detector
                 160 and lane-line detector 12 lasers, full throttle for 200
                 steps; env-steps/s over steps 100-200, obs checks, episodes
                 finished, kernel launches (must be 2 * steps + 2), and one
                 step under torch.cuda.set_sync_debug_mode("error")
5. card_vs_cpu   32 envs for 20 steps on the card and on the CPU: obs and
                 reward within 1e-4, discrete flags equal

then the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failed phase raises and exits non-zero.
"""
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The main path: bench.py's `pg` protocol with the detectors of the
# reference's Waymo FPS protocol (bench.py:57-70) switched on.
MAIN_PATH = dict(num_envs=8192, map=3, num_scenarios=16, traffic_density=0.05, horizon=1000,
                 vehicle_config=dict(lidar=dict(num_lasers=240),
                                     side_detector=dict(num_lasers=160),
                                     lane_line_detector=dict(num_lasers=12)))
DEVICE = "cuda"
STEPS = 200
TIMED_FROM = 100
KERNEL_TOL = 1e-5
CPU_TOL = 1e-4
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): dense float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per (ray, valid segment) pair in csrc/ray_segment.cu:
# denom 3 (2 mul, 1 sub), |denom| guard 2, rel 2, t 4 (2 mul, sub, div),
# u 4, hit tests 3, scale 1 (div), clip 2
OPS_PER_PAIR = 21


def emit(**fields):
    print(json.dumps(fields), flush=True)


def card_name_and_power():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms, by CUDA events over iters calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ray_segment_bound(E, R, B, valid):
    """Least time (ms) for one ray-segment sweep on the card, and what sets
    it: each input read once and the output written once, against
    OPS_PER_PAIR operations for every (ray, valid segment) pair of this
    input."""
    bytes_moved = 4 * (2 * E + 2 * E * R + 4 * E * B + E * R) + E * B
    ops = OPS_PER_PAIR * R * int(valid.sum())
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_case(name, origin, dx, dy, max_dist, p0, p1, valid, iters):
    import torch

    from metadrive_ped_torch.ops import ray_segment as rs
    E, R = dx.shape
    B = p0.shape[1]
    out = rs.ray_segment_sweep(origin, dx, dy, max_dist, p0, p1, valid)
    plain = rs.ray_segment_fraction(origin, None, max_dist, p0, p1, valid, dirs=(dx, dy))
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: kernel differs from the plain version by {err}")
    ms = time_ms(lambda: rs.ray_segment_sweep(origin, dx, dy, max_dist, p0, p1, valid), iters)
    plain_ms = time_ms(lambda: rs.ray_segment_fraction(origin, None, max_dist, p0, p1, valid,
                                                       dirs=(dx, dy)), max(2, iters // 20), warmup=1)
    bound_ms, bound_by = ray_segment_bound(E, R, B, valid)
    row = dict(case=name, E=E, R=R, B=B, max_abs_err=err, tol=KERNEL_TOL,
               hits=int((out < 1).sum()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    emit(phase="kernel_vs_plain", **row)
    return row


def random_segments(E, R, B, seed):
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, device=DEVICE, generator=g)
    origin = (u(E, 2) - 0.5) * 10
    ang = u(E, R) * 2 * math.pi
    p0 = (u(E, B, 2) - 0.5) * 60
    p1 = p0 + (u(E, B, 2) - 0.5) * 20
    return origin, torch.cos(ang), torch.sin(ang), p0, p1, u(E, B) > 0.2


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.constants import SEG_BROKEN_LINE, SEG_WHITE_LINE, SEG_YELLOW_LINE
    from metadrive_ped_torch.core import cuda_build
    from metadrive_ped_torch.ops import ray_segment as rs
    from metadrive_ped_torch.ops.raycast import _fan_dirs

    card = card_name_and_power()
    emit(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    seconds = cuda_build.build_all()
    emit(phase="build", seconds=seconds,
         ptxas={k: {f: v.get(f) for f in ("registers", "smem_bytes")}
                for k, v in cuda_build.ptxas_reports.items()},
         ptxas_lines={k: v["lines"] for k, v in cuda_build.ptxas_reports.items()})

    # ---- kernel against the plain version ---------------------------------
    t0 = time.perf_counter()
    env = MetaDriveEnv(MAIN_PATH, device=DEVICE)
    E = env.num_envs
    env.reset(seed=0)
    st, scene = env._state, env.scene
    s = st.sidx.long()
    p0, p1 = scene.seg_points(st.sidx)
    styp, svalid = scene.seg_type[s], scene.seg_valid[s]
    cont = ((styp == SEG_YELLOW_LINE) | (styp == SEG_WHITE_LINE)) & svalid
    anyline = cont | ((styp == SEG_BROKEN_LINE) & svalid)
    emit(phase="env_build", seconds=time.perf_counter() - t0, num_envs=E,
         scenarios=env.num_scenarios, obs_dim=env.observation_dim, segments=int(p0.shape[1]))
    main_rows = []
    for name, R, dist, mask in (("side_detector", 160, 50.0, cont),
                                ("lane_line_detector", 12, 20.0, anyline)):
        dx, dy = _fan_dirs(st.ego.heading, R, offset=math.pi / 2)
        main_rows.append(kernel_case(name, st.ego.pos, dx, dy, dist, p0, p1, mask, iters=50))
    rows = list(main_rows)
    # ragged: B over one shared-memory tile and not a multiple of it, B=1,
    # and more rays than one block holds
    for name, (E_, R_, B_) in (("ragged_E_and_B", (4097, 160, 1500)), ("B_is_1", (33, 12, 1)),
                               ("R_over_256", (7, 300, 777))):
        origin, dx, dy, rp0, rp1, rvalid = random_segments(E_, R_, B_, seed=E_)
        rows.append(kernel_case(name, origin, dx, dy, 50.0, rp0, rp1, rvalid, iters=20))

    # ---- the main path at full width --------------------------------------
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
    rs.launches = 0
    obs, _ = env.reset(seed=0)
    finished = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for i in range(TIMED_FROM):
        if i == 1:
            # one step must not synchronise with the host
            torch.cuda.set_sync_debug_mode("error")
        obs, reward, term, trunc, info = env.step(act)
        torch.cuda.set_sync_debug_mode(0)
        finished += (term | trunc).sum()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, _ = env.rollout(STEPS - TIMED_FROM, actions=act, collect=("terminated", "truncated"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rs.launches
    finished += (outs["terminated"] | outs["truncated"]).sum()
    obs = env._last_obs
    obs_ok = bool(torch.isfinite(obs).all()) and bool(((obs >= 0) & (obs <= 1)).all())
    emit(phase="env", num_envs=E, steps=STEPS, rate_window=f"steps {TIMED_FROM}-{STEPS}",
         seconds=seconds, env_steps_per_s=E * (STEPS - TIMED_FROM) / seconds, card=card,
         obs_shape=list(obs.shape), obs_ok=obs_ok, episodes_finished=int(finished),
         ray_segment_launches=launches, expected_launches=2 * STEPS + 2,
         host_sync_checked_step=2, peak_memory_bytes=torch.cuda.max_memory_allocated())
    if tuple(obs.shape) != (E, env.observation_dim) or not obs_ok:
        raise AssertionError("observation out of shape or range")
    if launches != 2 * STEPS + 2:
        raise AssertionError(f"ray-segment kernel launched {launches} times, expected {2 * STEPS + 2}")
    if int(finished) == 0:
        raise AssertionError("no episode finished in 200 steps")
    del env, outs

    # ---- the card against the CPU -----------------------------------------
    cfg = dict(MAIN_PATH, num_envs=32)
    gpu, cpu = MetaDriveEnv(cfg, device=DEVICE), MetaDriveEnv(cfg, device="cpu")
    og, _ = gpu.reset(seed=0)
    oc, _ = cpu.reset(seed=0)
    obs_err = float((og.cpu() - oc).abs().max())
    rew_err, flag_mismatches = 0.0, 0
    for _ in range(20):
        og, rg, tg, trg, ig = gpu.step(torch.tensor([[0.0, 1.0]] * 32, device=DEVICE))
        oc, rc, tc, trc, ic = cpu.step(torch.tensor([[0.0, 1.0]] * 32))
        obs_err = max(obs_err, float((og.cpu() - oc).abs().max()))
        rew_err = max(rew_err, float((rg.cpu() - rc).abs().max()))
        flags = [(tg, tc), (trg, trc)] + [(ig[k], ic[k]) for k in ic if ic[k].dtype == torch.bool]
        flag_mismatches += sum(int((a.cpu() != b).sum()) for a, b in flags)
    emit(phase="card_vs_cpu", num_envs=32, steps=20, obs_max_abs_err=obs_err,
         reward_max_abs_err=rew_err, tol=CPU_TOL, flag_mismatches=flag_mismatches)
    if not (obs_err <= CPU_TOL and rew_err <= CPU_TOL and flag_mismatches == 0):
        raise AssertionError("the card and the CPU disagree")

    # ---- the kernels line ------------------------------------------------
    print(json.dumps({"kernels": [dict(
        name="ray_segment", route="cuda", source="metadrive_ped_torch/csrc/ray_segment.cu",
        replaces="metadrive_ped_tpu/ops/pallas_raycast.py:72", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        # per env step at the main path's shapes: both launches (R=160, R=12)
        ms=sum(r["ms"] for r in main_rows), plain_ms=sum(r["plain_ms"] for r in main_rows),
        bound_ms=sum(r["bound_ms"] for r in main_rows),
        bound_by=max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        library_ms=None,
    )]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
