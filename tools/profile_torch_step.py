#!/usr/bin/env python3
"""Where the time of one step of metadrive_ped_torch goes on the GPU.

    python3 tools/profile_torch_step.py [--num-envs 8192] [--steps 10] [--table PATH]
    python3 tools/profile_torch_step.py --scenario [--steps 10] [--table PATH]
    python3 tools/profile_torch_step.py --marl [--steps 10] [--table PATH]
    python3 tools/profile_torch_step.py --mixed [--steps 10] [--table PATH]
    python3 tools/profile_torch_step.py --image [--steps 10] [--table PATH]
    python3 tools/profile_torch_step.py --sharded [--steps 10] [--table PATH]
    python3 tools/profile_torch_step.py --count-ops
    (any of the GPU forms) --graph

Builds the env of chip_smoke.py's main path (the `pg` bench protocol with
the side and lane-line detectors on) or, with --scenario, each of
chip_smoke.py's three ScenarioEnv phases at their widths (scenario_replay,
scenario_reactive, scenario_lines), or, with --marl, its marl (512 envs x
8 agents), marl_40 and marl_tollgate (256 x 40) phases, or, with --mixed,
its mixed_traffic and ai_protect_noise phases (8192 envs), or, with
--image, its image_obs (1024 envs, 84x84 rgb camera, stack 3) and top_down
(TopDownMetaDrive, 4096 envs) phases, or, with --sharded, its sharded_pg
phase (the main path's env through ShardedEnv over [cuda:0, cuda:0]),
warms it up, then measures:

- wall ms per step (host clock around steps ending in a synchronize);
- device-busy ms per step and the busy share, from torch.profiler's CUDA
  kernel times over the same number of steps;
- kernel launches per step, and host API calls per step (the profiler's
  CUDA runtime and driver calls: kernel launches, graph launches, copies);
- ``spans``: the device ms a step of each stage span of the port's
  tracer (core/trace.py: replay, advance and its stages, observe and its
  stages, the write-back, the expert) inside the replayed step, from the
  stamps in its graph, and the useful-work counters a step (read right
  after the stamped graph's capture, in the slower phase that follows a
  capture: PERF.md §2);
- device ms, wall ms, launches and peak device memory of the finer stages
  no span covers, each run alone on the step's state (--mixed splits the
  expert traffic into the expert observation, the per-NPC lidar kernel,
  its plain chain beside it, and the MLP; --image splits the camera into
  its ray directions, ground hits, box hits and the rest of the frame,
  with the frame's graph replayed as one more stage, and the BEV into its
  texture samples, stamps and stack ring; --sharded has no stages: its
  line carries the unsharded env's replayed step of the same call beside
  the sharded one).

The numbers other than ``spans`` are of the eager step (`_step_eager`, `_rollout_eager`;
with --sharded, the shards' eager loop), dispatched op by op as before
CUDA graphs. With --graph each env's line also carries ``replayed``: wall
ms, device-busy ms, busy share, kernel launches and host API calls of the
step as `step` and `rollout` run it on the card, one replay of its
captured graph (with --sharded, each shard's two graphs; metadrive_ped_
torch/core/graph.py; the capture happens before the measured steps).

Prints one JSON line per env; with --table, writes the profiler's kernel
table of the whole step to PATH (one table per env with --scenario,
--marl, --mixed or --image). The scenario, multi-agent and mixed-traffic
steps go through `rollout` (1 step a call), which makes no host sync
(ScenarioEnv's `step` reads its coverage statistics on the host);
ai_protect_noise and the --image phases go through `step`, where the AI
protector reads the previous observation and the frame stacks live.

--count-ops needs no GPU: it counts the aten operators one step of each of
chip_smoke.py's PG, safe, multi-agent, mixed-traffic, AI-protector, camera
(image_obs, 4 envs: one chunk of camera rows) and top-down envs dispatches
on the CPU, at a few envs (the count does not depend on
the number of envs, only on the number of agents), and those of the
multi-agent respawn and of the expert traffic alone. On the card about
0.83 kernels launch per operator (PERF.md).
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import host_api_calls  # noqa: E402


def kernel_stats(prof, calls):
    """(device ms per call, launches per call) of the CUDA kernels a
    profiler saw over ``calls`` calls."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            sum(e.count for e in kernels) / calls)


def profiled(fn, calls):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return prof


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--table", help="file for the profiler's kernel table")
    ap.add_argument("--scenario", action="store_true",
                    help="profile chip_smoke.py's ScenarioEnv phases instead of the PG step")
    ap.add_argument("--marl", action="store_true",
                    help="profile chip_smoke.py's marl, marl_40 and marl_tollgate phases")
    ap.add_argument("--mixed", action="store_true",
                    help="profile chip_smoke.py's mixed_traffic and ai_protect_noise phases")
    ap.add_argument("--image", action="store_true",
                    help="profile chip_smoke.py's image_obs and top_down phases")
    ap.add_argument("--sharded", action="store_true",
                    help="profile chip_smoke.py's sharded_pg phase (ShardedEnv, two shards)")
    ap.add_argument("--count-ops", action="store_true",
                    help="count the aten operators of one step of each env, on the CPU")
    ap.add_argument("--graph", action="store_true",
                    help="also profile the replayed step (one CUDA-graph replay)")
    args = ap.parse_args()

    import torch
    if args.count_ops:
        return count_ops()
    if not torch.cuda.is_available():
        print("profile_torch_step.py needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import MAIN_PATH
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.constants import SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE
    from metadrive_ped_torch.ops import collision, localization, raycast

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.table and os.path.exists(args.table):
        os.remove(args.table)  # step_profile appends one table per env
    if args.scenario:
        return profile_scenarios(card, args)
    if args.marl:
        return profile_marl(card, args)
    if args.mixed:
        return profile_mixed(card, args)
    if args.image:
        return profile_image(card, args)
    if args.sharded:
        return profile_sharded(card, args)
    env = MetaDriveEnv(dict(MAIN_PATH, num_envs=args.num_envs), device="cuda")
    E = env.num_envs
    act = torch.tensor([0.0, 1.0], device="cuda").expand(E, 2).contiguous()
    env.reset(seed=0)
    row = step_profile(card, "pg_detectors", E, lambda: env._step_eager(act), args.steps,
                       args.table, replayed=args.graph and (lambda: env.step(act)))

    replayed_step = lambda: env.rollout(1, actions=act, collect=())  # noqa: E731
    row.update(spans=span_stages(replayed_step, args.steps))
    # the finer stages of _step_impl, each alone on the current state
    st, scene, cfg = env._state, env.scene, env.config
    vc = cfg["vehicle_config"]
    ego, s = st.ego, st.sidx.long()
    targets, _ = env._lidar_targets(st)
    styp, svalid = scene.seg_type[s], scene.seg_valid[s]
    side, lane = vc["side_detector"], vc["lane_line_detector"]
    zeros = torch.zeros(E, device="cuda")
    stages = {
        "lidar targets + OBB contact flags": lambda: collision.obb_obb_overlap(
            ego.pos[:, None, :], ego.heading[:, None], ego.params.length[:, None],
            ego.params.width[:, None], *env._lidar_targets(st)[0][:4]),
        "contact response (SAT MTV)": lambda: env._resolve_contacts(
            ego, st.npc, torch.ones_like(targets[4]), *targets[:4]),
        "localize": lambda: localization.localize(scene, st.sidx, ego.slot, ego.pos, ego.lane,
                                                  ego.route_idx),
        "boundary-segment flags": lambda: collision.vehicle_segment_flags(
            ego.pos, ego.heading, ego.params.length, ego.params.width, *scene.seg_points(st.sidx),
            styp, scene.seg_halfwidth[s], svalid, (SEG_YELLOW_LINE, SEG_WHITE_LINE, SEG_SIDEWALK)),
        "side + lane-line clouds (fans + one kernel launch)": lambda: raycast.detector_clouds(
            ego.pos, ego.heading, st.sidx, (side["num_lasers"], side["distance"]),
            (lane["num_lasers"], lane["distance"]), *env._line_table),
        "reward/cost/done": lambda: env.done_function(st, zeros > 0, zeros > 0),
    }
    print(json.dumps(dict(card=card, num_envs=E, steps=args.steps, **row,
                          stages=stage_profile(stages))), flush=True)
    return 0


def step_profile(card, name, E, step, steps, table, replayed=None):
    """wall ms, device ms, busy share, launches and host API calls of
    ``steps`` calls of step() (the eager step); writes the kernel table to
    ``table`` when given. With ``replayed``, the same of the replayed step
    under "replayed" (its table follows the eager one's)."""
    row = _profile_calls(card, name, E, step, steps, table)
    if replayed:
        row["replayed"] = _profile_calls(card, f"{name} (replayed)", E, replayed, steps, table)
        replayed_ms = row["replayed"]["wall_ms_per_step"]
        row["replayed"]["wall_speedup"] = row["wall_ms_per_step"] / replayed_ms
    return row


def _profile_calls(card, name, E, step, steps, table):
    import torch
    for _ in range(30):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof = profiled(step, steps)
    busy_ms, launches = kernel_stats(prof, steps)
    api_calls, api_top = host_api_calls(prof, steps)
    if table:
        with open(table, "a") as f:
            f.write(f"{name}: {card}; {E} envs; {steps} steps\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40,
                                              max_name_column_width=90))
    return dict(wall_ms_per_step=wall_ms, env_steps_per_s=E / wall_ms * 1e3,
                device_busy_ms_per_step=busy_ms, busy_share=busy_ms / wall_ms,
                launches_per_step=launches, host_api_calls_per_step=api_calls,
                host_api_calls_top=api_top,
                launch_bound_hint_us_per_launch=wall_ms * 1e3 / launches if launches else None)


def span_stages(step, steps):
    """Device ms a step of each of the tracer's device spans over ``steps``
    replayed calls of step() (one step a call), and its counters a step:
    tracing on, one call that captures the stamped graph, then the read
    calls."""
    from metadrive_ped_torch.core import trace
    recs = trace.read(step, n=steps)
    return dict(device_ms={name: sum(ms) / steps
                           for (clock, name), ms in trace.durations(recs).items()
                           if clock == "device"},
                counters={k: v / steps for k, v in recs["counters"].items()})


def stage_profile(stages):
    """device ms, wall ms, launches and peak device memory (bytes above what
    was allocated before it) of each stage, run alone 5 times."""
    import torch
    rows = {}
    for name, fn in stages.items():
        ms, n = kernel_stats(profiled(fn, 5), 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        rows[name] = dict(device_ms=ms, wall_ms=(time.perf_counter() - t0) * 1e3 / 5, launches=n,
                          peak_memory_bytes=torch.cuda.max_memory_allocated() - before)
    return rows


def profile_scenarios(card, args):
    """One JSON line for each of chip_smoke.py's ScenarioEnv phases."""
    import math

    import torch

    import chip_smoke as cs
    from metadrive_ped_torch import MetaDriveEnv, ScenarioEnv
    from metadrive_ped_torch.constants import SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE
    from metadrive_ped_torch.ops import collision, polyline, raycast
    from metadrive_ped_torch.ops.raycast import _fan_dirs
    from metadrive_ped_torch.scenario import export_scenarios
    from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
    synthetic = [synthetic_waymo_sd(seed) for seed in range(cs.SYNTHETIC_SCENARIOS)]
    src = MetaDriveEnv(cs.LINES_SOURCE, device="cuda")
    src.reset(seed=0)
    full = torch.tensor([0.0, 1.0], device="cuda").expand(src.num_envs, 2).contiguous()
    exported = list(export_scenarios(src, cs.EXPORT_STEPS, actions=full).values())
    del src
    for name, cfg in (("scenario_replay", dict(cs.SCENARIO_REPLAY, scenario_data=synthetic)),
                      ("scenario_reactive", dict(cs.SCENARIO_REACTIVE, scenario_data=synthetic)),
                      ("scenario_lines", dict(cs.SCENARIO_LINES, scenario_data=exported))):
        env = ScenarioEnv(cfg, device="cuda")
        E = env.num_envs
        act = torch.tensor([0.0, 1.0], device="cuda").expand(E, 2).contiguous()
        env.reset(seed=0)
        row = step_profile(card, name, E, lambda: env._rollout_eager(1, actions=act, collect=()),
                           args.steps, args.table,
                           replayed=args.graph and (lambda: env.rollout(1, actions=act,
                                                                        collect=())))
        row.update(spans=span_stages(lambda: env.rollout(1, actions=act, collect=()),
                                     args.steps))
        st, scene, vc = env._state, env.scene, env.config["vehicle_config"]
        ego, s = st.ego, st.sidx.long()
        pts, npts, arcl = scene.sdc_pts[s], scene.sdc_npts[s], scene.sdc_arclen[s]
        side = vc["side_detector"]
        stages = {
            "npc pose (replay rows + reactive overlay)": lambda: env._npc_pose(st),
            "trajectory localization (local_coordinates, heading_at, total_length)": lambda: (
                polyline.local_coordinates(pts, npts, ego.pos, s=arcl),
                polyline.heading_at(pts, npts, st.cur_long, s=arcl),
                polyline.total_length(pts, npts, s=arcl)),
            "boundary-segment flags": lambda: collision.vehicle_segment_flags(
                ego.pos, ego.heading, ego.params.length, ego.params.width,
                *scene.seg_points(st.sidx), scene.seg_type[s], scene.seg_halfwidth[s],
                scene.seg_valid[s], (SEG_YELLOW_LINE, SEG_WHITE_LINE, SEG_SIDEWALK)),
            "side cloud (fan + one kernel launch)": lambda: raycast.detector_clouds(
                ego.pos, ego.heading, st.sidx, (side["num_lasers"], side["distance"]),
                (0, side["distance"]), *env._line_table),
            "side fan alone": lambda: _fan_dirs(ego.heading, side["num_lasers"],
                                                offset=math.pi / 2),
        }
        row.update(stages=stage_profile(stages))
        print(json.dumps(dict(phase=name, card=card, num_envs=E, steps=args.steps, **row)),
              flush=True)
        del env
    return 0


def profile_marl(card, args):
    """One JSON line for each of chip_smoke.py's marl, marl_40 and
    marl_tollgate phases, with the multi-agent stages alone; the rates
    count agent rows (agent-steps/s) and envs."""
    import torch

    import chip_smoke as cs
    from metadrive_ped_torch import MultiAgentRoundaboutEnv, MultiAgentTollgateEnv
    for name, cls, cfg in (("marl", MultiAgentRoundaboutEnv, cs.MARL),
                           ("marl_40", MultiAgentRoundaboutEnv, cs.MARL_40),
                           ("marl_tollgate", MultiAgentTollgateEnv, cs.MARL_TOLLGATE)):
        env = cls(cfg, device="cuda")
        E = env.num_envs
        act = torch.tensor([0.0, 1.0], device="cuda").expand(E, 2).contiguous()
        env.reset(seed=0)
        row = step_profile(card, name, E, lambda: env._rollout_eager(1, actions=act, collect=()),
                           args.steps, args.table,
                           replayed=args.graph and (lambda: env.rollout(1, actions=act,
                                                                        collect=())))
        for r in filter(None, (row, row.get("replayed"))):
            r["agent_steps_per_s"] = r.pop("env_steps_per_s")
            r["env_steps_per_s"] = r["agent_steps_per_s"] / env.agents_per_env
        row.update(spans=span_stages(lambda: env.rollout(1, actions=act, collect=()),
                                     args.steps))
        st = env._state
        ego = st.ego
        targets, _ = env._lidar_targets(st)
        every = torch.ones(E, dtype=torch.bool, device="cuda")
        stages = {
            "respawn (region sweep, A-step slot claim, ego spawn)": lambda: env._respawn(st, every),
            "other agents as targets": lambda: env._extra_vehicle_targets(st),
            "lidar targets": lambda: env._lidar_targets(st),
            "contact response": lambda: env._resolve_contacts(
                ego, st.npc, torch.ones_like(targets[4]), *targets[:4], env._freeze_mask(st)),
            "all-done reset mask": lambda: env._reset_mask(st, every),
        }
        print(json.dumps(dict(phase=name, card=card, num_envs=env.num_marl_envs,
                              agents_per_env=env.agents_per_env, rows=E, steps=args.steps, **row,
                              stages=stage_profile(stages))), flush=True)
        del env
    return 0


def profile_mixed(card, args):
    """One JSON line for chip_smoke.py's mixed_traffic phase, with the
    expert traffic split into its stages (the expert observation, the
    per-NPC lidar kernel and, beside it, its plain chain, the MLP), and one
    for its ai_protect_noise phase, whose step goes through `step` (the
    protector reads the previous observation only there)."""
    import torch

    import chip_smoke as cs
    from metadrive_ped_torch import MetaDriveEnv, MixedTrafficEnv
    from metadrive_ped_torch.core import prng
    from metadrive_ped_torch.ops import mixed_traffic, npc_lidar
    from metadrive_ped_torch.policies.expert import expert_action
    env = MixedTrafficEnv(cs.MIXED_TRAFFIC, device="cuda")
    E = env.num_envs
    act = torch.tensor([0.0, 1.0], device="cuda").expand(E, 2).contiguous()
    env.reset(seed=0)
    row = step_profile(card, "mixed_traffic", E,
                       lambda: env._rollout_eager(1, actions=act, collect=()), args.steps,
                       args.table,
                       replayed=args.graph and (lambda: env.rollout(1, actions=act, collect=())))
    row.update(spans=span_stages(lambda: env.rollout(1, actions=act, collect=()), args.steps))
    st, scene, params = env._state, env.scene, env._npc_expert_params
    lidar = env.config["vehicle_config"]["lidar"]
    npc, ego = st.npc, st.ego
    cand = mixed_traffic.vehicle_candidates(npc, ego)
    N = npc.lane.shape[1]
    obs = torch.cat([*mixed_traffic.road_frame_features(scene, st.sidx, npc),
                     mixed_traffic.nearest_vehicle_features(npc, cand, 4, lidar["distance"]),
                     mixed_traffic.npc_lidar(npc, cand, lidar["num_lasers"], lidar["distance"])],
                    dim=-1).reshape(E * N, -1)
    stages = {
        "expert obs: road frame + navigation": lambda: mixed_traffic.road_frame_features(
            scene, st.sidx, npc),
        "expert obs: vehicle candidates + nearest-4 features": lambda: (
            mixed_traffic.nearest_vehicle_features(
                npc, mixed_traffic.vehicle_candidates(npc, ego), 4, lidar["distance"])),
        f"per-NPC lidar ({E * N} slots x {lidar['num_lasers']} rays x {N + 1} boxes)":
            lambda: mixed_traffic.npc_lidar(npc, cand, lidar["num_lasers"], lidar["distance"]),
        "per-NPC lidar, the plain chain (ops/npc_lidar.py::npc_lidar_plain)":
            lambda: npc_lidar.npc_lidar_plain(*cand[:5], N, lidar["num_lasers"],
                                              lidar["distance"]),
        "expert MLP (275-256-256-4, float32)": lambda: expert_action(params, obs),
    }
    print(json.dumps(dict(phase="mixed_traffic", card=card, num_envs=E, npc_slots=N,
                          steps=args.steps, **row, stages=stage_profile(stages))), flush=True)
    del env, obs

    env = MetaDriveEnv(cs.AI_PROTECT_NOISE, device="cuda")
    E = env.num_envs
    act = torch.tensor([0.5, 1.0], device="cuda").expand(E, 2).contiguous()
    env.reset(seed=0)
    row = step_profile(card, "ai_protect_noise", E, lambda: env._step_eager(act), args.steps,
                       args.table, replayed=args.graph and (lambda: env.step(act)))
    row.update(spans=span_stages(lambda: env.step(act), args.steps))
    st = env._state
    rays = (E, env.config["vehicle_config"]["lidar"]["num_lasers"])

    def noise_draws():
        k_noise, k_drop = prng.split(prng.fold_in(env._noise_key, st.step_count.sum())).unbind(-2)
        return prng.normal(k_noise, rays), prng.uniform(k_drop, rays)
    stages = {
        "lidar noise draws (key, normal, uniform)": noise_draws,
    }
    print(json.dumps(dict(phase="ai_protect_noise", card=card, num_envs=E, steps=args.steps,
                          **row, stages=stage_profile(stages))), flush=True)
    return 0


def profile_image(card, args):
    """One JSON line for chip_smoke.py's image_obs phase, its step through
    `step` (the camera frame and its stack live there) with the camera
    split into its stages over the chunks of env rows that `camera.render`
    runs, and one for its top_down phase with the BEV split into the
    texture samples, the stamps and the stack ring."""
    import torch

    import chip_smoke as cs
    from metadrive_ped_torch import MetaDriveEnv, TopDownMetaDrive
    from metadrive_ped_torch.obs import top_down
    from metadrive_ped_torch.ops import camera
    env = MetaDriveEnv(cs.IMAGE_OBS, device="cuda")
    E = env.num_envs
    act = torch.tensor([0.0, 1.0], device="cuda").expand(E, 2).contiguous()
    env.reset(seed=0)
    row = step_profile(card, "image_obs", E, lambda: env._step_eager(act), args.steps,
                       args.table, replayed=args.graph and (lambda: env.step(act)))
    row.update(spans=span_stages(lambda: env.step(act), args.steps))
    st, scene = env._state, env.scene
    modality, w, h = env._sensor_spec()
    cam = env.config["camera"]
    P = w * h
    targets, _ = env._lidar_targets(st)
    rows = max(1, camera.RENDER_CHUNK_ELEMENTS // (P * max(
        scene.lane_kind.shape[1], scene.seg_type.shape[1], targets[0].shape[1], 1)))
    chunks = [slice(a, min(E, a + rows)) for a in range(0, E, rows)]
    fwd = torch.stack([torch.cos(st.ego.heading), torch.sin(st.ego.heading)], dim=-1)
    origin = st.ego.pos + 0.25 * st.ego.params.length[:, None] * fwd
    t_hgt = torch.full(targets[2].shape, 1.5, device="cuda")

    def rays(c):
        return camera.pixel_rays(st.ego.heading[c], w, h, cam["fov"], cam["pitch"],
                                 cam["height"])
    dirs = [rays(c) for c in chunks]
    stages = {
        f"camera: pixel_rays ({len(chunks)} chunks of {rows} rows)": lambda: [
            rays(c) for c in chunks],
        f"camera: ground hit ([rows, {P}, {scene.lane_kind.shape[1]} lanes] local coordinates"
        f" + [rows, {P}, {scene.seg_type.shape[1]} segments] distances)": lambda: [
            camera._ground_hit(scene, st.sidx[c], origin[c], cam["height"], d, 0.0)
            for c, d in zip(chunks, dirs)],
        f"camera: box hits ([rows, {P}, {targets[0].shape[1]} boxes] slabs)": lambda: [
            camera._box_hits(origin[c], cam["height"], d, *(x[c] for x in targets[:4]),
                             t_hgt[c], targets[4][c]) for c, d in zip(chunks, dirs)],
        "camera (whole render, all modalities)": lambda: env._render_frame(st),
        "camera frame, replayed (its graph, core/graph.py)": env._graphs._frame.replay,
        "image obs (render + frame stack)": lambda: env._image_obs(env._last_obs),
    }
    print(json.dumps(dict(phase="image_obs", card=card, num_envs=E, camera=[modality, w, h],
                          chunk_rows=rows, chunks=len(chunks), steps=args.steps, **row,
                          stages=stage_profile(stages))), flush=True)
    del env, dirs

    env = TopDownMetaDrive(cs.TOP_DOWN, device="cuda")
    E = env.num_envs
    act = torch.tensor([0.0, 1.0], device="cuda").expand(E, 2).contiguous()
    env.reset(seed=0)
    row = step_profile(card, "top_down", E, lambda: env._step_eager(act), args.steps,
                       args.table, replayed=args.graph and (lambda: env.step(act)))
    row.update(spans=span_stages(lambda: env.step(act), args.steps))
    st = env._state
    tex, org = env._map_textures()
    R, dist = env.config["resolution"], env.config["max_distance"]
    fwd_ax, side_ax = top_down._pixel_axes(R, R, 2 * dist / R, st.sidx.device)
    fwd_g, side_g, hv, rv, world = top_down._ego_grid(st.ego, fwd_ax, side_ax)
    sample = top_down._sampler(tex, org, st.sidx, world)
    ego, npc = st.ego, st.npc
    K = ego.past_pos.shape[1]
    unit = torch.ones((E, K), device="cuda")
    ones = torch.ones((E, 1), dtype=torch.bool, device="cuda")
    stamp = lambda *a: top_down._stamp_obbs(fwd_g, side_g, hv, rv, ego, *a)
    frame = env._last_obs
    none_done = torch.zeros(E, dtype=torch.bool, device="cuda")
    stages = {
        "BEV ego grid + texture samples (3 layers, 4 corners)": lambda: [
            sample(ch) for ch in range(3)] + [top_down._sampler(tex, org, st.sidx, world)],
        f"BEV stamps: {npc.pos.shape[1]} NPCs": lambda: stamp(
            npc.pos, npc.heading, npc.params.length, npc.params.width, npc.active),
        "BEV stamps: ego box": lambda: stamp(ego.pos[:, None], ego.heading[:, None],
                                             ego.params.length[:, None],
                                             ego.params.width[:, None], ones),
        f"BEV stamps: {K} past positions": lambda: stamp(ego.past_pos, torch.zeros_like(unit),
                                                         unit, unit, unit > 0),
        "stack ring (_assemble)": lambda: env._assemble(frame, none_done),
    }
    print(json.dumps(dict(phase="top_down", card=card, num_envs=E, steps=args.steps, **row,
                          stages=stage_profile(stages))), flush=True)
    return 0


def profile_sharded(card, args):
    """One JSON line for chip_smoke.py's sharded_pg phase: the main path's
    env through ShardedEnv over [cuda:0, cuda:0], its shards' eager loop
    (`_rollout_eager(1)`) and, with --graph, its replayed step
    (`rollout(1)`: each shard's advance and observe graphs), beside the
    unsharded env's replayed step in the same call."""
    import torch

    from chip_smoke import MAIN_PATH
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.parallel import ShardedEnv
    E = args.num_envs
    act = torch.tensor([0.0, 1.0], device="cuda").expand(E, 2).contiguous()
    plain = MetaDriveEnv(dict(MAIN_PATH, num_envs=E), device="cuda")
    plain.reset(seed=0)
    unsharded = _profile_calls(card, "pg_detectors (replayed, unsharded)", E,
                               lambda: plain.rollout(1, actions=act, collect=()), args.steps,
                               args.table)
    del plain
    senv = ShardedEnv(MetaDriveEnv(dict(MAIN_PATH, num_envs=E), device="cuda"), ["cuda:0"] * 2)
    senv.reset(seed=0)
    row = step_profile(card, "sharded_pg", E,
                       lambda: senv._rollout_eager(1, actions=act, collect=()), args.steps,
                       args.table,
                       replayed=args.graph and (lambda: senv.rollout(1, actions=act, collect=())))
    if args.graph:
        row["replayed"]["sharded_over_unsharded_wall"] = (
            unsharded["wall_ms_per_step"] / row["replayed"]["wall_ms_per_step"])
    print(json.dumps(dict(phase="sharded_pg", card=card, num_envs=E, mesh=["cuda:0"] * 2,
                          steps=args.steps, **row, unsharded_replayed=unsharded)), flush=True)
    return 0


def count_ops():
    """Aten operators of one step of chip_smoke.py's envs on the CPU."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import chip_smoke as cs
    import metadrive_ped_torch as port

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def ops(fn):
        with Count() as c:
            fn()
        return c.n

    envs = (("pg_detectors", port.MetaDriveEnv, dict(cs.MAIN_PATH, num_envs=16)),
            ("safe", port.SafeMetaDriveEnv, dict(cs.SAFE, num_envs=16)),
            ("marl", port.MultiAgentRoundaboutEnv, dict(cs.MARL, num_envs=2)),
            ("marl_40", port.MultiAgentRoundaboutEnv, dict(cs.MARL_40, num_envs=2)),
            ("marl_tollgate", port.MultiAgentTollgateEnv, dict(cs.MARL_TOLLGATE, num_envs=2)),
            ("mixed_traffic", port.MixedTrafficEnv, dict(cs.MIXED_TRAFFIC, num_envs=16)),
            ("ai_protect_noise", port.MetaDriveEnv, dict(cs.AI_PROTECT_NOISE, num_envs=16)),
            ("image_obs", port.MetaDriveEnv, dict(cs.IMAGE_OBS, num_envs=4)),
            ("top_down", port.TopDownMetaDrive, dict(cs.TOP_DOWN, num_envs=16)))
    for name, cls, cfg in envs:
        env = cls(cfg, device="cpu")
        act = torch.tensor([[0.0, 1.0]] * env.num_envs)
        env.reset(seed=0)
        env.rollout(3, actions=act, collect=())
        # the AI protector, the camera frame stack and the top-down ring act
        # only through `step`
        step = ((lambda: env.step(act))
                if cfg.get("use_AI_protector") or name in ("image_obs", "top_down")
                else (lambda: env.rollout(1, actions=act, collect=())))
        row = dict(env=name, rows=env.num_envs, step_ops=ops(step))
        if hasattr(env, "_npc_expert_params"):
            st = env._state
            row["expert_traffic_ops"] = ops(lambda: env._expert_traffic(st.sidx, st.npc, st.ego))
        if hasattr(env, "_respawn"):
            every = torch.ones(env.num_envs, dtype=torch.bool)
            row["respawn_ops"] = ops(lambda: env._respawn(env._state, every))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
