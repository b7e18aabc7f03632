#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (metadrive_ped_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from any working directory (it puts its own directory on sys.path),
needs one CUDA device, and prints one JSON line per phase. Every env steps
on the card as the port's users step it: each `step` and `rollout` step is
one replay of the step captured as a CUDA graph at the first call for its
key (metadrive_ped_torch/core/graph.py); capture synchronises, so the step
checked under set_sync_debug_mode("error") is a replayed one, and every
phase line that steps an env carries "graph": whether its steps replayed
(a ShardedEnv's: each shard's graphs, every step; an image env's: its
camera frame's graph too), and fails where one did not.

1. device        the card (nvidia-smi name and power limit), torch and CUDA
2. build         nvcc of every kernel, its seconds and ptxas registers/smem
3. kernel_vs_plain  the detector-cloud kernel against its plain torch
                 version at the main path's shapes (E=8192, side 160 rays
                 at 50 m and lane-line 12 at 20 m, the pack's line table)
                 and on the cases of `line_cases` (ragged E, S and table
                 rows, n_cont = 0, Rs = 300, Rs = 0, Rl = 0, Rl = 40, exact
                 boundary geometry); max_abs_err must be <= 1e-5 and the
                 hits (out < 1) of both equal; kernel (CUDA events over a
                 loop of calls, and the profiler's device time of one
                 launch), plain and roofline-bound times
4. env           the main path at full width: the `pg` bench protocol
                 (bench.py:28-32, 8192 envs) with lidar 240, side detector
                 160 and lane-line detector 12 lasers, full throttle for 200
                 steps (0-98 through `step`, 99-200 through `rollout`);
                 env-steps/s over steps 100-200, obs checks, episodes
                 finished, kernel launches (must be steps + 1), and the
                 second step under torch.cuda.set_sync_debug_mode("error");
                 then graph_vs_eager on it (36)
5. card_vs_cpu   32 envs for 20 steps on the card and on the CPU: obs and
                 reward within 1e-4, discrete flags equal
6. scenario_replay  ScenarioEnv at the reference's replay-FPS protocol
                 (bench.py:57-70, 4096 envs): 16 synthetic Waymo-scale
                 scenarios, replayed ego, lidar 120, side detector 160
                 (lane-line 12, which ScenarioEnv ignores); the kernel
                 against its plain version on the env's line table (no
                 continuous line on these maps: n_cont = 0), then 200 steps
                 through `rollout`, the second under
                 torch.cuda.set_sync_debug_mode("error"): env-steps/s over
                 steps 100-200, obs checks, launches (steps + 1)
7. scenario_reactive  bench.py:48-56: the same scenarios at 4096 envs with
                 reactive IDM traffic and the default sensors (side 12,
                 lidar 120); as 6, plus episodes finished and the largest
                 reactive arc position
8. scenario_lines  the scenario_recorded protocol (bench.py:71-82) with the
                 side detector at 160: 100 steps of the PG env (16 envs,
                 map=3) exported on the card, replayed at 1024 envs with
                 reactive traffic for 200 steps (episodes truncate at 100 and
                 auto-reset); the kernel against its plain version on the
                 env's table of real lines first (side hits must be > 0);
                 then graph_vs_eager on it (36)
9. scenario_card_vs_cpu  32 envs for 20 steps of 8 on the card and on the
                 CPU: obs and reward within 1e-4, every bool flag equal
10. safe         SafeMetaDriveEnv at the `safe` bench protocol
                 (bench.py:33-36, 4096 envs, 16 scenarios): cylinder bodies,
                 crashes that cost and do not end the episode; as 6, with
                 the crash_vehicle / crash_object / crash_human counts (one
                 at least) and no kernel launch (the detectors are off)
11. marl         MultiAgentRoundaboutEnv at the `marl` protocol
                 (bench.py:37-41): 512 envs x 8 agents = 4096 rows; as 6,
                 with env-steps/s, agent-steps/s, agent terminations and
                 respawns, and no kernel launch
12. marl_40      the same scene at `marl_40` (bench.py:42-47): 256 envs x
                 40 agents = 10,240 rows; as 11, and one respawn at least
13. marl_tollgate  MultiAgentTollgateEnv, 256 envs x 40 agents: the kernel
                 against its plain version on the tollgate's line table
                 (side 72 and lane-line 4 rays at 20 m, side hits > 0),
                 then as 11 with steps + 1 launches; then graph_vs_eager
                 on it (36)
14. marl_card_vs_cpu  roundabout 4 x 8 and tollgate 2 x 8 for 20 steps on
                 the card and on the CPU: obs and reward within 1e-4, every
                 bool flag, dead_timer and slot equal
15. mixed_traffic  MixedTrafficEnv at the main path's width (8192 envs,
                 map=3, 16 scenarios, horizon 1000, side 160, lane-line 12)
                 with traffic 0.1 and rl_agent_ratio 0.5: every NPC slot
                 builds the expert's 275-dim observation with its own
                 240-ray lidar and runs the 275-256-256-4 MLP; the kernel
                 against its plain version on the env's line table, then as
                 4 through `rollout` (steps + 1 launches, one step under
                 set_sync_debug_mode("error")), with the kernel launches a
                 step and device busy ms from the profiler, the expert
                 slots (in the packs, and active and released at the end)
                 and peak device memory; the per-NPC lidar kernel launched
                 once a step, then against its plain version on the last
                 state (error 0.0, hits equal), with both times and the
                 bound by operations (npc_lidar_vs_plain)
16. ai_protect_noise  MetaDriveEnv at 8192 envs (map=3, 16 scenarios,
                 traffic 0.05) with the AI protector (save_level 0.5; the
                 expert's lidar 240 and 4 neighbours) and lidar noise
                 (gaussian 0.05, dropout 0.1), steering 0.5 at full
                 throttle, through `step` for 200 steps (the protector reads
                 the previous observation only there): env-steps/s,
                 takeovers counted (one at least), no kernel launch, the
                 second step under set_sync_debug_mode("error")
17. slice4_card_vs_cpu  as 5 for 20 steps at small widths on MixedTrafficEnv,
                 the lane-change policy, the AI protector with noise, the
                 roundabout with rl_agent_ratio 0.5, and the bottleneck and
                 bidirection scenes (the multi-agent paths through the
                 kernel that no other phase drives)

18. marl_parking_lot, marl_racing, marl_tinyinter  the three scenes no
                 other phase drives: each first against the CPU (4 envs x
                 the scene's default agents, 20 steps, a marl_card_vs_cpu
                 line), then as 11 at 256 envs for 100 steps
19. mix_waymo_pg MixWaymoPGEnv at 4096 envs over the synthetic scenes of 6
                 and a PG map 3, both with the replay protocol's detectors:
                 the kernel against its plain version on each half, then 4
                 resets x 50 steps (both suites must run; one launch at each
                 reset and each step; each suite's first reset captures its
                 step and checks a replayed one for host syncs, untimed)
20. opendrive    a PG env on the two-road OpenDrive map at 8192 envs
                 (traffic 0.2, side 160, lane-line 12): the kernel against
                 its plain version on the map's lines, then as 4, and the
                 card against the CPU at 32 envs for 20 steps
21. snapshot_replay  the main path at 8192 envs: snapshot at step 50, 20
                 steps, restore, the same 20 steps again (obs, reward and
                 state bit-equal); set_break_down on the even rows (their
                 speed falls); record_episode(20) at 256 envs, replay of
                 frame 4 and one step equal to frame 5; a dump_all_maps
                 reload with a bit-equal pack
22. image_obs    the camera observation: the main path's env (map 3, 16
                 scenarios, traffic 0.05, lidar 240, side 160, lane-line 12)
                 at 1024 envs with an 84x84 rgb camera and a stack of 3:
                 the kernel against its plain version on the env's line
                 table, then 100 steps through `step` at full throttle
                 (each a replay of the step's graph and of the camera
                 frame's): env-steps/s over steps 50-100, the camera's
                 launches and device ms per frame inside its graph and a
                 step's, with its host API calls, from the profiler, peak
                 device memory (at most 16 GB), kernel launches (steps + 1
                 of the detector kernel: the state half; steps + 1 of the
                 camera kernel, `camera.launches`), the second step under
                 set_sync_debug_mode("error"), image and state finite in
                 [0, 1]; then the camera kernel against the plain chain on
                 the state after the steps (camera_vs_plain: every modality
                 bit-equal, the kernel's ms by events and by the profiler,
                 the plain chain's ms, the frame's bound `camera_pairs_bound`)
23. camera_modalities  depth, semantic, instance and the mini map at the
                 same config and pack, 10 steps each: shapes, ranges,
                 steps + 1 launches each
24. top_down     TopDownMetaDrive (frame_stack 3, 84x84) at 4096 envs for
                 100 steps through `step`: env-steps/s, launches and device
                 ms of a step and of the BEV, peak memory, no kernel launch
25. render_card_vs_cpu  4 envs of the image_obs config for 20 steps on the
                 card, the state copied to the CPU every 5 steps: every
                 camera modality, the mini map, the top-down frame at 50 m
                 and 30 m and the three render modes against the CPU at the
                 CPU tests' tolerances (obs/pixel_check.py), and the stacked
                 top-down ring bit-equal to the CPU's on the card's frames
26. ppo_train    the train_ppo example's configuration at the `pg` width
                 (8192 envs, map=3, 64 scenarios, traffic 0.05, lidar 240
                 and 4 neighbours): 3 iterations of a 128-step collection
                 through `rollout` with the sampling policy (one step under
                 set_sync_debug_mode("error"); a new policy closure each
                 iteration captures once, as JAX re-jits), GAE, and a PPO
                 update of
                 4 epochs x 8 minibatches of 131,072 rows; one line per
                 iteration (collect env-steps/s, update ms, samples/s, loss,
                 parameter change) and a summary (finite losses, parameters
                 that moved, TF32 off; launches and device ms of a
                 collection step and of an update minibatch, from the
                 profiler); then graph_vs_eager on one collection of the
                 trained policy (36). It runs last: after its profiled
                 update, the profiles of later phases saw no launch of the
                 detector kernel
27. ppo_card_vs_cpu  one update (1 epoch, 2 minibatches) of 131,072 rows of
                 the last batch from the same parameters and permutation on
                 the card and on the CPU: the first minibatch's gradients
                 per leaf within 1e-5 of the leaf's largest gradient, a
                 limit that the card's gradients with TF32 on (the control)
                 must exceed; the parameters within 1e-5 except where
                 Adam's first step amplifies the gradients' rounding
                 difference past 5e-6 (gradients near zero), at most 16
                 such elements

28. sharded_pg   (28-32 run after 25 and before 26, which runs last) the
                 data-parallel layer (metadrive_ped_torch/parallel):
                 the main path's config (8192 envs) unsharded and through
                 ShardedEnv over [cuda:0, cuda:0] (and over every device
                 where there are more), 200 steps each as 4 through
                 `rollout`: the largest obs and reward gaps (at most 1e-5
                 and 1e-6, tests/test_parallel.py's tolerance), flags
                 equal, env-steps/s of both and their ratio, kernel
                 launches, device ms, host API calls and the kernel's
                 device ms a replayed step of both (profiler; sharded,
                 each shard's graphs replay), kernel launches shards x
                 (steps + 1), each shard's on its own device, and one more
                 step of both under set_sync_debug_mode("error"), a
                 replay; then the kernel against its plain version at the
                 first shard's shapes (E = 4096)
29. sharded_noise  as 28 with lidar noise (gaussian 0.05, dropout 0.1: the
                 key folds in the whole batch's step counts, each shard
                 draws its rows of the batch's noise), 10 steps
30. sharded_marl MultiAgentRoundaboutEnv at 256 envs x 8 agents, sharded by
                 whole envs, 10 steps; no kernel launch
31. sharded_scenario  ScenarioEnv with reactive traffic on the synthetic
                 scenes at 1024 envs, 50 steps
32. distributed  two processes on cuda:0 through init_distributed (gloo,
                 a file:// store, every wait with a timeout), each the main
                 path's config at 4096 envs with worker_index = rank and
                 num_workers = 2, 50 steps: disjoint scenario strides, the
                 all-gathered mean rewards equal on both ranks, steps + 1
                 kernel launches in each, one more step under
                 set_sync_debug_mode("error")

33-34. marl_bottleneck, marl_bidirection  (33-35 run after 32 and before 26)
                 the two other multi-agent scenes whose detectors (side 4
                 and lane-line 4 rays) put the kernel on the multi-agent
                 path, at 256 envs x the scene's default 20 agents: each
                 first the kernel against its plain version on the env's
                 line table (side hits > 0), then as 13 for 100 steps
                 (steps + 1 launches)
35. bench_torch  `python3 bench_torch.py --config all --steps 100` in a child
                 process at bench.py's default widths (pg 8192, safe 4096,
                 marl 512 x 8, marl_40 256 x 40, scenario and
                 scenario_replay 4096), then `--config scenario_recorded`
                 (1024 envs): every family's rate above 0, the last line
                 with bench.py's keys, and the kernel launched once a
                 timed step in the scenario families (their side
                 detector) and never in the others, every timed call a
                 graph replay

36. graph_vs_eager  beside 4, 8, 13 and 26: from one reset, the eager loop
                 (`_rollout_eager`) and the replayed `rollout`, the first
                 two steps collecting no reward (the second under
                 set_sync_debug_mode("error") in both), over 200 steps of
                 the main path (both rates over steps 100-200) and 50 of
                 scenario_lines, marl_tollgate and a PPO collection: obs,
                 reward, terminated, truncated, the final state and last
                 observation bit-equal, kernel launches equal
37. cuda_tests   after 5: `python -m pytest tests/test_torch_cuda.py -m cuda
                 --noconftest` in a child process (the kernel's cases and,
                 with CUDA graphs, replay against eager bit for bit on PG
                 with detectors, ScenarioEnv with lines, the tollgate, PPO's
                 collection and restore between replays, and a policy that
                 cannot be captured raising): every test passes, none skips

The expert's products need float32 matmuls in full precision: the device
phase asserts that TF32 is off. Then the kernels line (the ray-segment
kernel's launches summed over the env phases 4, 6-8, 10-13, 15-16, 18-24,
28-35; the per-NPC lidar kernel's over the whole run), the card's name and
power limit, and last {"ok": true, "device": {...}}. Any failed phase
raises and exits non-zero.
"""
import json
import math
import os
import subprocess
import sys
import time
from operator import attrgetter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# The main path: bench.py's `pg` protocol with the detectors of the
# reference's Waymo FPS protocol (bench.py:57-70) switched on.
MAIN_PATH = dict(num_envs=8192, map=3, num_scenarios=16, traffic_density=0.05, horizon=1000,
                 vehicle_config=dict(lidar=dict(num_lasers=240),
                                     side_detector=dict(num_lasers=160),
                                     lane_line_detector=dict(num_lasers=12)))
# The scenario phases: bench.py's `scenario_replay` and `scenario` families
# (4096 envs, bench.py:345-346) on 16 synthetic Waymo-scale scenarios, and
# its `scenario_recorded` protocol (1024 envs) on 16 PG exports.
SCENARIO_REPLAY = dict(num_envs=4096, replay_ego=True,
                       vehicle_config=dict(lidar=dict(num_lasers=120),
                                           side_detector=dict(num_lasers=160),
                                           lane_line_detector=dict(num_lasers=12)))
SCENARIO_REACTIVE = dict(num_envs=4096, reactive_traffic=True)
SCENARIO_LINES = dict(num_envs=1024, reactive_traffic=True,
                      vehicle_config=dict(side_detector=dict(num_lasers=160)))
LINES_SOURCE = dict(num_envs=16, num_scenarios=16, map=3, traffic_density=0.1)
SYNTHETIC_SCENARIOS = 16
# The safe and multi-agent phases: bench.py's `safe` (bench.py:33-36),
# `marl` (:37-41) and `marl_40` (:42-47) families at their widths (:344),
# and the tollgate scene at the marl_40 width, whose detectors put the
# ray-segment kernel on the multi-agent path (side 72, lane-line 4).
SAFE = dict(num_envs=4096, num_scenarios=16, horizon=1000)
MARL = dict(num_envs=512, num_agents=8)
MARL_40 = dict(num_envs=256)
MARL_TOLLGATE = dict(num_envs=256)
MARL_CPU = (("MultiAgentRoundaboutEnv", dict(num_envs=4, num_agents=8)),
            ("MultiAgentTollgateEnv", dict(num_envs=2, num_agents=8)))
# The agent-policy phases: the main path with half the NPC slots driven by
# the PPO expert, and the PG env with the AI protector and lidar noise.
MIXED_TRAFFIC = dict(MAIN_PATH, traffic_density=0.1, rl_agent_ratio=0.5)
AI_PROTECT_NOISE = dict(num_envs=8192, map=3, num_scenarios=16, traffic_density=0.05, horizon=1000,
                        use_AI_protector=True, save_level=0.5,
                        vehicle_config=dict(lidar=dict(num_lasers=240, num_others=4,
                                                       gaussian_noise=0.05, dropout_prob=0.1)))
EXPERT_LIDAR = dict(lidar=dict(num_lasers=240))
MULTI = ("dead_timer", "ego.slot")
# (class, config, action, integer state compared) of the card-against-CPU
# runs of the agent-policy configurations
SLICE4_CPU = (
    ("MixedTrafficEnv", dict(MIXED_TRAFFIC, num_envs=32), (0.0, 1.0), ()),
    ("MetaDriveEnv", dict(num_envs=32, map=3, num_scenarios=16, traffic_density=0.05,
                          agent_policy="lane_change", discrete_action=True,
                          use_multi_discrete=True), (2, 4), ()),
    ("MetaDriveEnv", dict(AI_PROTECT_NOISE, num_envs=32), (0.5, 1.0), ()),
    ("MultiAgentRoundaboutEnv", dict(num_envs=4, num_agents=8, traffic_density=0.3,
                                     rl_agent_ratio=0.5, vehicle_config=EXPERT_LIDAR),
     (0.0, 1.0), MULTI),
    ("MultiAgentBottleneckEnv", dict(num_envs=4, num_agents=8), (0.0, 1.0), MULTI),
    ("MultiAgentBidirectionEnv", dict(num_envs=4, num_agents=8), (0.0, 1.0), MULTI),
)
# The trainer's surface: the train_ppo example's configuration at the `pg`
# width (bench.py:344, 8192 envs); MixWaymoPGEnv over the synthetic scenes and
# a PG map 3 with the replay protocol's detectors (bench.py:57-70); a PG env
# on the two-road OpenDrive map with the main path's detectors;
# snapshot/record/replay on the main path; the three multi-agent scenes no
# other phase drives, at 256 envs.
PPO_ENVS, PPO_SCENARIOS, PPO_ROLLOUT, PPO_EPOCHS, PPO_MINIBATCHES, PPO_ITERS = 8192, 64, 128, 4, 8, 3
PPO_CPU_ROWS = 131072
# ppo_card_vs_cpu: the card's and the CPU's float32 gradients round apart.
# Per leaf, max|g_card - g_cpu| / max|g_cpu| stays under PPO_GRAD_RTOL, which
# the same card gradients with TF32 on (the control) must exceed. Adam's first
# step, lr * g / (|g| + 1e-8), keeps the rounding difference small except where
# g is near zero: at most PPO_EXEMPT_CAP such elements are exempt from PPO_TOL.
PPO_LR, PPO_TOL, PPO_GRAD_RTOL, PPO_EXEMPT_CAP = 3e-4, 1e-5, 1e-5, 16
MIX_WAYMO_PG = dict(num_envs=4096, map=3, vehicle_config=SCENARIO_REPLAY["vehicle_config"])
MIX_RESETS, MIX_STEPS = 4, 50
OPENDRIVE = dict(num_envs=8192, num_scenarios=1, traffic_density=0.2, horizon=1000,
                 vehicle_config=MAIN_PATH["vehicle_config"])
SNAP_AT, SNAP_STEPS, BREAK_STEPS, RECORD_ENVS, RECORD_STEPS = 50, 20, 40, 256, 20
UNTRIED_SCENES = (("marl_parking_lot", "MultiAgentParkingLotEnv"),
                  ("marl_racing", "MultiAgentRacingEnv"),
                  ("marl_tinyinter", "MultiAgentTinyInter"))
UNTRIED_ENVS, UNTRIED_STEPS = 256, 100
EXPORT_STEPS = 100
# The pixel observations: the main path's env with an 84x84 rgb camera and
# a stack of 3 (its state half runs the detectors, so the kernel), at 1024
# envs; the other camera modalities and the mini map on the same pack; the
# stacked top-down env at 4096 envs; card against CPU at 4 envs.
IMAGE_OBS = dict(MAIN_PATH, num_envs=1024, image_observation=True, stack_size=3,
                 sensors=dict(main_camera=("rgb", 84, 84)))
IMAGE_STEPS, IMAGE_TIMED_FROM, MODALITY_STEPS = 100, 50, 10
MODALITIES = (("depth", 1), ("semantic", 3), ("instance", 3), ("mini_map", 3))
TOP_DOWN = dict(num_envs=4096, map=3, num_scenarios=16, traffic_density=0.05, horizon=1000)
RENDER_CPU_ENVS, RENDER_CPU_STEPS, RENDER_CHECK_EVERY = 4, 20, 5
# the tolerances of tests/test_torch_camera.py and test_torch_top_down.py;
# a pixel beyond them must be one that float32 rounding can decide
# (metadrive_ped_torch/obs/pixel_check.py)
CAMERA_TOL = dict(depth=1e-5, rgb=1e-5, semantic=0.0, instance=1e-6)
# float32 operations of the camera (ops/camera.py) per pixel and primitive,
# a transcendental (atan2, sqrt, reciprocal) counted as one, so the bound
# is a least time: a (pixel, segment) pair 25 (offsets 2, projection 6,
# closest point 6, distance 4, threshold 2, masks 5), a (pixel, lane) pair
# 52 (local_coordinates 43, the region test 9), a (pixel, box) pair 50
# (rotation 7, three slabs 30, entry / exit / hit 8, nearest 5)
CAMERA_OPS = dict(segment=25, lane=52, box=50)
CAMERA_OUT_FLOATS = 10  # depth 1, semantic 3, rgb 3, instance 3 per pixel
# The data-parallel phases: the main path, the main path with lidar noise,
# the `marl` scene at 256 x 8 and the reactive scenario replay at 1024
# envs, unsharded and sharded; then two processes on one card.
SHARDED_NOISE = dict(MAIN_PATH, vehicle_config=dict(
    MAIN_PATH["vehicle_config"], lidar=dict(num_lasers=240, gaussian_noise=0.05,
                                            dropout_prob=0.1)))
SHARDED_MARL = dict(num_envs=256, num_agents=8)
SHARDED_SCENARIO = dict(SCENARIO_REACTIVE, num_envs=1024)
SHARDED_NOISE_STEPS, SHARDED_MARL_STEPS, SHARDED_SCENARIO_STEPS = 10, 10, 50
SHARD_OBS_TOL, SHARD_REWARD_TOL = 1e-5, 1e-6
DIST_ENVS, DIST_STEPS, DIST_TIMEOUT = 4096, 50, 300
# The two multi-agent scenes whose detectors put the kernel on the path
# besides the tollgate, at 256 envs x the scene's default agents; then
# bench_torch.py (the port's bench.py) at its default widths, in a child
# process. The scenario families' envs carry a side detector: the kernel
# launches once a timed step there and never in the other families.
KERNEL_SCENES = (("marl_bottleneck", "MultiAgentBottleneckEnv"),
                 ("marl_bidirection", "MultiAgentBidirectionEnv"))
KERNEL_SCENE_ENVS, KERNEL_SCENE_STEPS = 256, 100
BENCH_STEPS, BENCH_TIMEOUT = 100, 900
BENCH_ROWS = dict(pg=8192, safe=4096, marl=512 * 8, marl_40=256 * 40, scenario=4096,
                  scenario_replay=4096, scenario_recorded=1024)
BENCH_DETECTORS = ("scenario", "scenario_replay", "scenario_recorded")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
# The graph-against-eager phase: from one reset, the eager loop and the
# replayed rollout (metadrive_ped_torch/core/graph.py) on the main path (STEPS
# steps, both rates over steps TIMED_FROM-STEPS), scenario_lines,
# marl_tollgate and one PPO collection (GRAPH_STEPS steps each); then the
# card-only tests in a child process.
GRAPH_STEPS = 50
# replayed steps of the main path whose kernel runs the profiler counts
PROFILED_STEPS = 10
GRAPH_COLLECT = ("obs", "reward", "terminated", "truncated")
CUDA_TESTS, CUDA_TESTS_TIMEOUT = ("tests/test_torch_cuda.py",), 600
DEVICE = "cuda"
STEPS = 200
TIMED_FROM = 100
KERNEL_TOL = 1e-5
CPU_TOL = 1e-4
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): dense float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per (ray, line) pair of the ray-segment sweep:
# denom 3 (2 mul, 1 sub), |denom| guard 2, rel 2, t 4 (2 mul, sub, div),
# u 4, hit tests 3, scale 1 (div), clip 2
OPS_PER_PAIR = 21
# float32 operations the per-NPC lidar needs (ops/raycast.py::ray_obb_fraction),
# each an instruction of its own (-fmad=false): per (ray, box) pair that can
# count, dx and dy in the box frame 6 (4 mul, 2 add), the |d| < 1e-9 guards
# 6 (abs, compare, select), reciprocals 2, slab times 4 (mul), slab min /
# max 6, tests 3 (tmax >= tmin, tmax >= 0, tmin >= 0), selects 2 (t, hit),
# the min over boxes 1; per ray, its fan direction 6 (4 mul, 2 add), the
# scale 1 and the clamp 2; per (slot, box), its origin in the box frame 8
# (relx, rely, 4 mul, 2 add), the half sizes 2 and the slab numerators 4
NPC_LIDAR_OPS_PER_PAIR = 30
NPC_LIDAR_OPS_PER_RAY = 9
NPC_LIDAR_OPS_PER_SLOT_BOX = 14
# one-operation float32 instructions a second: 132 SMs x 128 lanes x 1.98
# GHz (PEAK_FP32_OPS counts an FMA as two)
PEAK_FP32_INSTR = 33.5e12


def emit(**fields):
    """Print a phase's line. A line whose "graph" (at its top or in a
    nested dict) is false fails the phase after it is printed."""
    print(json.dumps(fields), flush=True)
    for row in [fields] + [v for v in fields.values() if isinstance(v, dict)]:
        if row.get("graph") is False:
            raise AssertionError(f"{fields.get('phase')}: a step did not replay a CUDA graph: "
                                 f"{json.dumps(fields)[:400]}")


def replays(env):
    """The CUDA-graph replays of ``env`` so far (metadrive_ped_torch/core/graph.py)."""
    graphs = getattr(env, "_graphs", None)
    return graphs.replays if graphs is not None else 0


def shard_replays(env):
    """Each shard's replayed steps so far, for a ShardedEnv (its graphs
    count them, core/graph.py::ShardedGraphs); [] for another env."""
    if not hasattr(env, "shards"):
        return []
    return list(env._graphs.shard_replays) if env._graphs else [0] * len(env.shards)


def replayed(env, steps, before=0):
    """Whether each of the ``steps`` steps that ``env`` took through `step`
    and `rollout` since it had ``before`` replays was one replay: the
    phase's "graph" field."""
    return replays(env) - before == steps


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


# ---- inputs of the detector-cloud kernel ----------------------------------
# A case is (origin [E,2], sidx [E], side (dx, dy) [E,Rs], lane (dx, dy)
# [E,Rl], side_dist, lane_dist, table [S,Bl,4], counts [S,2]) as numpy
# arrays; the tests use the same cases on the CPU.

def random_line_case(E, S, Bl, Rs, Rl, seed, counts=None):
    """Random segments in a 60 m square around origins in a 10 m one, each
    scenario with random (n_cont, n_any) unless ``counts`` is given."""
    import numpy as np
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    if counts is None:
        n_any = rng.randint(1, Bl + 1, S)
        n_any[0] = Bl
        counts = np.stack([rng.randint(0, n_any + 1), n_any], axis=1)
    counts = np.asarray(counts, np.int32)
    # s = p1 - p0 rounded in float32, as build_line_table makes it
    p0 = f32(rng.uniform(-30, 30, (S, Bl, 2)))
    p1 = f32(p0 + rng.uniform(-10, 10, (S, Bl, 2)))
    table = np.concatenate([p0, p1 - p0], -1)
    table[np.arange(Bl)[None, :] >= counts[:, 1:2]] = 0.0

    def fan(R):
        ang = rng.uniform(-np.pi, np.pi, (E, R))
        return f32(np.cos(ang)), f32(np.sin(ang))
    return (f32(rng.uniform(-5, 5, (E, 2))), rng.randint(0, S, E).astype(np.int32), fan(Rs), fan(Rl),
            50.0, 20.0, f32(table), counts)


def adversarial_line_case(E=2048, seed=3, subnormal=True):
    """Exact boundary geometry on integer coordinates: each env has its own
    scenario of one segment that puts a pair of one of eight rays (the axes
    and the diagonals, every env carries all eight) on a hit/miss boundary:
    u exactly 0 or 1, the origin on the segment or at its end (t = 0),
    segments parallel or collinear to the ray (|d x s| < 1e-9), zero-length
    segments on and off the ray, segments behind the origin, |d x s|
    just below, at and above the 1e-9 guard, and a segment start a
    subnormal distance from the origin (t and u of a subnormal over a
    normal number, which may round to -0; with ``subnormal=False`` those
    envs take the u = 0 geometry instead). The side detector sees the
    segment in two envs of three, the lane-line detector in all."""
    import numpy as np
    rng = np.random.RandomState(seed)
    c = np.float32(np.sqrt(0.5))
    steps = np.array([(1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, 1), (-1, -1), (1, -1)],
                     np.float32)
    dirs = np.array([(1, 0), (0, 1), (-1, 0), (0, -1), (c, c), (-c, c), (-c, -c), (c, -c)],
                    np.float32)
    origin = rng.randint(-20, 21, (E, 2)).astype(np.float32)
    table = np.zeros((E, 1, 4), np.float32)
    for i in range(E):
        D = steps[i % 8]
        perp = np.array([-D[1], D[0]], np.float32)
        k = float(rng.randint(1, 60))
        s = rng.randint(-10, 11, 2).astype(np.float32)
        while s[0] * D[1] == s[1] * D[0]:     # not parallel to the ray
            s = rng.randint(-10, 11, 2).astype(np.float32)
        n = float(rng.choice([-7, -3, -1, 1, 2, 5]))
        o = origin[i]
        P = o + k * D
        kind = (i // 8) % 12
        if kind == 10 and i % 8 < 4:
            # an axis ray against a segment of length eps across it, on
            # integer coordinates with the cross axis at 0: |d x s| = eps
            j = 0 if D[0] != 0 else 1
            o[1 - j] = 0.0
            a = o + k * D
            seg = np.zeros(2, np.float32)
            seg[1 - j] = [3e-10, -3e-10, 1e-9, 2e-9, -2e-9, 5e-10][(i // 96) % 6]
        elif kind == 11 and subnormal:
            o[:] = 0.0
            a = rng.randint(-3, 4, 2).astype(np.float32) * np.float32(1e-45)
            seg = s
        else:
            a, seg = [
                (P, s),                        # u = 0
                (P - s, s),                    # u = 1
                (o - s, 2 * s),                # the origin in the middle: t = 0
                (o, s),                        # the origin at an end: t = 0, u = 0
                (P + n * perp, n * D),         # parallel, beside the ray
                (P, n * D),                    # collinear with the ray
                (P, 0 * s),                    # zero length, on the ray
                (P + perp, 0 * s),             # zero length, off the ray
                (o - k * D, s),                # behind the origin, u = 0
                (o - k * D - s, s),            # behind the origin, u = 1
                (P, s),                        # kind 10 on a diagonal
                (P, s),                        # kind 11 without subnormals
            ][kind]
        table[i, 0] = (*a, *seg)
    n_cont = np.where(np.arange(E) % 3 == 2, 0, 1)
    counts = np.stack([n_cont, np.ones(E, np.int64)], axis=1).astype(np.int32)
    # the side fan adds 8 random rays to the eight
    ang = rng.uniform(-np.pi, np.pi, (E, 8))
    lane = tuple(np.ascontiguousarray(np.tile(dirs[:, j], (E, 1))) for j in (0, 1))
    side = (np.concatenate([lane[0], np.cos(ang).astype(np.float32)], 1),
            np.concatenate([lane[1], np.sin(ang).astype(np.float32)], 1))
    return origin, np.arange(E, dtype=np.int32), side, lane, 50.0, 20.0, table, counts


def line_cases():
    """The named cases of the kernel_vs_plain phase beside the main path."""
    return {
        "ragged_E_S_Bl": lambda: random_line_case(4097, 7, 1500, 160, 12, seed=1),
        "n_cont_0_n_any_1": lambda: random_line_case(1024, 64, 1, 160, 12, seed=2,
                                                     counts=[[0, 1]] * 64),
        "Rs_300": lambda: random_line_case(7, 3, 777, 300, 12, seed=3),
        "Rs_0": lambda: random_line_case(65, 5, 600, 0, 12, seed=4),
        "Rl_0": lambda: random_line_case(65, 5, 600, 160, 0, seed=5),
        "Rl_40": lambda: random_line_case(65, 5, 600, 160, 40, seed=6),
        "adversarial": adversarial_line_case,
    }


def to_device(case, device):
    import torch
    t = lambda a: torch.as_tensor(a).to(device)
    origin, sidx, side, lane, side_dist, lane_dist, table, counts = case
    return (t(origin), t(sidx), tuple(map(t, side)), tuple(map(t, lane)), side_dist, lane_dist,
            t(table), t(counts))


# ---- inputs of the per-NPC lidar kernel -----------------------------------
# A case is (pos [E,C,2], heading, length, width [E,C] float32, active [E,C]
# bool, num_slots N, num_lasers R, distance), the arguments of
# ops/npc_lidar.py::npc_lidar, with numpy arrays; the tests use the same
# cases on the CPU.

def random_npc_case(E, N, R, seed, p_active=0.7):
    """E envs of N NPC slots and an ego (always active), C = N + 1 vehicles
    of random heading and size in a 60 m square, so that most fans see
    several bodies, and a slot's origin lies inside another body now and
    then."""
    import numpy as np
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    C = N + 1
    active = rng.rand(E, C) < p_active
    active[:, N] = True
    return (f32(rng.uniform(-30, 30, (E, C, 2))), f32(rng.uniform(-np.pi, np.pi, (E, C))),
            f32(rng.uniform(3.5, 5.5, (E, C))), f32(rng.uniform(1.6, 2.4, (E, C))), active,
            N, R, 50.0)


def edge_npc_case(R=16):
    """Exact geometry on the hit/miss boundary, on boxes of heading 0 (cos 1
    and sin 0 exactly) seen by slot 0 of heading 0 (its ray 0 points along
    +x exactly), one env each; 3 slots and the ego, the bodies not named
    far from slot 0:
    0: ray 0 parallel to box 1's x axis (dy = 0, the 1e-9 guard), a hit at 8;
    1: slot 0 inside box 1, so every ray's t is its exit point;
    2: slot 0 on box 1's corner (ox = hx, oy = -hy): ray 0 grazes it with
       tmax == tmin == 0;
    3: box 1 of zero length across ray 0: tmax == tmin == 5;
    4: every body inactive, the ego too: every ray reads 1;
    5: slot 1's heading NaN (its fan reads 1, and no fan sees it), box 2 at
       a NaN position, the ego of infinite length (its slab times are
       infinite, not NaN)."""
    import numpy as np
    E, N = 6, 3
    pos = np.zeros((E, N + 1, 2), np.float32)
    pos[:, 1:] = [(0.0, 200.0), (-150.0, -150.0), (150.0, -150.0)]
    heading = np.zeros((E, N + 1), np.float32)
    length = np.full((E, N + 1), 4.0, np.float32)
    width = np.full((E, N + 1), 2.0, np.float32)
    active = np.ones((E, N + 1), bool)
    pos[0, 1] = (10.0, 0.5)
    pos[1, 0], pos[1, 1] = (10.0, 0.0), (10.5, 0.2)
    pos[2, 0], pos[2, 1] = (2.0, -1.0), (0.0, 0.0)
    pos[3, 1], length[3, 1] = (5.0, 0.0), 0.0
    active[4] = False
    pos[5, 1], pos[5, 2] = (10.0, 0.0), (np.nan, 0.0)
    heading[5, 1], length[5, 3] = np.nan, np.inf
    pos[5, 3] = (0.0, 20.0)
    return pos, heading, length, width, active, N, R, 50.0


def npc_lidar_cases():
    """The named cases of the npc_lidar kernel against its plain version."""
    return {
        "cell_like": lambda: random_npc_case(512, 13, 240, seed=1),
        "ragged_E_N_R": lambda: random_npc_case(37, 5, 37, seed=2),
        "N_1": lambda: random_npc_case(64, 1, 240, seed=3),
        "mostly_inactive": lambda: random_npc_case(64, 13, 240, seed=4, p_active=0.15),
        "C_above_tile": lambda: random_npc_case(3, 300, 64, seed=5),
        "R_600": lambda: random_npc_case(5, 4, 600, seed=6),
        "edges": edge_npc_case,
    }


def npc_to_device(case, device):
    import torch
    *arrays, N, R, distance = case
    return (*(torch.as_tensor(a).to(device) for a in arrays), N, R, distance)


def kernel_device_ms(fn, iters, kernel="detector_clouds_kernel"):
    """Device time (ms) of one launch of the named kernel (by default the
    detector-cloud kernel), from torch.profiler's CUDA kernel records over
    ``iters`` calls of fn(). Where a launch takes less device time than its
    wrapper takes of host time, `time_ms` measures the wrapper; this does
    not. None if the profiler saw no launch of the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    records = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in records)
    return sum(e.self_device_time_total for e in records) / 1e3 / count if count else None


def kernel_runs(fn):
    """Runs of the detector-cloud kernel on the card during fn(), from
    torch.profiler's CUDA kernel records (a graph replay's kernels
    included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "detector_clouds_kernel" in e.key)


def detector_bound(args):
    """Least time (ms) of one detector_clouds call on the card, and what
    sets it: each input read once and each output written once, against
    OPS_PER_PAIR operations for every (ray, line) pair of this input."""
    origin, sidx, side, lane, _, _, table, counts = args
    E, Rs, Rl = origin.shape[0], side[0].shape[1], lane[0].shape[1]
    c = counts.long()[sidx.long()].sum(0)
    pairs = Rs * int(c[0]) + Rl * int(c[1])
    bytes_moved = (table.numel() * 4 + counts.numel() * 4 + E * 4 + E * 8
                   + 3 * 4 * E * (Rs + Rl))          # fans (dx, dy) in, clouds out
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = OPS_PER_PAIR * pairs / PEAK_FP32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_case(name, args, iters):
    """The kernel against its plain version on one case: max abs error,
    hits (out < 1) of each, and both times beside the bound."""
    import torch

    from metadrive_ped_torch.ops import ray_segment as rs
    out = rs.detector_clouds(*args)
    plain = rs.detector_clouds_plain(*args)
    torch.cuda.synchronize()
    err = max((float((a - b).abs().max()) if a.numel() else 0.0) for a, b in zip(out, plain))
    hits = [int((a < 1).sum()) for a in out]
    plain_hits = [int((a < 1).sum()) for a in plain]
    if not (err <= KERNEL_TOL and hits == plain_hits):
        raise AssertionError(f"{name}: kernel differs from the plain version by {err}; "
                             f"hits (side, lane) {hits} against {plain_hits}")
    ms = time_ms(lambda: rs.detector_clouds(*args), iters)
    device_ms = kernel_device_ms(lambda: rs.detector_clouds(*args), iters)
    plain_ms = time_ms(lambda: rs.detector_clouds_plain(*args), max(2, iters // 20), warmup=1)
    bound_ms, bound_by = detector_bound(args)
    origin, _, side, lane, _, _, table, _ = args
    row = dict(case=name, E=origin.shape[0], Rs=side[0].shape[1], Rl=lane[0].shape[1],
               S=table.shape[0], Bl=table.shape[1], max_abs_err=err, tol=KERNEL_TOL,
               hits=hits, plain_hits=plain_hits, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    emit(phase="kernel_vs_plain", **row)
    return row


def npc_lidar_bound(args):
    """Least time (ms) of one npc_lidar call on the card, and what sets it,
    with the (ray, box) pairs that can count: the candidates read once and
    the cloud written once, against the operations the cloud needs (the
    NPC_LIDAR_OPS_* counts) at PEAK_FP32_INSTR. A pair can count where its
    box is active and not the slot itself: each of the E*N slots, active
    or not, casts its R rays against the active boxes of its env but its
    own."""
    active, N, R = args[4:7]
    E, C = active.shape
    boxes = active.sum(1)
    pairs = R * int((boxes * N - active[:, :N].sum(1)).sum())
    bytes_moved = E * C * (8 + 3 * 4 + 1) + 4 * E * N * R
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    ops = (NPC_LIDAR_OPS_PER_PAIR * pairs + NPC_LIDAR_OPS_PER_RAY * E * N * R
           + NPC_LIDAR_OPS_PER_SLOT_BOX * E * N * C)
    t_ops = ops / PEAK_FP32_INSTR * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"), pairs


def npc_lidar_case(name, args, iters):
    """The per-NPC lidar kernel against its plain version on one case: max
    abs error (0.0 required: the kernel rounds as the plain chain does),
    hits (out < 1) of each, and both times beside the bound."""
    import torch

    from metadrive_ped_torch.ops import npc_lidar as nl
    out = nl.npc_lidar(*args)
    plain = nl.npc_lidar_plain(*args)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max()) if out.numel() else 0.0
    hits, plain_hits = int((out < 1).sum()), int((plain < 1).sum())
    if not (err == 0.0 and hits == plain_hits):
        raise AssertionError(f"{name}: npc_lidar kernel differs from the plain version by "
                             f"{err}; hits {hits} against {plain_hits}")
    ms = time_ms(lambda: nl.npc_lidar(*args), iters)
    device_ms = kernel_device_ms(lambda: nl.npc_lidar(*args), iters, kernel="npc_lidar_kernel")
    plain_ms = time_ms(lambda: nl.npc_lidar_plain(*args), max(2, iters // 20), warmup=1)
    (bound_ms, bound_by), pairs = npc_lidar_bound(args)
    E, C = args[4].shape
    row = dict(case=name, E=E, N=args[5], R=args[6], C=C, pairs=pairs, max_abs_err=err, tol=0.0,
               hits=hits, plain_hits=plain_hits, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    emit(phase="npc_lidar_vs_plain", **row)
    return row


def npc_lidar_args(env):
    """The npc_lidar arguments of a MixedTrafficEnv's expert traffic at its
    current state."""
    from metadrive_ped_torch.ops import mixed_traffic
    st, lidar = env._state, env.config["vehicle_config"]["lidar"]
    cand = mixed_traffic.vehicle_candidates(st.npc, st.ego)
    return (*cand[:5], st.npc.lane.shape[1], lidar["num_lasers"], lidar["distance"])


def scenario_kernel_args(env):
    """The detector_clouds arguments of a ScenarioEnv's side detector at the
    env's current state: its fan, no lane-line rays, its line table."""
    from metadrive_ped_torch.ops.raycast import _fan_dirs
    st = env._state
    side = env.config["vehicle_config"]["side_detector"]
    none = st.ego.heading.new_zeros((env.num_envs, 0))
    return (st.ego.pos.contiguous(), st.sidx,
            _fan_dirs(st.ego.heading, side["num_lasers"], offset=math.pi / 2), (none, none),
            side["distance"], side["distance"], *env._line_table)


def drive(env, collect, mid=None, steps=STEPS):
    """Reset and ``steps`` full-throttle steps through `rollout`: the first
    captures the step as a CUDA graph (capture synchronises), the second, a
    replay, runs under set_sync_debug_mode("error"); the rate over the
    second half. Returns (the collected fields [steps, rows], the seconds of
    the timed window, kernel launches, mid(env) after the warm steps,
    whether the steps replayed)."""
    import torch

    from metadrive_ped_torch.ops import ray_segment as rs
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(env.num_envs, 2).contiguous()
    torch.cuda.reset_peak_memory_stats()
    rs.launches = 0
    before = replays(env)
    env.reset(seed=0)
    first, _ = env.rollout(1, actions=act, collect=collect)
    torch.cuda.set_sync_debug_mode("error")
    try:
        checked, _ = env.rollout(1, actions=act, collect=collect)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    warm, _ = env.rollout(steps // 2 - 2, actions=act, collect=collect)
    at_mid = mid(env) if mid is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, _ = env.rollout(steps - steps // 2, actions=act, collect=collect)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    outs = {k: torch.cat([first[k], checked[k], warm[k], timed[k]]) for k in collect}
    return outs, seconds, rs.launches, at_mid, replayed(env, steps, before)


def check_obs(env):
    """(shape, ok) of the last observation: ok when it is finite, in
    [0, 1] and [rows, observation_dim]."""
    import torch
    obs = env._last_obs
    ok = (bool(torch.isfinite(obs).all()) and bool(((obs >= 0) & (obs <= 1)).all())
          and tuple(obs.shape) == (env.num_envs, env.observation_dim))
    return list(obs.shape), ok


def drive_scenario(phase, env, card):
    """A ScenarioEnv phase through `drive`. Checks the obs, one kernel
    launch per step and one at reset, and that an episode finished;
    returns the phase's line."""
    import torch
    E = env.num_envs
    outs, seconds, launches, npc_long, graph = drive(env, ("terminated", "truncated"),
                                                     mid=lambda e: e._state.npc_long.max())
    finished = int((outs["terminated"] | outs["truncated"]).sum())
    obs_shape, obs_ok = check_obs(env)
    table, counts = env._line_table
    row = dict(phase=phase, num_envs=E, scenarios=env.num_scenarios, steps=STEPS,
               rate_window=f"steps {TIMED_FROM}-{STEPS}", seconds=seconds,
               env_steps_per_s=E * (STEPS - TIMED_FROM) / seconds, card=card,
               obs_shape=obs_shape, obs_ok=obs_ok, episodes_finished=finished,
               n_cont=counts[:, 0].tolist(), line_table_rows=int(table.shape[1]),
               ray_segment_launches=launches, expected_launches=STEPS + 1, host_sync_checked_step=2,
               npc_long_max=float(torch.maximum(npc_long, env._state.npc_long.max())),
               peak_memory_bytes=torch.cuda.max_memory_allocated(), graph=graph)
    emit(**row)
    if not obs_ok:
        raise AssertionError(f"{phase}: observation out of shape or range")
    if launches != STEPS + 1:
        raise AssertionError(f"{phase}: ray-segment kernel launched {launches} times, "
                             f"expected {STEPS + 1}")
    if finished == 0:
        raise AssertionError(f"{phase}: no episode finished in {STEPS} steps")
    return row


def drive_safe(card):
    """SafeMetaDriveEnv at the `safe` bench protocol: crashes cost and do
    not end the episode; the detectors are off, so no kernel launches."""
    import torch

    from metadrive_ped_torch import SafeMetaDriveEnv
    env = SafeMetaDriveEnv(SAFE, device=DEVICE)
    E = env.num_envs
    crashes = ("crash_vehicle", "crash_object", "crash_human")
    outs, seconds, launches, _, graph = drive(env, ("terminated", "truncated") + crashes)
    counts = {k: int(outs[k].sum()) for k in crashes}
    obs_shape, obs_ok = check_obs(env)
    row = dict(phase="safe", num_envs=E, scenarios=env.num_scenarios, steps=STEPS,
               rate_window=f"steps {TIMED_FROM}-{STEPS}", seconds=seconds,
               env_steps_per_s=E * (STEPS - TIMED_FROM) / seconds, card=card,
               obs_shape=obs_shape, obs_ok=obs_ok, cylinder_bodies=env._has_cylinders,
               episodes_finished=int((outs["terminated"] | outs["truncated"]).sum()),
               crash_events=counts, ray_segment_launches=launches, expected_launches=0,
               host_sync_checked_step=2, peak_memory_bytes=torch.cuda.max_memory_allocated(),
               graph=graph)
    emit(**row)
    if not obs_ok:
        raise AssertionError("safe: observation out of shape or range")
    if launches != 0:
        raise AssertionError(f"safe: the detectors are off, yet the kernel launched {launches} times")
    if sum(counts.values()) == 0:
        raise AssertionError("safe: no crash in 200 steps")
    return row


def drive_marl(phase, env, card, expected_launches, steps=STEPS):
    """A multi-agent phase: env-steps/s and agent-steps/s, agent
    terminations and respawns (rows whose episode restarts at a spawn slot;
    no env resets before the horizon of 1000) over ``steps`` steps."""
    import torch
    rows, envs = env.num_envs, env.num_marl_envs
    outs, seconds, launches, _, graph = drive(env, ("terminated", "truncated", "step_count"),
                                              steps=steps)
    respawns = int((outs["step_count"] == 0).sum())
    obs_shape, obs_ok = check_obs(env)
    timed = steps - steps // 2
    row = dict(phase=phase, num_envs=envs, agents_per_env=env.agents_per_env, rows=rows,
               steps=steps, rate_window=f"steps {steps // 2}-{steps}", seconds=seconds,
               env_steps_per_s=envs * timed / seconds,
               agent_steps_per_s=rows * timed / seconds, card=card,
               obs_shape=obs_shape, obs_ok=obs_ok,
               agent_terminations=int(outs["terminated"].sum()), respawns=respawns,
               ray_segment_launches=launches, expected_launches=expected_launches,
               host_sync_checked_step=2, peak_memory_bytes=torch.cuda.max_memory_allocated(),
               graph=graph)
    emit(**row)
    if not obs_ok:
        raise AssertionError(f"{phase}: observation out of shape or range")
    if launches != expected_launches:
        raise AssertionError(f"{phase}: ray-segment kernel launched {launches} times, "
                             f"expected {expected_launches}")
    return row


def card_vs_cpu(make_env, cfg, steps=20, state_ints=(), action=(0.0, 1.0)):
    """The same env config on the card and on the CPU, stepped with one
    ``action`` in every row (full throttle by default): (obs max abs
    difference, reward max abs difference, bool flags that differ, whether
    the card's steps replayed a graph).
    ``state_ints`` names integer state fields ("dead_timer", "ego.slot")
    whose differing entries count as flags."""
    import torch
    gpu, cpu = make_env(cfg, device=DEVICE), make_env(cfg, device="cpu")
    obs_gap = lambda a, b: float((a.cpu() - b).abs().max())
    og, _ = gpu.reset(seed=0)
    oc, _ = cpu.reset(seed=0)
    obs_err = obs_gap(og, oc)
    rew_err, flag_mismatches = 0.0, 0
    # [E, 2] or [E, A, 2]
    act = torch.tensor(action, dtype=torch.float32).expand(tuple(oc.shape[:-1]) + (2,))
    for _ in range(steps):
        og, rg, tg, trg, ig = gpu.step(act.to(DEVICE))
        oc, rc, tc, trc, ic = cpu.step(act)
        obs_err = max(obs_err, obs_gap(og, oc))
        rew_err = max(rew_err, float((rg.cpu() - rc).abs().max()))
        flags = [(tg, tc), (trg, trc)] + [(ig[k], ic[k]) for k in ic
                                          if torch.is_tensor(ic[k]) and ic[k].dtype == torch.bool]
        flags += [(attrgetter(n)(gpu._state), attrgetter(n)(cpu._state)) for n in state_ints]
        flag_mismatches += sum(int((a.cpu() != b).sum()) for a, b in flags)
    return obs_err, rew_err, flag_mismatches, replayed(gpu, steps)


def graph_vs_eager(name, env, steps, card, timed_from=None, policy=None):
    """``steps`` steps of ``env`` from reset(seed=0) through the eager loop
    (`_rollout_eager`), then from the same reset through the replayed
    `rollout`, at full throttle or with ``policy``: the collected fields,
    the final state and last observation must be bit-equal and the kernel
    launches equal. The first two steps collect no reward (`rollout` reads
    its mean on the host): the second runs under set_sync_debug_mode
    ("error") in both runs, a replay in the second (the first captures).
    With ``timed_from``, the rate of each over steps timed_from-steps.
    Returns the phase's line."""
    import torch

    from metadrive_ped_torch.core.graph import leaves
    from metadrive_ped_torch.core.structs import map_tensors
    from metadrive_ped_torch.ops import ray_segment as rs
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(env.num_envs, 2).contiguous()
    kw = dict(policy_fn=policy) if policy is not None else dict(actions=act)
    unchecked = tuple(k for k in GRAPH_COLLECT if k != "reward")
    timed_from = timed_from or steps
    runs = {}
    for mode, roll in (("eager", env._rollout_eager), ("graph", env.rollout)):
        rs.launches = 0
        before = replays(env)
        env.reset(seed=0)
        first = []
        for check in (False, True):
            torch.cuda.set_sync_debug_mode("error" if check else 0)
            try:
                first.append(roll(1, collect=unchecked, **kw)[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        parts = [roll(timed_from - 2, collect=GRAPH_COLLECT, **kw)[0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if steps > timed_from:
            parts.append(roll(steps - timed_from, collect=GRAPH_COLLECT, **kw)[0])
        torch.cuda.synchronize()
        outs = {k: torch.cat([p[k] for p in (first if k in unchecked else []) + parts])
                for k in GRAPH_COLLECT}
        runs[mode] = dict(outs=outs,
                          final=leaves(map_tensors(torch.clone, (env._state, env._last_obs))),
                          launches=rs.launches, seconds=time.perf_counter() - t0,
                          replays=replays(env) - before)
    eager, graph = runs["eager"], runs["graph"]
    equal = {k: bool(torch.equal(eager["outs"][k], graph["outs"][k])) for k in GRAPH_COLLECT}
    equal["state_and_last_obs"] = len(eager["final"]) == len(graph["final"]) and all(
        bool(torch.equal(a, b)) for a, b in zip(eager["final"], graph["final"]))
    row = dict(phase="graph_vs_eager", run=name, rows=env.num_envs, steps=steps,
               reward_steps=f"3-{steps}", bit_equal=equal,
               kernel_launches=dict(eager=eager["launches"], graph=graph["launches"]),
               captures=env._graphs.captures,
               replays=dict(eager=eager["replays"], graph=graph["replays"]),
               host_sync_checked_step=2,
               graph=eager["replays"] == 0 and graph["replays"] == steps, card=card)
    if steps > timed_from:
        rate = lambda r: env.num_envs * (steps - timed_from) / r["seconds"]  # noqa: E731
        row.update(rate_window=f"steps {timed_from}-{steps}", eager_rows_per_s=rate(eager),
                   graph_rows_per_s=rate(graph), graph_over_eager=rate(graph) / rate(eager))
    emit(**row)
    if not all(equal.values()):
        raise AssertionError(f"graph_vs_eager {name}: replay differs from the eager loop: {equal}")
    if eager["launches"] != graph["launches"]:
        raise AssertionError(f"graph_vs_eager {name}: kernel launches {row['kernel_launches']}")
    return row


def run_cuda_tests(card):
    """The card-only tests (marker `cuda`) in a child process, without
    tests/conftest.py (it imports jax, which the port does not need): every
    one must pass, none skip."""
    import torch
    torch.cuda.empty_cache()  # leave the card's memory to the child
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pytest", *CUDA_TESTS, "-q", "-m", "cuda",
                          "--noconftest", "-p", "no:cacheprovider"], cwd=ROOT,
                         capture_output=True, text=True, timeout=CUDA_TESTS_TIMEOUT)
    summary = (out.stdout.strip().splitlines() or [""])[-1]
    emit(phase="cuda_tests", files=list(CUDA_TESTS), returncode=out.returncode, summary=summary,
         seconds=time.perf_counter() - t0, card=card)
    if out.returncode != 0 or "passed" not in summary or "skipped" in summary:
        raise AssertionError(f"cuda_tests: {summary}\n{out.stdout[-4000:]}\n{out.stderr[-2000:]}")


def host_api_calls(prof, calls):
    """(calls per call, the five most frequent by name) of the CUDA runtime
    and driver API calls (cuda*, cu*) a profiler saw on the host: kernel
    and graph launches, copies, events."""
    from torch.autograd import DeviceType
    api = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith("cu")]
    top = sorted(api, key=lambda e: -e.count)[:5]
    return sum(e.count for e in api) / calls, {e.key: e.count / calls for e in top}


def call_profile(fn, calls):
    """Per call of fn(), from the profiler over one call of fn that makes
    ``calls`` calls: kernel launches, device busy ms, host API calls (and
    the five most frequent), and the detector kernel's runs and device ms
    a run (None where the profiler kept no record of it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    detector = [e for e in kernels if "detector_clouds_kernel" in e.key]
    runs = sum(e.count for e in detector)
    api, api_top = host_api_calls(prof, calls)
    return dict(launches=sum(e.count for e in kernels) / calls,
                device_ms=sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
                host_api_calls=api, host_api_calls_top=api_top, detector_runs=runs / calls,
                detector_device_ms=(sum(e.self_device_time_total for e in detector) / 1e3 / runs
                                    if runs else None))


def kernel_profile(fn, calls):
    """(kernel launches, device busy ms) per call of fn(), as
    `call_profile` counts them."""
    row = call_profile(fn, calls)
    return row["launches"], row["device_ms"]


def step_launches(env, act, steps=2):
    """(kernel launches, device busy ms) per `rollout` step, after one step
    that captures the step for this collect outside the profile."""
    env.rollout(1, actions=act, collect=())
    return kernel_profile(lambda: env.rollout(steps, actions=act, collect=()), steps)


def drive_mixed(card):
    """MixedTrafficEnv at the main path's width: the detector kernel against
    its plain version on the env's line table, then `drive` (one per-NPC
    lidar launch a step), then the per-NPC lidar kernel against its plain
    version on the state `drive` leaves (past auto-resets). Returns the two
    kernels' rows and the phase's line."""
    import torch

    from metadrive_ped_torch import MixedTrafficEnv
    from metadrive_ped_torch.ops import npc_lidar as nl
    env = MixedTrafficEnv(MIXED_TRAFFIC, device=DEVICE)
    E = env.num_envs
    env.reset(seed=0)
    row = kernel_case("mixed_traffic", detector_args(env), iters=20)
    nl.launches = 0
    outs, seconds, launches, _, graph = drive(env, ("terminated", "truncated"))
    npc_launches = nl.launches
    npc_row = npc_lidar_case("mixed_traffic", npc_lidar_args(env), iters=20)
    st = env._state
    expert = env.scene.npc_expert[st.sidx.long()]
    expert_active = int((expert & st.npc.active & st.npc.released).sum())
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
    per_step, busy_ms = step_launches(env, act)
    obs_shape, obs_ok = check_obs(env)
    phase = dict(phase="mixed_traffic", num_envs=E, scenarios=env.num_scenarios,
                 npc_slots=int(expert.shape[1]), steps=STEPS,
                 rate_window=f"steps {TIMED_FROM}-{STEPS}", seconds=seconds,
                 env_steps_per_s=E * (STEPS - TIMED_FROM) / seconds, card=card,
                 obs_shape=obs_shape, obs_ok=obs_ok,
                 episodes_finished=int((outs["terminated"] | outs["truncated"]).sum()),
                 expert_slots=int(expert.sum()),
                 expert_slots_active=expert_active,
                 launches_per_step=per_step, device_busy_ms_per_step=busy_ms,
                 ray_segment_launches=launches, expected_launches=STEPS + 1,
                 npc_lidar_launches=npc_launches, expected_npc_lidar_launches=STEPS,
                 host_sync_checked_step=2, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 graph=graph)
    emit(**phase)
    if not obs_ok:
        raise AssertionError("mixed_traffic: observation out of shape or range")
    if launches != STEPS + 1:
        raise AssertionError(f"mixed_traffic: ray-segment kernel launched {launches} times, "
                             f"expected {STEPS + 1}")
    if npc_launches != STEPS:
        raise AssertionError(f"mixed_traffic: npc_lidar kernel launched {npc_launches} times, "
                             f"expected {STEPS}")
    if phase["expert_slots_active"] == 0:
        raise AssertionError("mixed_traffic: no expert-driven NPC is on the road")
    return row, npc_row, phase


def drive_ai_protect(card):
    """The AI protector with lidar noise through `step`: the first step
    after reset captures it, the second, a replay, runs under
    set_sync_debug_mode("error")."""
    import torch

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import ray_segment as rs
    env = MetaDriveEnv(AI_PROTECT_NOISE, device=DEVICE)
    E = env.num_envs
    act = torch.tensor([0.5, 1.0], device=DEVICE).expand(E, 2).contiguous()
    torch.cuda.reset_peak_memory_stats()
    rs.launches = 0
    env.reset(seed=0)
    counts = {k: torch.zeros((), dtype=torch.int64, device=DEVICE)
              for k in ("takeover", "takeover_start", "takeover_end", "terminated")}
    for i in range(STEPS):
        if i == TIMED_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, term, trunc, info = env.step(act)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for k in counts:
            counts[k] += (term | trunc).sum() if k == "terminated" else info[k].sum()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    obs_shape, obs_ok = check_obs(env)
    counts = {k: int(v) for k, v in counts.items()}
    row = dict(phase="ai_protect_noise", num_envs=E, scenarios=env.num_scenarios, steps=STEPS,
               rate_window=f"steps {TIMED_FROM}-{STEPS}", seconds=seconds,
               env_steps_per_s=E * (STEPS - TIMED_FROM) / seconds, card=card,
               obs_shape=obs_shape, obs_ok=obs_ok, takeovers=counts["takeover"],
               takeover_starts=counts["takeover_start"], takeover_ends=counts["takeover_end"],
               episodes_finished=counts["terminated"], ray_segment_launches=rs.launches,
               expected_launches=0, host_sync_checked_step=2,
               peak_memory_bytes=torch.cuda.max_memory_allocated(), graph=replayed(env, STEPS))
    emit(**row)
    if not obs_ok:
        raise AssertionError("ai_protect_noise: observation out of shape or range")
    if rs.launches != 0:
        raise AssertionError(f"ai_protect_noise: the detectors are off, yet the kernel launched "
                             f"{rs.launches} times")
    if counts["takeover"] == 0:
        raise AssertionError("ai_protect_noise: the protector never took over")
    return row


def detector_args(env):
    """The detector_clouds arguments of a PG env's two detectors at its
    current state."""
    from metadrive_ped_torch.ops.raycast import _fan_dirs
    st, vc = env._state, env.config["vehicle_config"]
    fan = lambda R: _fan_dirs(st.ego.heading, R, offset=math.pi / 2)
    side, lane = vc["side_detector"], vc["lane_line_detector"]
    return (st.ego.pos.contiguous(), st.sidx, fan(side["num_lasers"]), fan(lane["num_lasers"]),
            side["distance"], lane["distance"], *env._line_table)



def tree_equal(a, b):
    """Whether two numpy trees (dataclasses or dicts of arrays, as
    `snapshot` and `record_episode` give) are bit-equal leaf by leaf."""
    import dataclasses

    import numpy as np
    if dataclasses.is_dataclass(a):
        return all(tree_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def ppo_minibatch_flop(rows, obs_dim, hidden=256):
    """Matrix-product FLOPs of one PPO minibatch step: the forward of the
    policy (obs -> 256 -> 256 -> 4) and value (obs -> 256 -> 256 -> 1) MLPs
    and their backward (two products per forward product, less the input
    gradient of the first layers, which autograd skips)."""
    macs = obs_dim * hidden + hidden * hidden
    fwd = 2 * rows * (2 * macs + hidden * 4 + hidden * 1)
    return fwd + 2 * fwd - 2 * rows * 2 * obs_dim * hidden


def drive_ppo(card):
    """The train_ppo example's configuration at the `pg` width: PPO_ITERS
    iterations of a PPO_ROLLOUT-step collection through `rollout` with the
    sampling policy, GAE and a PPO update of PPO_EPOCHS x PPO_MINIBATCHES
    Adam steps. One line per iteration; returns the last batch and the
    trained parameters for ppo_card_vs_cpu."""
    import types

    import torch

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.core import prng
    from metadrive_ped_torch.examples import train_ppo as ppo
    from metadrive_ped_torch.ops import ray_segment as rs
    t0 = time.perf_counter()
    env = MetaDriveEnv(ppo.env_config(PPO_ENVS, PPO_SCENARIOS), device=DEVICE)
    build_s = time.perf_counter() - t0
    args = types.SimpleNamespace(rollout=PPO_ROLLOUT, epochs=PPO_EPOCHS,
                                 minibatches=PPO_MINIBATCHES, lr=PPO_LR, gamma=0.99, lam=0.95,
                                 clip=0.2)
    rs.launches = 0
    torch.cuda.reset_peak_memory_stats()
    env.reset(seed=0)
    rng = prng.prng_key(0, DEVICE)
    module = ppo.PolicyValue(env.observation_dim, key=rng, device=DEVICE)
    optimizer = torch.optim.Adam(module.parameters(), lr=args.lr)
    generator = torch.Generator(device=DEVICE).manual_seed(0)
    # a replayed step of the sampling policy must not synchronise with the
    # host (the first call captures it, and capture synchronises)
    policy = ppo.sample_policy(module, prng.split(rng, 3)[2])
    env.rollout(1, policy_fn=policy, collect=("obs",))
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.rollout(1, policy_fn=policy, collect=("obs",))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    start = [p.detach().clone() for p in module.parameters()]
    stats = []
    for it in range(PPO_ITERS):
        keys = prng.split(rng, 3)
        rng = keys[0]
        before = [p.detach().clone() for p in module.parameters()]
        steps_before = replays(env)
        row, batch = ppo.train_iteration(env, module, optimizer, keys[1], args, generator)
        row["param_max_abs_change"] = max(float((p.detach() - q).abs().max())
                                          for p, q in zip(module.parameters(), before))
        emit(phase="ppo_train", iteration=it, num_envs=PPO_ENVS, card=card,
             graph=replayed(env, PPO_ROLLOUT, steps_before), **row)
        stats.append(row)
    # where the time goes: a (replayed) collection step and an update
    # minibatch; one step first captures the new policy's graph
    policy = ppo.sample_policy(module, rng)
    env.rollout(1, policy_fn=policy, collect=())
    t0 = time.perf_counter()
    collect_launches, collect_busy = kernel_profile(
        lambda: env.rollout(2, policy_fn=policy, collect=()), 2)
    collect_wall = (time.perf_counter() - t0) * 1e3 / 2
    mb_rows = [x[:batch[0].shape[0] // PPO_MINIBATCHES] for x in batch]
    t0 = time.perf_counter()
    update_launches, update_busy = kernel_profile(
        lambda: ppo.ppo_update(module, optimizer, mb_rows, 1, 1, args.clip), 1)
    update_wall = (time.perf_counter() - t0) * 1e3
    obs_b = batch[0]
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(module.parameters(), start))
    graph_vs_eager("ppo_collection", env, GRAPH_STEPS, card, policy=policy)
    summary = dict(phase="ppo_train", summary=True, num_envs=PPO_ENVS, scenarios=env.num_scenarios,
                   env_build_s=build_s, rollout=PPO_ROLLOUT, epochs=PPO_EPOCHS,
                   minibatches=PPO_MINIBATCHES, iterations=PPO_ITERS,
                   batch_rows=int(obs_b.shape[0]), obs_dim=int(obs_b.shape[1]),
                   rollout_obs_bytes=obs_b.numel() * obs_b.element_size(),
                   minibatch_rows=int(obs_b.shape[0]) // PPO_MINIBATCHES,
                   param_max_abs_change_total=moved, host_sync_checked_step=2,
                   # the checked steps, the collections, the profiled
                   # steps and graph_vs_eager's replayed run
                   graph=replayed(env, 2 + PPO_ITERS * PPO_ROLLOUT + 3 + GRAPH_STEPS),
                   captures=env._graphs.captures,
                   collect_step=dict(launches=collect_launches, device_busy_ms=collect_busy,
                                     profiled_wall_ms=collect_wall),
                   update_minibatch=dict(launches=update_launches, device_busy_ms=update_busy,
                                         profiled_wall_ms=update_wall,
                                         matmul_flop=ppo_minibatch_flop(
                                             batch[0].shape[0] // PPO_MINIBATCHES,
                                             batch[0].shape[1])),
                   matmul_precision=torch.get_float32_matmul_precision(),
                   matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                   ray_segment_launches=rs.launches, expected_launches=0,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(), card=card)
    emit(**summary)
    if not all(math.isfinite(r["loss"]) for r in stats):
        raise AssertionError(f"ppo_train: a loss is not finite: {[r['loss'] for r in stats]}")
    if not moved > 0 or not all(r["param_max_abs_change"] > 0 for r in stats):
        raise AssertionError("ppo_train: the parameters did not move")
    if summary["matmul_allow_tf32"] or summary["matmul_precision"] != "highest":
        raise AssertionError("ppo_train: float32 matmuls must run without TF32")
    if rs.launches != 0:
        raise AssertionError(f"ppo_train: the detectors are off, yet the kernel launched "
                             f"{rs.launches} times")
    return ppo.params_to_jax(module), batch, summary


def adam_first_step(g):
    """The first step of torch.optim.Adam / optax.adam per unit of lr:
    g / (|g| + eps), eps = 1e-8."""
    import numpy as np
    return g / (np.abs(g) + 1e-8)


def ppo_card_vs_cpu(params, batch):
    """One PPO update (1 epoch, 2 minibatches) of the first PPO_CPU_ROWS rows
    of ppo_train's last batch, from the same parameters and permutation on
    the card and on the CPU. The first minibatch's gradients must agree per
    leaf within PPO_GRAD_RTOL of the leaf's largest CPU gradient, and the
    card's gradients with TF32 on must not: a check that a TF32 update
    would pass could not guard the precision. The parameters must agree
    within PPO_TOL except where Adam's first step turns the two gradients'
    rounding difference into a larger step difference (lr * |g / (|g| +
    eps) - g' / (|g'| + eps)| > PPO_TOL / 2: gradients near zero), and at
    most PPO_EXEMPT_CAP elements may be exempt so."""
    import numpy as np
    import torch

    from metadrive_ped_torch.examples import train_ppo as ppo
    rows = [x[:PPO_CPU_ROWS] for x in batch]
    cpu_rows = [x.cpu() for x in rows]
    perm = torch.randperm(PPO_CPU_ROWS, generator=torch.Generator().manual_seed(1))
    first = perm[:PPO_CPU_ROWS // 2]

    def first_grads(data):
        probe = ppo.params_from_jax(params, device=data[0].device)
        idx = first.to(data[0].device)
        ppo.ppo_loss(probe, *(x[idx] for x in data), 0.2).backward()
        return {k: getattr(probe, k).grad.cpu().numpy() for k in params}

    grads = {DEVICE: first_grads(rows), "cpu": first_grads(cpu_rows)}
    torch.set_float32_matmul_precision("high")
    tf32 = first_grads(rows)
    torch.set_float32_matmul_precision("highest")
    out = {}
    for dev, data in ((DEVICE, rows), ("cpu", cpu_rows)):
        module = ppo.params_from_jax(params, device=dev)
        opt = torch.optim.Adam(module.parameters(), lr=PPO_LR)
        loss = ppo.ppo_update(module, opt, data, epochs=1, minibatches=2, clip=0.2, perm=perm)
        out[dev] = (float(loss), ppo.params_to_jax(module))
    tiny = np.finfo(np.float32).tiny
    size = {k: float(np.abs(g).max()) for k, g in grads["cpu"].items()}

    def rel_err(card):
        return {k: float(np.abs(card[k] - grads["cpu"][k]).max()) / max(size[k], tiny)
                for k in params}

    def exempt(card):
        return {k: PPO_LR * np.abs(adam_first_step(card[k]) - adam_first_step(grads["cpu"][k]))
                > PPO_TOL / 2 for k in params}

    grad_rel, tf32_rel = rel_err(grads[DEVICE]), rel_err(tf32)
    ill = exempt(grads[DEVICE])
    n_exempt = sum(int(m.sum()) for m in ill.values())
    diff = {k: np.abs(out[DEVICE][1][k] - out["cpu"][1][k]) for k in params}
    err = max(float(np.where(ill[k], 0, d).max()) for k, d in diff.items())
    emit(phase="ppo_card_vs_cpu", rows=PPO_CPU_ROWS, epochs=1, minibatches=2,
         loss_card=out[DEVICE][0], loss_cpu=out["cpu"][0], grad_max_abs_by_name=size,
         grad_max_abs_err=max(float(np.abs(grads[DEVICE][k] - grads["cpu"][k]).max())
                              for k in params),
         grad_rel_err=max(grad_rel.values()), grad_rel_err_by_name=grad_rel,
         grad_rel_tol=PPO_GRAD_RTOL,
         tf32_control=dict(grad_rel_err=max(tf32_rel.values()), grad_rel_err_by_name=tf32_rel,
                           exempt_elements=sum(int(m.sum()) for m in exempt(tf32).values())),
         param_max_abs_err=err, tol=PPO_TOL, exempt_elements=n_exempt,
         exempt_cap=PPO_EXEMPT_CAP, elements=sum(d.size for d in diff.values()),
         param_max_abs_err_all=max(float(d.max()) for d in diff.values()),
         param_max_abs_err_by_name={k: float(d.max()) for k, d in diff.items()},
         param_max_abs_step=max(float(np.abs(out["cpu"][1][k] - params[k]).max())
                                for k in params))
    if not max(grad_rel.values()) <= PPO_GRAD_RTOL < max(tf32_rel.values()):
        raise AssertionError(f"ppo_card_vs_cpu: gradients differ by {max(grad_rel.values())} "
                             f"of their size, {max(tf32_rel.values())} with TF32 on; the limit "
                             f"{PPO_GRAD_RTOL} must lie between")
    if not (err <= PPO_TOL and n_exempt <= PPO_EXEMPT_CAP):
        raise AssertionError(f"ppo_card_vs_cpu: parameters differ by {err}, with {n_exempt} "
                             f"elements exempt (cap {PPO_EXEMPT_CAP})")


def drive_mix(card, synthetic):
    """MixWaymoPGEnv at 4096 envs over the synthetic scenes and a PG map 3,
    both with the replay protocol's detectors: the kernel against its plain
    version on each half, then MIX_RESETS resets x MIX_STEPS steps through
    `rollout` (one launch at each reset and each step)."""
    import torch

    from metadrive_ped_torch import MixWaymoPGEnv
    from metadrive_ped_torch.ops import ray_segment as rs
    env = MixWaymoPGEnv(dict(MIX_WAYMO_PG, scenario_data=synthetic), device=DEVICE)
    E = env.num_envs
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
    rows = []
    env.pg_env.reset(seed=0)
    rows.append(kernel_case("mix_waymo_pg_pg", detector_args(env.pg_env), iters=20))
    env.scenario_env.reset(seed=0)
    rows.append(kernel_case("mix_waymo_pg_scenario", scenario_kernel_args(env.scenario_env),
                            iters=20))
    torch.cuda.reset_peak_memory_stats()
    rs.launches = 0
    suites, seconds, timed = [], 0.0, 0
    finished = torch.zeros((), dtype=torch.int64, device=DEVICE)
    collect = ("terminated", "truncated")
    for i in range(MIX_RESETS):
        env.reset(seed=i)
        suite = "scenario" if env.is_current_real_data else "pg"
        steps = MIX_STEPS
        if suite not in suites:
            # the suite's first reset: one step captures its graph, the
            # next, a replay, runs under the sync check; both untimed
            for check in (False, True):
                torch.cuda.set_sync_debug_mode("error" if check else 0)
                try:
                    outs, _ = env.rollout(1, actions=act, collect=collect)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                finished += (outs["terminated"] | outs["truncated"]).sum()
            steps -= 2
        suites.append(suite)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, _ = env.rollout(steps, actions=act, collect=collect)
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        timed += steps
        finished += (outs["terminated"] | outs["truncated"]).sum()
    launches = rs.launches
    obs_shape, obs_ok = check_obs(env._active)
    expected = MIX_RESETS * (MIX_STEPS + 1)
    row = dict(phase="mix_waymo_pg", num_envs=E, resets=MIX_RESETS, steps_per_reset=MIX_STEPS,
               suites=suites, seconds=seconds, timed_steps=timed,
               env_steps_per_s=E * timed / seconds, card=card,
               obs_shape=obs_shape, obs_ok=obs_ok, episodes_finished=int(finished),
               pg_speed_init="randint(0, 10) from RandomState(0)",
               ray_segment_launches=launches, expected_launches=expected,
               kernel_max_abs_err=max(r["max_abs_err"] for r in rows),
               host_sync_checked_step="2 of each suite's first reset",
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               graph=all(replayed(child, MIX_STEPS * suites.count(suite))
                         for child, suite in ((env.scenario_env, "scenario"),
                                              (env.pg_env, "pg"))))
    emit(**row)
    if set(suites) != {"scenario", "pg"}:
        raise AssertionError(f"mix_waymo_pg: both suites must run, got {suites}")
    if not obs_ok:
        raise AssertionError("mix_waymo_pg: observation out of shape or range")
    if launches != expected:
        raise AssertionError(f"mix_waymo_pg: the kernel launched {launches} times, "
                             f"expected {expected}")
    if row["kernel_max_abs_err"] != 0.0:
        raise AssertionError("mix_waymo_pg: the kernel differs from its plain version")
    return rows, launches


def drive_opendrive(card, xodr_path):
    """A PG env on the two-road OpenDrive map at the main path's width: the
    kernel against its plain version on the map's line table, `drive`, then
    the card against the CPU at 32 envs."""
    import torch

    from metadrive_ped_torch import MetaDriveEnv
    cfg = dict(OPENDRIVE, map_config=dict(xodr_file=xodr_path))
    env = MetaDriveEnv(cfg, device=DEVICE)
    E = env.num_envs
    env.reset(seed=0)
    krow = kernel_case("opendrive", detector_args(env), iters=20)
    if krow["hits"][0] == 0 or krow["max_abs_err"] != 0.0:
        raise AssertionError("opendrive: the side detector saw no line, or the kernel differs")
    outs, seconds, launches, _, graph = drive(env, ("terminated", "truncated"))
    obs_shape, obs_ok = check_obs(env)
    table, counts = env._line_table
    del env
    obs_err, rew_err, flag_mismatches, cpu_graph = card_vs_cpu(MetaDriveEnv, dict(cfg, num_envs=32))
    row = dict(phase="opendrive", num_envs=E, steps=STEPS,
               rate_window=f"steps {TIMED_FROM}-{STEPS}", seconds=seconds,
               env_steps_per_s=E * (STEPS - TIMED_FROM) / seconds, card=card,
               obs_shape=obs_shape, obs_ok=obs_ok,
               episodes_finished=int((outs["terminated"] | outs["truncated"]).sum()),
               n_cont=counts[:, 0].tolist(), line_table_rows=int(table.shape[1]),
               ray_segment_launches=launches, expected_launches=STEPS + 1,
               kernel_max_abs_err=krow["max_abs_err"], host_sync_checked_step=2,
               card_vs_cpu=dict(num_envs=32, steps=20, obs_max_abs_err=obs_err,
                                reward_max_abs_err=rew_err, flag_mismatches=flag_mismatches,
                                tol=CPU_TOL, graph=cpu_graph),
               peak_memory_bytes=torch.cuda.max_memory_allocated(), graph=graph)
    emit(**row)
    if not obs_ok:
        raise AssertionError("opendrive: observation out of shape or range")
    if launches != STEPS + 1:
        raise AssertionError(f"opendrive: the kernel launched {launches} times, "
                             f"expected {STEPS + 1}")
    if not (obs_err <= CPU_TOL and rew_err <= CPU_TOL and flag_mismatches == 0):
        raise AssertionError("opendrive: the card and the CPU disagree")
    return krow, launches


def drive_snapshot(card):
    """Snapshot, restore, record, replay, fault injection and map dumps on
    the card with the detectors on: a snapshot at step SNAP_AT, SNAP_STEPS
    steps, restore, the same steps again (obs, reward and state bit-equal);
    record_episode at RECORD_ENVS envs, replay of frame 4 and one step equal
    to frame 5; set_break_down on half the rows (their speed falls); a
    dump_all_maps reload with a bit-equal pack."""
    import tempfile

    import numpy as np
    import torch

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.core.structs import tree_map
    from metadrive_ped_torch.ops import ray_segment as rs
    rs.launches = 0
    env = MetaDriveEnv(MAIN_PATH, device=DEVICE)
    E = env.num_envs
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
    env.reset(seed=0)
    env.rollout(SNAP_AT, actions=act, collect=())
    snap = env.snapshot()
    runs = []
    for _ in range(2):
        outs, _ = env.rollout(SNAP_STEPS, actions=act, collect=("obs", "reward", "terminated"))
        runs.append(({k: v.cpu().numpy() for k, v in outs.items()}, env.snapshot()))
        env.restore(snap)
    round_trip = dict(obs=bool(np.array_equal(runs[0][0]["obs"], runs[1][0]["obs"])),
                      reward=bool(np.array_equal(runs[0][0]["reward"], runs[1][0]["reward"])),
                      state=tree_equal(runs[0][1], runs[1][1]),
                      restored_state=tree_equal(env.snapshot(), snap))
    done_rows = int(runs[0][0]["terminated"].sum())
    # fault injection on the even rows
    broken = torch.arange(E, device=DEVICE) % 2 == 0
    speed0 = env._state.ego.speed.clone()
    env.set_break_down(broken)
    env.rollout(BREAK_STEPS, actions=act, collect=())
    speed1 = env._state.ego.speed
    fault = dict(rows=int(broken.sum()),
                 broken_mean_speed_before=float(speed0[broken].mean()),
                 broken_mean_speed_after=float(speed1[broken].mean()),
                 healthy_mean_speed_before=float(speed0[~broken].mean()),
                 healthy_mean_speed_after=float(speed1[~broken].mean()))
    launches = rs.launches
    graph = replayed(env, SNAP_AT + 2 * SNAP_STEPS + BREAK_STEPS)
    del env
    # record and replay at RECORD_ENVS envs
    rs.launches = 0
    small = MetaDriveEnv(dict(MAIN_PATH, num_envs=RECORD_ENVS), device=DEVICE)
    small.reset(seed=0)
    sact = act[:RECORD_ENVS]
    rec = small.record_episode(RECORD_STEPS, actions=sact)
    small.replay_frame(rec, 4)
    obs5, rew5, *_ = small.step(sact)
    replay = dict(obs=bool(np.array_equal(obs5.cpu().numpy(), rec["obs"][5])),
                  reward=bool(np.array_equal(rew5.cpu().numpy(), rec["reward"][5])),
                  state=tree_equal(small.snapshot(), tree_map(lambda x: x[5], rec["state"])))
    with tempfile.TemporaryDirectory() as d:
        path = small.dump_all_maps(os.path.join(d, "maps.pkl"))
        reloaded = MetaDriveEnv(dict(MAIN_PATH, num_envs=RECORD_ENVS, map_pack_file=path),
                                device=DEVICE)
    pack_equal = small._pack.keys() == reloaded._pack.keys() and all(
        np.array_equal(small._pack[k], reloaded._pack[k]) for k in small._pack)
    launches += rs.launches
    row = dict(phase="snapshot_replay", num_envs=E, snapshot_at=SNAP_AT, steps_after=SNAP_STEPS,
               done_rows_in_window=done_rows, round_trip_bit_equal=round_trip,
               record_envs=RECORD_ENVS, record_steps=RECORD_STEPS, replay_bit_equal=replay,
               break_down=dict(fault, steps=BREAK_STEPS), dump_reload_pack_equal=pack_equal,
               ray_segment_launches=launches, card=card,
               graph=graph and replayed(small, RECORD_STEPS + 1))
    emit(**row)
    if not all(round_trip.values()):
        raise AssertionError(f"snapshot_replay: the restored run differs: {round_trip}")
    if not all(replay.values()):
        raise AssertionError(f"snapshot_replay: the replayed frame differs: {replay}")
    if not fault["broken_mean_speed_after"] < fault["broken_mean_speed_before"]:
        raise AssertionError(f"snapshot_replay: broken-down rows did not slow down: {fault}")
    if not pack_equal:
        raise AssertionError("snapshot_replay: the reloaded pack differs")
    return launches


def image_steps(env, act, steps, timed_from):
    """Reset and ``steps`` steps of ``env`` through `step` (the image
    observation and the top-down ring live there), the second under
    set_sync_debug_mode("error"). Returns (the last observation, seconds
    over steps timed_from..steps, episodes finished, ray-segment launches,
    peak device memory)."""
    import torch

    from metadrive_ped_torch.ops import ray_segment as rs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rs.launches = 0
    obs, _ = env.reset(seed=0)
    finished = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for i in range(steps):
        if i == timed_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            obs, _, term, trunc, _ = env.step(act)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        finished += (term | trunc).sum()
    torch.cuda.synchronize()
    return (obs, time.perf_counter() - t0, int(finished), rs.launches,
            torch.cuda.max_memory_allocated())


def camera_bound(E, P, L, B, T):
    """Least time (ms) of one camera frame of E envs at P pixels over L
    lanes, B segments and T boxes, every pair padded, and what sets it."""
    return camera_pairs_ms(E * P, E * P * L, E * P * B, E * P * T)


def camera_pairs_ms(pixels, lane_pairs, segment_pairs, box_pairs):
    """Least time (ms) of one camera frame over counted (pixel, primitive)
    pairs, and what sets it: CAMERA_OPS operations per pair against the
    float32 peak, or the frame's outputs written once (the per-env tables
    it reads are under 0.1% of them)."""
    ops = (CAMERA_OPS["segment"] * segment_pairs + CAMERA_OPS["lane"] * lane_pairs
           + CAMERA_OPS["box"] * box_pairs)
    t_ops = ops / PEAK_FP32_OPS * 1e3
    t_bytes = pixels * CAMERA_OUT_FLOATS * 4 / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def camera_pairs_bound(env):
    """`camera_pairs_ms` of one frame of ``env`` at its state, and the pairs
    it counts: only those that can count (each ground pixel against each
    valid lane and segment of its row's scenario, each pixel against each
    active body of its row), as the benchmark's yardstick counts them
    (benchmarks/camera_work.py::frame_pairs, the one count of them)."""
    from benchmarks.camera_work import frame_pairs
    pixels, lanes, segments, boxes = frame_pairs(env)
    return (camera_pairs_ms(pixels, lanes, segments, boxes),
            dict(lane=lanes, segment=segments, box=boxes))


def camera_args(env):
    """The `camera.render` arguments and keywords of ``env``'s camera at
    its current state."""
    st = env._state
    targets, _ = env._lidar_targets(st)
    _, w, h = env._sensor_spec()
    cam = env.config["camera"]
    return ((env.scene, st.sidx, st.ego, targets, env._target_slices,
             env.scene.obj_kind[st.sidx.long()]),
            dict(width=w, height=h, fov_deg=cam["fov"], pitch_deg=cam["pitch"],
                 cam_height=cam["height"], max_dist=cam["max_dist"]))


def camera_gaps(args, kw):
    """The kernel's frame against the plain chain's: {modality: (max abs
    difference, pixels that differ)}, one kernel launch."""
    import torch

    from metadrive_ped_torch.ops import camera
    before = camera.launches
    out = camera.render(*args, **kw)
    ref = camera.render_plain(*args, **kw)
    torch.cuda.synchronize()
    if camera.launches != before + 1:
        raise AssertionError(f"camera: {camera.launches - before} kernel launches for a frame")
    return {k: (float((out[k] - ref[k]).abs().max()), int((out[k] != ref[k]).any(-1).sum()))
            for k in camera.MODALITIES}


def camera_case(name, env, iters):
    """The camera kernel against the plain chain at ``env``'s state: every
    modality bit-equal (max abs difference 0.0), the kernel's ms by events
    (its torch launches for the cosines and sines included) and by the
    profiler (the kernel alone), the plain chain's, the frame's bound."""
    from metadrive_ped_torch.ops import camera
    args, kw = camera_args(env)
    gaps = camera_gaps(args, kw)
    if any(gap != (0.0, 0) for gap in gaps.values()):
        raise AssertionError(f"{name}: the camera kernel differs from the plain chain: {gaps}")
    frame = lambda: camera.render(*args, **kw)  # noqa: E731
    (bound_ms, bound_by), pairs = camera_pairs_bound(env)
    device_ms = kernel_device_ms(frame, iters, kernel="camera_kernel")
    row = dict(case=name, E=env.num_envs, camera=list(env._sensor_spec()), pairs=pairs,
               max_abs_err=gaps, tol=0.0, ms=time_ms(frame, iters), device_ms=device_ms,
               plain_ms=time_ms(lambda: camera.render_plain(*args, **kw), 2, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / device_ms if device_ms else None, library_ms=None)
    emit(phase="camera_vs_plain", **row)
    return row


def in_unit_range(x, shape):
    import torch
    x = x.float()
    return (tuple(x.shape) == shape and bool(torch.isfinite(x).all())
            and bool(((x >= 0) & (x <= 1)).all()))


def drive_image_obs(card):
    """The camera observation at IMAGE_OBS: the kernel against its plain
    version on the env's line table at E = 1024, then IMAGE_STEPS steps
    through `step`, the rate over the second half, the camera's and the step's launches and
    device ms from the profiler, peak memory, steps + 1 kernel launches (the
    state half), and image and state in [0, 1]."""
    import torch

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.ops import camera
    env = MetaDriveEnv(IMAGE_OBS, device=DEVICE)
    E = env.num_envs
    env.reset(seed=0)
    krow = kernel_case("image_obs", detector_args(env), iters=20)
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
    camera.launches = 0
    obs, seconds, finished, launches, peak = image_steps(env, act, IMAGE_STEPS, IMAGE_TIMED_FROM)
    camera_launches = camera.launches
    image_ok = in_unit_range(obs["image"], (E, 84, 84, 3, IMAGE_OBS["stack_size"]))
    state_ok = in_unit_range(obs["state"], (E, env.observation_dim))
    L, B = env.scene.lane_kind.shape[1], env.scene.seg_type.shape[1]
    T = int(env._lidar_targets(env._state)[0][0].shape[1])
    (bound_ms, bound_by), _ = camera_pairs_bound(env)
    # the camera's kernels inside its graph (two replays of the frame graph),
    # then two steps: the step's replay, the frame's, the stack
    frame = env._graphs._frame
    cam_launches, cam_ms = kernel_profile(lambda: [frame.replay() for _ in range(2)], 2)
    frames_before = env._graphs.frame_replays
    step_prof = call_profile(lambda: [env.step(act) for _ in range(2)], 2)
    row = dict(phase="image_obs", num_envs=E, camera=IMAGE_OBS["sensors"]["main_camera"],
               stack_size=IMAGE_OBS["stack_size"], steps=IMAGE_STEPS,
               rate_window=f"steps {IMAGE_TIMED_FROM}-{IMAGE_STEPS}", seconds=seconds,
               env_steps_per_s=E * (IMAGE_STEPS - IMAGE_TIMED_FROM) / seconds, card=card,
               lanes=L, segments=B, targets=T, camera_kernel_launches=camera_launches,
               expected_camera_launches=IMAGE_STEPS + 1,
               camera_launches_per_call=cam_launches, camera_device_ms_per_call=cam_ms,
               camera_bound_ms=bound_ms, camera_bound_by=bound_by,
               camera_share_of_bound=bound_ms / cam_ms if cam_ms else None,
               step_launches=step_prof["launches"], step_device_ms=step_prof["device_ms"],
               step_host_api_calls=step_prof["host_api_calls"],
               step_host_api_calls_top=step_prof["host_api_calls_top"],
               image_ok=image_ok, state_ok=state_ok, episodes_finished=finished,
               ray_segment_launches=launches, expected_launches=IMAGE_STEPS + 1,
               host_sync_checked_step=2, peak_memory_bytes=peak,
               peak_reserved_bytes=torch.cuda.max_memory_reserved(),
               captures=env._graphs.captures,
               graph=(replayed(env, IMAGE_STEPS + 2)
                      and env._graphs.frame_replays - frames_before == 2))
    emit(**row)
    if not (image_ok and state_ok):
        raise AssertionError("image_obs: image or state out of shape or range")
    if launches != IMAGE_STEPS + 1:
        raise AssertionError(f"image_obs: ray-segment kernel launched {launches} times, "
                             f"expected {IMAGE_STEPS + 1}")
    if camera_launches != IMAGE_STEPS + 1:
        raise AssertionError(f"image_obs: camera kernel launched {camera_launches} times, "
                             f"expected {IMAGE_STEPS + 1}")
    if peak > 16e9:
        raise AssertionError(f"image_obs: peak device memory {peak} bytes is above 16 GB")
    camera_case("image_obs", env, iters=20)
    return env, row, krow


def drive_camera_modalities(card, pack_path):
    """Depth, semantic, instance and the mini map at the image_obs env's
    config and pack, MODALITY_STEPS steps each: shapes and ranges."""
    import torch

    from metadrive_ped_torch import MetaDriveEnv
    launches = 0
    for modality, channels in MODALITIES:
        source = "mini_map" if modality == "mini_map" else "main_camera"
        cfg = dict(IMAGE_OBS, map_pack_file=pack_path, image_source=source,
                   sensors={source: (modality, 84, 84)})
        env = MetaDriveEnv(cfg, device=DEVICE)
        E = env.num_envs
        act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
        obs, seconds, _, n, peak = image_steps(env, act, MODALITY_STEPS, 1)
        img = obs["image"].float()
        ok = in_unit_range(img, (E, 84, 84, channels, IMAGE_OBS["stack_size"]))
        row = dict(phase="camera_modalities", modality=modality, num_envs=E, steps=MODALITY_STEPS,
                   shape=list(img.shape), image_ok=ok, min=float(img.min()), max=float(img.max()),
                   newest_frame_std=float(img[..., -1].std()), seconds=seconds,
                   env_steps_per_s=E * (MODALITY_STEPS - 1) / seconds, card=card,
                   ray_segment_launches=n, expected_launches=MODALITY_STEPS + 1,
                   peak_memory_bytes=peak, graph=replayed(env, MODALITY_STEPS))
        emit(**row)
        if not ok or row["newest_frame_std"] == 0:
            raise AssertionError(f"camera_modalities: {modality} out of shape or range, or blank")
        if n != MODALITY_STEPS + 1:
            raise AssertionError(f"camera_modalities: {modality}: the kernel launched {n} times")
        launches += n
        del env
    return launches


def drive_top_down(card):
    """TopDownMetaDrive at TOP_DOWN: as `drive_image_obs`, without the
    detectors (no kernel launch)."""
    import torch

    from metadrive_ped_torch import TopDownMetaDrive
    env = TopDownMetaDrive(TOP_DOWN, device=DEVICE)
    E = env.num_envs
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
    obs, seconds, finished, launches, peak = image_steps(env, act, IMAGE_STEPS, IMAGE_TIMED_FROM)
    ok = in_unit_range(obs, (E,) + tuple(env.observation_dim))
    step_launches_, step_ms = kernel_profile(lambda: [env.step(act) for _ in range(2)], 2)
    bev_launches, bev_ms = kernel_profile(
        lambda: [env._observe(env._state, None, None) for _ in range(2)], 2)
    row = dict(phase="top_down", num_envs=E, observation=list(env.observation_dim),
               frame_stack=env.config["frame_stack"], steps=IMAGE_STEPS,
               rate_window=f"steps {IMAGE_TIMED_FROM}-{IMAGE_STEPS}", seconds=seconds,
               env_steps_per_s=E * (IMAGE_STEPS - IMAGE_TIMED_FROM) / seconds, card=card,
               obs_ok=ok, road_share=float((obs[..., 0] > 0).float().mean()),
               step_launches=step_launches_, step_device_ms=step_ms,
               bev_launches_per_call=bev_launches, bev_device_ms_per_call=bev_ms,
               episodes_finished=finished, ray_segment_launches=launches, expected_launches=0,
               host_sync_checked_step=2, peak_memory_bytes=peak,
               graph=replayed(env, IMAGE_STEPS + 2))
    emit(**row)
    if not ok or row["road_share"] == 0:
        raise AssertionError("top_down: observation out of shape or range, or no road")
    if launches != 0:
        raise AssertionError(f"top_down: the detectors are off, yet the kernel launched "
                             f"{launches} times")
    return row


def render_card_vs_cpu(card):
    """RENDER_CPU_ENVS envs of the image_obs config on the card, their state
    copied to the CPU every RENDER_CHECK_EVERY steps: every camera modality,
    the mini map, the top-down frame at 50 m and 30 m, and the three render
    modes on both, held to CAMERA_TOL with each pixel beyond it checked
    (obs/pixel_check.py); and the stacked top-down env's ring on the card
    against the CPU's `_assemble` of the card's frames, bit for bit."""
    import numpy as np
    import torch

    from metadrive_ped_torch import MetaDriveEnv, TopDownMetaDrive
    from metadrive_ped_torch.core.convert import state_to_numpy
    from metadrive_ped_torch.core.structs import tree_map
    from metadrive_ped_torch.obs import pixel_check, top_down
    from metadrive_ped_torch.ops import camera
    cfg = dict(IMAGE_OBS, num_envs=RENDER_CPU_ENVS)
    gpu, cpu = MetaDriveEnv(cfg, device=DEVICE), MetaDriveEnv(cfg, device="cpu")
    E = RENDER_CPU_ENVS
    act = torch.tensor([0.0, 1.0]).expand(E, 2).contiguous()
    counted = dict(depth=0, rgb=0, semantic=0, instance=0, mini_map=0, top_down_50=0,
                   top_down_30=0, rgb_array=0)
    worst = dict(depth=0.0, rgb=0.0, semantic=0.0, instance=0.0)
    render_equal = dict(topdown=True, dashboard=True)
    gpu.reset(seed=0)
    for step in range(1, RENDER_CPU_STEPS + 1):
        gpu.step(act.to(DEVICE))
        if step % RENDER_CHECK_EVERY:
            continue
        cpu.restore(gpu.snapshot())
        tree = state_to_numpy(cpu._state)
        frames = []
        for env in (gpu, cpu):
            st = env._state
            targets, _ = env._lidar_targets(st)
            tex, org = env._map_textures()
            out = {k: v.cpu().numpy() for k, v in camera.render(
                env.scene, st.sidx, st.ego, targets, env._target_slices,
                env.scene.obj_kind[st.sidx.long()], width=84, height=84).items()}
            out["mini_map"] = top_down.observe_mini_map(
                tex, org, st.sidx, st.ego, st.npc, width=84, height=84).cpu().numpy()
            for dist in (50, 30):
                out[f"top_down_{dist}"] = top_down.observe_top_down(
                    tex, org, st.sidx, st.ego, st.npc, st.ego.past_pos,
                    max_distance=float(dist)).cpu().numpy()
            frames.append(out)
        margins = pixel_check.camera_margins(cpu, cpu._state, 84, 84)
        for k in worst:
            a, b = frames[1][k], frames[0][k]
            counted[k] += pixel_check.camera_mismatches(a, b, margins, CAMERA_TOL[k])
            worst[k] = max(worst[k], float(np.abs(a - b).max()))
        tex, org = (x.numpy() for x in cpu._map_textures())
        counted["mini_map"] += pixel_check.check_frame(
            frames[1]["mini_map"], frames[0]["mini_map"], "mini_map", tree, tex, org,
            *pixel_check.grid(84, 84, 50.0, look_ahead=20.0))
        for dist in (50, 30):
            key = f"top_down_{dist}"
            counted[key] += pixel_check.check_frame(
                frames[1][key], frames[0][key], "top_down", tree, tex, org,
                *pixel_check.grid(84, 84, float(dist)))
        for mode in render_equal:
            render_equal[mode] &= bool(np.array_equal(gpu.render(mode, env_index=1),
                                                      cpu.render(mode, env_index=1)))
        # rgb_array: the uint8 of the camera's float frame at 256x144 of row 1
        mine, theirs = gpu.render("rgb_array", env_index=1), cpu.render("rgb_array", env_index=1)
        one = tree_map(lambda x: x[1:2], cpu._state)
        m = pixel_check.camera_margins(cpu, one, 256, 144)[0].reshape(144, 256)
        differ = (mine != theirs).any(-1)
        level = np.abs(mine.astype(int) - theirs).max(-1)
        if not ((level <= 1) | (m < pixel_check.EDGE_TOL))[differ].all():
            raise AssertionError("render_card_vs_cpu: rgb_array differs away from a threshold")
        counted["rgb_array"] += int(differ.sum())

    # the stacked top-down env's ring: the card's observations against the
    # CPU's _assemble of the card's own frames
    tdg = TopDownMetaDrive(dict(TOP_DOWN, num_envs=E, horizon=8), device=DEVICE)
    tdc = TopDownMetaDrive(dict(TOP_DOWN, num_envs=E, horizon=8), device="cpu")
    obs, _ = tdg.reset(seed=0)
    ring_equal = bool(torch.equal(obs.cpu(), tdc._assemble(tdg._last_obs.cpu())))
    dones = 0
    for _ in range(RENDER_CPU_STEPS):
        obs, _, te, tr, _ = tdg.step(act.to(DEVICE))
        done = (te | tr).cpu()
        dones += int(done.sum())
        ring_equal &= bool(torch.equal(obs.cpu(), tdc._assemble(tdg._last_obs.cpu(), done)))
    row = dict(phase="render_card_vs_cpu", num_envs=E, steps=RENDER_CPU_STEPS,
               checked_every=RENDER_CHECK_EVERY, camera=cfg["sensors"]["main_camera"],
               tol=CAMERA_TOL, max_abs_err=worst, pixels_beyond_tol_checked=counted,
               render_equal=render_equal, stacked_ring_equal=ring_equal, ring_dones=dones,
               card=card,
               graph=replayed(gpu, RENDER_CPU_STEPS) and replayed(tdg, RENDER_CPU_STEPS))
    emit(**row)
    if not (all(render_equal.values()) and ring_equal and dones > 0):
        raise AssertionError(f"render_card_vs_cpu: render or ring differ: {row}")


def sharded_meshes():
    """[cuda:0, cuda:0] (one card's batch in two), and every device where
    there are more than one."""
    import torch
    meshes = [("cuda:0", "cuda:0")]
    if torch.cuda.device_count() > 1:
        meshes.append(tuple(f"cuda:{i}" for i in range(torch.cuda.device_count())))
    return meshes


def drive_checked_last(env, collect, steps):
    """As `drive`, but the step checked for host syncs is the second of two
    more steps after the run (the first captures the step that collects
    nothing): these runs collect the reward, whose mean `rollout` reads on
    the host. Returns (the collected fields [steps, rows], the
    seconds of the second half, kernel launches in all and by device)."""
    import torch

    from metadrive_ped_torch.ops import ray_segment as rs
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(env.num_envs, 2).contiguous()
    torch.cuda.reset_peak_memory_stats()
    rs.launches = 0
    rs.launches_by_device.clear()
    env.reset(seed=0)
    warm, _ = env.rollout(steps // 2, actions=act, collect=collect)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, _ = env.rollout(steps - steps // 2, actions=act, collect=collect)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_device = rs.launches, dict(rs.launches_by_device)
    # one more step captures the collect=() step (capture synchronises);
    # the step after it, a replay, runs under the sync check
    env.rollout(1, actions=act, collect=())
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.rollout(1, actions=act, collect=())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return {k: torch.cat([warm[k], timed[k]]) for k in collect}, seconds, launches, by_device


def drive_sharded(phase, make_env, cfg, card, steps, kernel_rows=None):
    """One config unsharded, then through ShardedEnv over each mesh of
    `sharded_meshes`, reset with one seed and driven at full throttle: the
    sharded outputs against the unsharded ones, rates, launches of a step,
    and the kernel's launches by device. With ``kernel_rows``, the kernel
    against its plain version at the first shard's shapes is appended to
    it. Returns the kernel launches of the phase."""
    import torch

    from metadrive_ped_torch.ops import ray_segment as rs
    from metadrive_ped_torch.parallel import ShardedEnv, make_mesh
    collect = ("obs", "reward", "terminated", "truncated")
    timed = steps - steps // 2

    def run(env):
        before = replays(env)
        shards_before = shard_replays(env)
        outs, seconds, launches, by_device = drive_checked_last(env, collect, steps)
        act = torch.tensor([0.0, 1.0], device=DEVICE).expand(env.num_envs, 2).contiguous()
        # one replayed step that collects nothing, as drive_checked_last's last
        prof = call_profile(lambda: env.rollout(1, actions=act, collect=()), 1)
        # drive_checked_last's steps + 2, the profiled step; each shard's too
        shards = [r - b for r, b in zip(shard_replays(env), shards_before)]
        rate = dict(env_steps_per_s=cfg["num_envs"] * timed / seconds,
                    row_steps_per_s=env.num_envs * timed / seconds,
                    launches_per_step=prof["launches"], device_ms_per_step=prof["device_ms"],
                    host_api_calls_per_step=prof["host_api_calls"],
                    host_api_calls_top=prof["host_api_calls_top"],
                    kernel_runs_per_step=prof["detector_runs"],
                    kernel_device_ms_in_replay=prof["detector_device_ms"],
                    kernel_launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    shard_replays=shards,
                    graph=(replayed(env, steps + 3, before)
                           and all(r == steps + 3 for r in shards)))
        return outs, rate, by_device

    t_phase = time.perf_counter()
    plain = make_env(cfg, device=DEVICE)
    detectors = plain._line_table is not None
    ref, plain_rate, _ = run(plain)
    launches = plain_rate["kernel_launches"]
    expected_plain = steps + 1 if detectors else 0
    failures = [] if launches == expected_plain else [
        f"unsharded kernel launches {launches}, expected {expected_plain}"]
    for mesh in sharded_meshes():
        mesh = make_mesh(mesh)
        # the sharded env wraps the same env: its shards are views of it
        senv = ShardedEnv(plain, mesh)
        outs, rate, by_device = run(senv)
        if kernel_rows is not None and len(kernel_rows) == 0:
            kernel_rows.append(kernel_case(f"{phase}_shard", detector_args(senv.shards[0]),
                                           iters=20))
        del senv
        gap = lambda k: float((outs[k] - ref[k]).abs().max())
        obs_err, rew_err = gap("obs"), gap("reward")
        flags = sum(int((outs[k] != ref[k]).sum()) for k in ("terminated", "truncated"))
        expected = {d.index: mesh.count(d) * (steps + 1) for d in set(mesh)} if detectors else {}
        launches += rate["kernel_launches"]
        emit(phase=phase, mesh=[str(d) for d in mesh], num_envs=cfg["num_envs"],
             rows=int(ref["reward"].shape[1]), steps=steps,
             rate_window=f"steps {steps // 2}-{steps}", unsharded=plain_rate, sharded=rate,
             sharded_over_unsharded=rate["env_steps_per_s"] / plain_rate["env_steps_per_s"],
             obs_max_abs_err=obs_err, reward_max_abs_err=rew_err,
             tol=dict(obs=SHARD_OBS_TOL, reward=SHARD_REWARD_TOL), flag_mismatches=flags,
             episodes_finished=int((ref["terminated"] | ref["truncated"]).sum()),
             kernel_launches_by_device={str(k): v for k, v in by_device.items()},
             expected_launches_by_device={str(k): v for k, v in expected.items()},
             host_sync_checked_step=steps + 2, phase_seconds=time.perf_counter() - t_phase,
             card=card)
        if not (obs_err <= SHARD_OBS_TOL and rew_err <= SHARD_REWARD_TOL and flags == 0):
            failures.append(f"{mesh}: sharded outputs differ from the unsharded ones")
        if by_device != expected or rate["kernel_launches"] != sum(expected.values()):
            failures.append(f"{mesh}: kernel launches {by_device}, expected {expected}")
        del outs
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    return launches


def dist_worker(rank, init_method):
    """One rank of the `distributed` phase: the main path's config at
    DIST_ENVS envs over this rank's stride of the scenarios, driven on
    cuda:0; prints one RESULT line of JSON."""
    import torch
    import torch.distributed as dist

    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.parallel import init_distributed
    rank, world = init_distributed(init_method, 2, rank, backend="gloo", timeout=DIST_TIMEOUT)
    try:
        env = MetaDriveEnv(dict(MAIN_PATH, num_envs=DIST_ENVS, worker_index=rank,
                                num_workers=world), device="cuda:0")
        outs, seconds, launches, _ = drive_checked_last(env, ("reward", "env_seed"), DIST_STEPS)
        mine = float(outs["reward"].mean())
        gathered = [torch.zeros(1, dtype=torch.float64) for _ in range(world)]
        dist.all_gather(gathered, torch.tensor([mine], dtype=torch.float64))
        print("RESULT " + json.dumps(dict(
            rank=rank, world=world, seeds=env._seeds.tolist(),
            seen=sorted(set(outs["env_seed"].flatten().tolist())), mean_reward=mine,
            gathered=[float(g) for g in gathered], kernel_launches=launches,
            env_steps_per_s=DIST_ENVS * (DIST_STEPS - DIST_STEPS // 2) / seconds,
            graph=replayed(env, DIST_STEPS + 2))), flush=True)
    finally:
        dist.destroy_process_group()


def drive_distributed(card):
    """Two ranks of `dist_worker` on cuda:0 through a file:// store; every
    wait has a timeout. Returns the kernel launches of both ranks."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-rank",
                                   str(r), "--dist-init", init],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate(timeout=60)
    results = {}
    for out in outs:
        lines = [line for line in out.splitlines() if line.startswith("RESULT ")]
        if not lines:
            raise AssertionError(f"distributed: a rank printed no result:\n{out[-3000:]}")
        r = json.loads(lines[0][len("RESULT "):])
        r["backend_line"] = next((line for line in out.splitlines()
                                  if line.startswith("init_distributed:")), None)
        results[r["rank"]] = r
    r0, r1 = results.get(0), results.get(1)
    ok = (r0 is not None and r1 is not None and r0["world"] == r1["world"] == 2
          and not set(r0["seeds"]) & set(r1["seeds"])
          and set(r0["seen"]) <= set(r0["seeds"]) and set(r1["seen"]) <= set(r1["seeds"])
          and r0["gathered"] == r1["gathered"] == [r0["mean_reward"], r1["mean_reward"]]
          and r0["kernel_launches"] == r1["kernel_launches"] == DIST_STEPS + 1)
    emit(phase="distributed", ranks=2, backend="gloo", device="cuda:0", num_envs_per_rank=DIST_ENVS,
         steps=DIST_STEPS, results=[results.get(0), results.get(1)],
         phase_seconds=time.perf_counter() - t_phase, card=card,
         graph=all(r is not None and r["graph"] for r in (r0, r1)))
    if not ok:
        raise AssertionError("distributed: strides, gathered rewards or launches are wrong")
    return r0["kernel_launches"] + r1["kernel_launches"]


def drive_data_parallel(card, synthetic):
    """Phases 28-32; returns (their kernel launches by phase, the kernel
    against its plain version at a sharded_pg shard's shapes). The PG
    phases build the main path's scene pack once (`map_pack_file`)."""
    import tempfile

    import metadrive_ped_torch as port
    kernel_rows = []
    with tempfile.TemporaryDirectory() as d:
        pack = port.MetaDriveEnv(MAIN_PATH, device=DEVICE).dump_all_maps(
            os.path.join(d, "main_path.pkl"))
        launches = dict(
            sharded_pg=drive_sharded("sharded_pg", port.MetaDriveEnv,
                                     dict(MAIN_PATH, map_pack_file=pack), card, STEPS,
                                     kernel_rows),
            sharded_noise=drive_sharded("sharded_noise", port.MetaDriveEnv,
                                        dict(SHARDED_NOISE, map_pack_file=pack), card,
                                        SHARDED_NOISE_STEPS))
    launches.update(
        sharded_marl=drive_sharded("sharded_marl", port.MultiAgentRoundaboutEnv, SHARDED_MARL,
                                   card, SHARDED_MARL_STEPS),
        sharded_scenario=drive_sharded("sharded_scenario", port.ScenarioEnv,
                                       dict(SHARDED_SCENARIO, scenario_data=synthetic), card,
                                       SHARDED_SCENARIO_STEPS),
        distributed=drive_distributed(card))
    return launches, kernel_rows[0]


def drive_kernel_scene(phase, name, card):
    """A multi-agent scene of KERNEL_SCENES at KERNEL_SCENE_ENVS envs: the
    kernel against its plain version on the env's line table, then
    `drive_marl` for KERNEL_SCENE_STEPS steps with steps + 1 launches.
    Returns (the kernel's row, the phase's launches)."""
    import metadrive_ped_torch as port
    env = getattr(port, name)(dict(num_envs=KERNEL_SCENE_ENVS), device=DEVICE)
    env.reset(seed=0)
    krow = kernel_case(phase, detector_args(env), iters=20)
    if krow["hits"][0] == 0:
        raise AssertionError(f"{phase}: the side detector saw no line")
    launches = drive_marl(phase, env, card, expected_launches=KERNEL_SCENE_STEPS + 1,
                          steps=KERNEL_SCENE_STEPS)["ray_segment_launches"]
    return krow, launches


def run_bench(args, card):
    """``python3 bench_torch.py *args`` in a child process, with a timeout:
    (its per-family lines, its last line). Checks the card line, each
    family's width, rate and timed kernel launches, and the last line's
    keys; emits one bench_torch line."""
    import torch
    torch.cuda.empty_cache()  # leave the card's memory to the child
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"bench_torch.py {args} exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    families = [json.loads(line) for line in lines if line.startswith('{"family"')]
    last = json.loads(lines[-1])
    emit(phase="bench_torch", args=list(args), card_line=lines[0], families=families, last=last,
         seconds=seconds, card=card, graph=all(row["graph"] for row in families))
    failures = [] if lines[0] == card else [f"card line {lines[0]!r}, expected {card!r}"]
    for row in families:
        fam = row["family"]
        expected = BENCH_STEPS if fam in BENCH_DETECTORS else 0
        if row["ray_segment_launches"] != expected:
            failures.append(f"{fam}: kernel launched {row['ray_segment_launches']} times in the "
                            f"timed call, expected {expected}")
        if row["rows"] != BENCH_ROWS[fam] or row["steps"] != BENCH_STEPS:
            failures.append(f"{fam}: {row['rows']} rows x {row['steps']} steps, expected "
                            f"{BENCH_ROWS[fam]} x {BENCH_STEPS}")
        if not row["rate"] > 0:
            failures.append(f"{fam}: rate {row['rate']}")
        if not row["graph"]:
            failures.append(f"{fam}: the timed call did not replay a graph")
    keys = BENCH_KEYS | ({"configs"} if len(families) > 1 else set())
    if set(last) != keys:
        failures.append(f"last line keys {sorted(last)}, expected {sorted(keys)}")
    if failures:
        raise AssertionError("bench_torch: " + "; ".join(failures))
    return families, last


def drive_bench(card):
    """bench_torch.py with every default family, then scenario_recorded:
    returns the kernel's launches in their timed calls."""
    families, last = run_bench(["--config", "all", "--steps", str(BENCH_STEPS)], card)
    default = tuple(f for f in BENCH_ROWS if f != "scenario_recorded")
    if (tuple(r["family"] for r in families) != default or set(last["configs"]) != set(default)
            or not all(v > 0 for v in last["configs"].values())
            or last["value"] != last["configs"]["pg"] or last["metric"] != "env_steps_per_s_1chip"):
        raise AssertionError(f"bench_torch: the default run's line is wrong: {last}")
    recorded, _ = run_bench(["--config", "scenario_recorded", "--steps", str(BENCH_STEPS)], card)
    return sum(r["ray_segment_launches"] for r in families + recorded)


def main():
    import torch
    if "--dist-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        dist_worker(int(args["--dist-rank"]), args["--dist-init"])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    # the expert's products (policies/expert.py) hold 1e-4 parity only in
    # full float32
    tf32 = dict(matmul_precision=torch.get_float32_matmul_precision(),
                matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    if tf32 != dict(matmul_precision="highest", matmul_allow_tf32=False):
        raise AssertionError(f"float32 matmuls must run without TF32: {tf32}")
    from bench_torch import card_name_and_power
    from metadrive_ped_torch import MetaDriveEnv
    from metadrive_ped_torch.core import cuda_build
    from metadrive_ped_torch.ops import ray_segment as rs

    card = card_name_and_power()
    emit(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), **tf32)

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
    table, counts = env._line_table
    emit(phase="env_build", seconds=time.perf_counter() - t0, num_envs=E,
         scenarios=env.num_scenarios, obs_dim=env.observation_dim,
         segments=int(env.scene.seg_type.shape[1]), line_table_rows=int(table.shape[1]),
         n_cont=counts[:, 0].tolist(), n_any=counts[:, 1].tolist())
    main_row = kernel_case("main_path", detector_args(env), iters=50)
    rows = [main_row] + [kernel_case(name, to_device(make(), DEVICE), iters=20)
                         for name, make in line_cases().items()]

    # ---- the main path at full width --------------------------------------
    act = torch.tensor([0.0, 1.0], device=DEVICE).expand(E, 2).contiguous()
    rs.launches = 0
    obs, _ = env.reset(seed=0)
    finished = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for i in range(TIMED_FROM - 1):
        if i == 1:
            # a replayed step must not synchronise with the host (step 0
            # captured it, and capture synchronises)
            torch.cuda.set_sync_debug_mode("error")
        obs, reward, term, trunc, info = env.step(act)
        torch.cuda.set_sync_debug_mode(0)
        finished += (term | trunc).sum()
    # the last untimed step captures the rollout's graph
    outs, _ = env.rollout(1, actions=act, collect=("terminated", "truncated"))
    finished += (outs["terminated"] | outs["truncated"]).sum()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, _ = env.rollout(STEPS - TIMED_FROM, actions=act, collect=("terminated", "truncated"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rs.launches
    finished += (outs["terminated"] | outs["truncated"]).sum()
    obs = env._last_obs
    obs_ok = bool(torch.isfinite(obs).all()) and bool(((obs >= 0) & (obs <= 1)).all())
    # a replay's launches are counted from its capture's tally: over
    # PROFILED_STEPS more replays, the count against the kernel's runs that
    # the profiler records
    rs.launches = 0
    profiled = kernel_runs(lambda: env.rollout(PROFILED_STEPS, actions=act,
                                               collect=("terminated", "truncated")))
    window = dict(steps=PROFILED_STEPS, launches_counted=rs.launches, kernel_runs_profiled=profiled)
    emit(phase="env", num_envs=E, steps=STEPS, rate_window=f"steps {TIMED_FROM}-{STEPS}",
         seconds=seconds, env_steps_per_s=E * (STEPS - TIMED_FROM) / seconds, card=card,
         obs_shape=list(obs.shape), obs_ok=obs_ok, episodes_finished=int(finished),
         ray_segment_launches=launches, expected_launches=STEPS + 1,
         profiled_replays=window,
         host_sync_checked_step=2, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         graph=replayed(env, STEPS + PROFILED_STEPS))
    if tuple(obs.shape) != (E, env.observation_dim) or not obs_ok:
        raise AssertionError("observation out of shape or range")
    if launches != STEPS + 1:
        raise AssertionError(f"ray-segment kernel launched {launches} times, expected {STEPS + 1}")
    if not window["launches_counted"] == window["kernel_runs_profiled"] == PROFILED_STEPS:
        raise AssertionError(f"replayed steps: counted launches against the profiler's kernel "
                             f"runs {window}")
    if int(finished) == 0:
        raise AssertionError("no episode finished in 200 steps")
    del outs
    graph_vs_eager("pg_detectors", env, STEPS, card, timed_from=TIMED_FROM)
    del env

    # ---- the card against the CPU -----------------------------------------
    obs_err, rew_err, flag_mismatches, graph = card_vs_cpu(MetaDriveEnv,
                                                           dict(MAIN_PATH, num_envs=32))
    emit(phase="card_vs_cpu", num_envs=32, steps=20, obs_max_abs_err=obs_err,
         reward_max_abs_err=rew_err, tol=CPU_TOL, flag_mismatches=flag_mismatches, graph=graph)
    if not (obs_err <= CPU_TOL and rew_err <= CPU_TOL and flag_mismatches == 0):
        raise AssertionError("the card and the CPU disagree")
    run_cuda_tests(card)

    # ---- the scenario path ------------------------------------------------
    from metadrive_ped_torch import ScenarioEnv
    from metadrive_ped_torch.scenario import export_scenarios
    from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
    t0 = time.perf_counter()
    synthetic = [synthetic_waymo_sd(seed) for seed in range(SYNTHETIC_SCENARIOS)]
    env = ScenarioEnv(dict(SCENARIO_REPLAY, scenario_data=synthetic), device=DEVICE)
    emit(phase="scenario_build", source="synthetic", seconds=time.perf_counter() - t0,
         scenarios=env.num_scenarios, tracks=int(env.scene.trk_pos.shape[1]),
         horizon=int(env.scene.trk_pos.shape[2]), lanes=int(env.scene.lane_pts.shape[1]),
         reactive_slots=int(env.scene.trk_unpts.shape[1]),
         route_points=int(env.scene.trk_upath_q.shape[2]),
         segments=int(env.scene.seg_type.shape[1]), obs_dim=env.observation_dim)
    env.reset(seed=0)
    rows.append(kernel_case("scenario_replay", scenario_kernel_args(env), iters=20))
    phase_launches = dict(env=launches)
    phase_launches["scenario_replay"] = drive_scenario(
        "scenario_replay", env, card)["ray_segment_launches"]
    del env
    env = ScenarioEnv(dict(SCENARIO_REACTIVE, scenario_data=synthetic), device=DEVICE)
    row = drive_scenario("scenario_reactive", env, card)
    phase_launches["scenario_reactive"] = row["ray_segment_launches"]
    if not row["npc_long_max"] > 0:
        raise AssertionError("scenario_reactive: no reactive car moved along its route")
    del env

    t0 = time.perf_counter()
    src = MetaDriveEnv(LINES_SOURCE, device=DEVICE)
    src.reset(seed=0)
    full = torch.tensor([0.0, 1.0], device=DEVICE).expand(src.num_envs, 2).contiguous()
    exported = list(export_scenarios(src, EXPORT_STEPS, actions=full).values())
    del src
    env = ScenarioEnv(dict(SCENARIO_LINES, scenario_data=exported), device=DEVICE)
    emit(phase="scenario_build", source="pg_export", seconds=time.perf_counter() - t0,
         scenarios=env.num_scenarios, tracks=int(env.scene.trk_pos.shape[1]),
         horizon=int(env.scene.trk_pos.shape[2]), lanes=int(env.scene.lane_pts.shape[1]),
         segments=int(env.scene.seg_type.shape[1]), obs_dim=env.observation_dim)
    env.reset(seed=0)
    lines_row = kernel_case("scenario_lines", scenario_kernel_args(env), iters=20)
    if lines_row["hits"][0] == 0:
        raise AssertionError("scenario_lines: the side detector saw no line")
    rows.append(lines_row)
    phase_launches["scenario_lines"] = drive_scenario(
        "scenario_lines", env, card)["ray_segment_launches"]
    graph_vs_eager("scenario_lines", env, GRAPH_STEPS, card)
    del env

    obs_err, rew_err, flag_mismatches, graph = card_vs_cpu(
        ScenarioEnv, dict(SCENARIO_LINES, num_envs=32, scenario_data=exported))
    emit(phase="scenario_card_vs_cpu", num_envs=32, steps=20, obs_max_abs_err=obs_err,
         reward_max_abs_err=rew_err, tol=CPU_TOL, flag_mismatches=flag_mismatches, graph=graph)
    if not (obs_err <= CPU_TOL and rew_err <= CPU_TOL and flag_mismatches == 0):
        raise AssertionError("scenario: the card and the CPU disagree")

    # ---- safe and multi-agent ---------------------------------------------
    import metadrive_ped_torch as port
    phase_launches["safe"] = drive_safe(card)["ray_segment_launches"]
    for phase, cfg in (("marl", MARL), ("marl_40", MARL_40)):
        env = port.MultiAgentRoundaboutEnv(cfg, device=DEVICE)
        row = drive_marl(phase, env, card, expected_launches=0)
        phase_launches[phase] = row["ray_segment_launches"]
        if phase == "marl_40" and row["respawns"] == 0:
            raise AssertionError("marl_40: no agent respawned in 200 steps")
        del env

    env = port.MultiAgentTollgateEnv(MARL_TOLLGATE, device=DEVICE)
    env.reset(seed=0)
    toll_row = kernel_case("marl_tollgate", detector_args(env), iters=20)
    if toll_row["hits"][0] == 0:
        raise AssertionError("marl_tollgate: the side detector saw no line")
    rows.append(toll_row)
    phase_launches["marl_tollgate"] = drive_marl("marl_tollgate", env, card,
                                                 expected_launches=STEPS + 1)["ray_segment_launches"]
    graph_vs_eager("marl_tollgate", env, GRAPH_STEPS, card)
    del env

    for name, cfg in MARL_CPU:
        obs_err, rew_err, flag_mismatches, graph = card_vs_cpu(
            getattr(port, name), cfg, state_ints=("dead_timer", "ego.slot"))
        emit(phase="marl_card_vs_cpu", env=name, num_envs=cfg["num_envs"],
             num_agents=cfg["num_agents"], steps=20, obs_max_abs_err=obs_err,
             reward_max_abs_err=rew_err, tol=CPU_TOL, flag_mismatches=flag_mismatches,
             graph=graph)
        if not (obs_err <= CPU_TOL and rew_err <= CPU_TOL and flag_mismatches == 0):
            raise AssertionError(f"{name}: the card and the CPU disagree")

    # ---- expert traffic, the AI protector, lidar noise ---------------------
    mixed_row, npc_row, mixed_phase = drive_mixed(card)
    rows.append(mixed_row)
    phase_launches["mixed_traffic"] = mixed_phase["ray_segment_launches"]
    phase_launches["ai_protect_noise"] = drive_ai_protect(card)["ray_segment_launches"]
    for name, cfg, action, state_ints in SLICE4_CPU:
        obs_err, rew_err, flag_mismatches, graph = card_vs_cpu(
            getattr(port, name), cfg, state_ints=state_ints, action=action)
        emit(phase="slice4_card_vs_cpu", env=name, num_envs=cfg["num_envs"],
             num_agents=cfg.get("num_agents"), options={k: cfg[k] for k in (
                 "rl_agent_ratio", "agent_policy", "use_AI_protector") if k in cfg},
             steps=20, obs_max_abs_err=obs_err, reward_max_abs_err=rew_err, tol=CPU_TOL,
             flag_mismatches=flag_mismatches, graph=graph)
        if not (obs_err <= CPU_TOL and rew_err <= CPU_TOL and flag_mismatches == 0):
            raise AssertionError(f"{name} {cfg}: the card and the CPU disagree")

    # ---- the trainer's surface -------------------------------------------
    for phase, name in UNTRIED_SCENES:
        cls = getattr(port, name)
        obs_err, rew_err, flag_mismatches, graph = card_vs_cpu(cls, dict(num_envs=4),
                                                               state_ints=MULTI)
        emit(phase="marl_card_vs_cpu", env=name, num_envs=4, steps=20, obs_max_abs_err=obs_err,
             reward_max_abs_err=rew_err, tol=CPU_TOL, flag_mismatches=flag_mismatches,
             graph=graph)
        if not (obs_err <= CPU_TOL and rew_err <= CPU_TOL and flag_mismatches == 0):
            raise AssertionError(f"{name}: the card and the CPU disagree")
        env = cls(dict(num_envs=UNTRIED_ENVS), device=DEVICE)
        expected = UNTRIED_STEPS + 1 if env._line_table is not None else 0
        phase_launches[phase] = drive_marl(phase, env, card, expected_launches=expected,
                                           steps=UNTRIED_STEPS)["ray_segment_launches"]
        del env
    mix_rows, phase_launches["mix_waymo_pg"] = drive_mix(card, synthetic)
    rows += mix_rows
    import tempfile

    from metadrive_ped_torch.mapgen.opendrive import TWO_ROAD_XODR
    with tempfile.TemporaryDirectory() as d:
        xodr_path = os.path.join(d, "two_road.xodr")
        with open(xodr_path, "w") as f:
            f.write(TWO_ROAD_XODR)
        od_row, phase_launches["opendrive"] = drive_opendrive(card, xodr_path)
    rows.append(od_row)
    phase_launches["snapshot_replay"] = drive_snapshot(card)

    # ---- pixel observations ---------------------------------------------
    env, row, krow = drive_image_obs(card)
    rows.append(krow)
    phase_launches["image_obs"] = row["ray_segment_launches"]
    with tempfile.TemporaryDirectory() as d:
        pack_path = env.dump_all_maps(os.path.join(d, "maps.pkl"))
        del env
        phase_launches["camera_modalities"] = drive_camera_modalities(card, pack_path)
    drive_top_down(card)
    phase_launches["top_down"] = 0
    render_card_vs_cpu(card)
    parallel_launches, shard_row = drive_data_parallel(card, synthetic)
    phase_launches.update(parallel_launches)
    rows.append(shard_row)
    for phase, name in KERNEL_SCENES:
        krow, phase_launches[phase] = drive_kernel_scene(phase, name, card)
        rows.append(krow)
    phase_launches["bench_torch"] = drive_bench(card)
    params, batch, _ = drive_ppo(card)
    phase_launches["ppo_train"] = 0
    ppo_card_vs_cpu(params, batch)
    del batch

    # ---- the kernels line ------------------------------------------------
    print(json.dumps({"kernels": [dict(
        name="ray_segment", route="cuda", source="metadrive_ped_torch/csrc/ray_segment.cu",
        replaces="metadrive_ped_tpu/ops/pallas_raycast.py:72",
        launches=sum(phase_launches.values()),
        max_abs_err=max(r["max_abs_err"] for r in rows),
        # per env step at the main path's shapes: one launch for both clouds
        ms=main_row["ms"], plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=None,
    ), dict(
        name="npc_lidar", route="cuda", source="metadrive_ped_torch/csrc/npc_lidar.cu",
        replaces=None, launches=mixed_phase["npc_lidar_launches"],
        max_abs_err=npc_row["max_abs_err"],
        # per env step of mixed_traffic: one launch for every slot's fan
        ms=npc_row["ms"], plain_ms=npc_row["plain_ms"], bound_ms=npc_row["bound_ms"],
        bound_by=npc_row["bound_by"], library_ms=None,
    )]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
