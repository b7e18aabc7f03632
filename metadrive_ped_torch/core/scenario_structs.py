"""State structures of the scenario (log-replay) path, as dataclasses of
tensors (see core/structs.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metadrive_ped_torch.core.structs import (
    EgoState, _device_array, _SegmentScene, _Tree, quantize_segments,
)

TRK_VEHICLE = 0
TRK_PEDESTRIAN = 1
TRK_CYCLIST = 2


@dataclasses.dataclass
class ScenarioScene(_SegmentScene):
    """Stacked per-scenario replay arrays [S, ...] (mapgen/scenario_scene.py).

    Mirrors what the reference reconstructs per episode from a
    ScenarioDescription (manager/scenario_map_manager.py +
    scenario_traffic_manager.py), flattened for lockstep replay.
    """

    sdc_pts: torch.Tensor       # [S, PT, 2] ego reference trajectory
    sdc_npts: torch.Tensor      # [S]
    sdc_track_pos: torch.Tensor      # [S, T, 2] recorded ego time series
    sdc_track_heading: torch.Tensor  # [S, T]
    sdc_track_valid: torch.Tensor    # [S, T]
    trk_pos: torch.Tensor       # [S, TRK, T, 2]
    trk_heading: torch.Tensor   # [S, TRK, T]
    trk_valid: torch.Tensor     # [S, TRK, T]
    trk_npts: torch.Tensor      # [S, TRK] valid point count per track
    trk_arclen: torch.Tensor    # [S, TRK, T] static cumulative arc length
    sdc_arclen: torch.Tensor    # [S, PT] static cumulative arc length
    trk_len: torch.Tensor       # [S, TRK]
    trk_wid: torch.Tensor       # [S, TRK]
    trk_kind: torch.Tensor      # [S, TRK] TRK_* codes
    trk_first_t: torch.Tensor   # [S, KR] first recorded-valid timestep
    # TrajectoryIDM eligibility, precomputed against the recorded sdc pose at
    # the track's first valid step (scenario_traffic_manager.py:217-235).
    # Eligible tracks sort first on the track axis and the reactive tables
    # cover only the leading KR slots (KR = max eligible count, rounded up
    # to the act-batch size)
    trk_reactive_ok: torch.Tensor  # [S, KR] bool
    scenario_len: torch.Tensor  # [S] valid timesteps
    # map-feature lane network (ScenarioMap builds ScenarioLane PointLanes
    # from map_features, component/map/scenario_map.py:9): resampled
    # centerlines for ego on-lane localization (need_lane_localization)
    lane_pts: torch.Tensor      # [S, LN, LP, 2]
    lane_npts: torch.Tensor     # [S, LN]
    lane_width: torch.Tensor    # [S, LN]
    lane_valid: torch.Tensor    # [S, LN]
    lane_arclen: torch.Tensor   # [S, LN, LP]
    seg_p0: torch.Tensor        # [S, B, 2] map boundary segments
    seg_p1: torch.Tensor
    seg_type: torch.Tensor
    seg_halfwidth: torch.Tensor
    seg_valid: torch.Tensor
    light_pos: torch.Tensor      # [S, LG, 2] stop points
    light_status: torch.Tensor   # [S, LG, T] 0 unknown / 1 green / 2 yellow / 3 red
    light_valid: torch.Tensor    # [S, LG]
    sdc_start_pos: torch.Tensor     # [S, 2]
    sdc_start_heading: torch.Tensor  # [S]
    # fixed-spacing resampled routes of the KR reactive slots, int16 offsets
    # from trk_uorigin at UPATH_QUANT m/unit
    trk_upath_q: torch.Tensor      # [S, KR, P5, 2] int16
    trk_uorigin: torch.Tensor      # [S, KR, 2] float32
    trk_unpts: torch.Tensor        # [S, KR]
    trk_utotal: torch.Tensor       # [S, KR]
    # time-major flattened copies: the pose at step t is row sidx * T + t
    trk_pos_t: torch.Tensor        # [S*T, TRK, 2]
    trk_heading_t: torch.Tensor    # [S*T, TRK]
    trk_valid_t: torch.Tensor      # [S*T, TRK]
    trk_speed_t: torch.Tensor      # [S*T, TRK] recorded body speed (IDM front
                                   # candidates expose their true speed)
    trk_spawn_speed: torch.Tensor  # [S, KR] recorded speed at first_t
    light_status_t: torch.Tensor   # [S*T, LG]
    sdc_pos_t: torch.Tensor        # [S*T, 2]
    sdc_heading_t: torch.Tensor    # [S*T]
    # int16 boundary segments, offsets from seg_origin at seg_scale m/unit
    # (seg_points dequantizes)
    seg_p0_q: torch.Tensor      # [S, B, 2] int16
    seg_p1_q: torch.Tensor      # [S, B, 2] int16
    seg_origin: torch.Tensor    # [S, 2] float32
    seg_scale: torch.Tensor     # [S] float32

    @classmethod
    def from_pack(cls, pack, device):
        arrays = {k: np.asarray(v) for k, v in pack.items()}
        # int16 segment quantization: per-scene origin at the middle of the
        # extent of all rows, padding included, and scale >= 0.025 m
        p0 = np.asarray(pack["seg_p0"], np.float32)
        p1 = np.asarray(pack["seg_p1"], np.float32)
        both = np.concatenate([p0, p1], axis=1) if p0.shape[1] else p0
        if both.shape[1]:
            origin = (both.min(axis=1) + both.max(axis=1)) / 2
            span = np.abs(both - origin[:, None, :]).max(axis=(1, 2))
        else:
            origin = np.zeros((p0.shape[0], 2), np.float32)
            span = np.zeros(p0.shape[0], np.float32)
        # every row lies within span of the origin: the clip never acts
        quantize_segments(arrays, p0, p1, origin, span)
        return cls(**{k: _device_array(v, device) for k, v in arrays.items()})

    @property
    def num_scenarios(self):
        return self.sdc_npts.shape[0]


@dataclasses.dataclass
class ScenarioSimState(_Tree):
    rng: torch.Tensor            # [E,2] per-env threefry key (int64 holding uint32)
    sidx: torch.Tensor           # [E] int32
    step_count: torch.Tensor     # [E]
    episode_reward: torch.Tensor
    episode_cost: torch.Tensor
    scenario_cap: torch.Tensor   # [E] auto-reset samples sidx in [0, cap)
    ego: EgoState                # route_idx/slot/lane unused on this path
    last_long: torch.Tensor      # [E] trajectory longitude at t-1
    cur_long: torch.Tensor       # [E]
    cur_lat: torch.Tensor        # [E]
    # reactive-traffic state (TrajectoryIDMPolicy) on the compact KR axis:
    # arc position and speed on each track's recorded path; npc_acc carries
    # the last committed IDM acceleration between act batches
    # (scenario_traffic_manager.py:75); npc_dead marks cars cleaned at
    # arrive_destination (idm_policy.py:449-455)
    npc_long: torch.Tensor       # [E, KR]
    npc_speed: torch.Tensor      # [E, KR]
    npc_acc: torch.Tensor        # [E, KR]
    npc_dead: torch.Tensor       # [E, KR] bool
    # the route pose at arc npc_long, computed once where npc_long advances
    # (the reactive traffic step) and reused by the rest of the step
    npc_upos: torch.Tensor       # [E, KR, 2]
    npc_uheading: torch.Tensor   # [E, KR]
    # global act-batch phase, a 0-d int32 tensor: on each step only tracks
    # with k % IDM_ACT_BATCH_SIZE == phase recompute their IDM acceleration
    phase: torch.Tensor
