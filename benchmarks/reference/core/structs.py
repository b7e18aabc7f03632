"""State structures as dataclasses of tensors.

Every field is batched over the env axis ``[E, ...]`` (NPCs add a slot axis
``[E, N, ...]``); maps are stacked per-scenario arrays ``[S, ...]``. One
step advances all envs in lockstep with batched tensor ops.

`Scene.from_pack` builds its derived tables on the host with numpy, so the
scene that reaches the device is bit-equal to the one the JAX package
builds from the same pack.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmarks.reference.constants import LANE_CIRCULAR


class _Tree:
    """Dataclass of tensors (or of nested `_Tree`s)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over one or more dataclass trees of the same
    structure."""
    if isinstance(tree, _Tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def map_tensors(fn, x):
    """``fn`` on every tensor of ``x``: a tensor, a `_Tree`, or a tuple,
    list or dict of them, nested; anything else comes back as it is."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, _Tree):
        return tree_map(lambda v: map_tensors(fn, v), x)
    if type(x) in (tuple, list):
        return type(x)(map_tensors(fn, v) for v in x)
    if type(x) is dict:
        return {k: map_tensors(fn, v) for k, v in x.items()}
    return x


def take_rows(x, r0, r1, axis=0):
    """Rows [r0, r1) along ``axis`` of every tensor of ``x`` (`map_tensors`)
    that has that axis; views, no copy."""
    return map_tensors(lambda t: t.narrow(axis, r0, r1 - r0) if t.dim() > axis else t, x)


def _device_array(a, device):
    """numpy -> tensor with the JAX package's 32-bit dtypes (int64 ->
    int32, float64 -> float32)."""
    a = np.asarray(a)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a).to(device)


def quantize_segments(arrays, p0, p1, origin, span):
    """int16 boundary segments into ``arrays``: offsets of p0/p1 [S, B, 2]
    from the per-scene ``origin`` [S, 2] at seg_scale = max(0.025,
    span / 32000) m/unit, rounded on the host and clipped (not wrapped) so
    that out-of-extent padding rows cannot alias onto real coordinates;
    consumers also mask with seg_valid."""
    scale = np.maximum(0.025, span / 32000.0).astype(np.float32)
    quant = lambda p: np.clip(np.round(
        (p - origin[:, None, :]) / scale[:, None, None]
    ), -32767, 32767).astype(np.int16)
    arrays["seg_p0_q"] = quant(p0)
    arrays["seg_p1_q"] = quant(p1)
    arrays["seg_origin"] = origin.astype(np.float32)
    arrays["seg_scale"] = scale


class _SegmentScene(_Tree):
    """A scene holding int16 boundary segments (`quantize_segments`)."""

    def seg_points(self, sidx):
        """Dequantized per-env segment endpoints (p0 [E,B,2], p1 [E,B,2])."""
        s = sidx.long()
        origin = self.seg_origin[s][:, None, :]
        scale = self.seg_scale[s][:, None, None]
        p0 = origin + self.seg_p0_q[s].float() * scale
        p1 = origin + self.seg_p1_q[s].float() * scale
        return p0, p1


@dataclasses.dataclass
class Scene(_SegmentScene):
    """Stacked per-scenario arrays ``[S, ...]`` (see mapgen/scene.py)."""

    lane_kind: torch.Tensor
    lane_p0: torch.Tensor
    lane_dir: torch.Tensor
    lane_radius: torch.Tensor
    lane_start_phase: torch.Tensor
    lane_arc_dir: torch.Tensor
    lane_width: torch.Tensor
    lane_length: torch.Tensor
    lane_angle: torch.Tensor
    lane_road: torch.Tensor
    lane_idx_in_road: torch.Tensor
    lane_succ: torch.Tensor
    lane_left: torch.Tensor
    lane_right: torch.Tensor
    lane_valid: torch.Tensor
    lane_speed_limit: torch.Tensor  # [S, L] m/s
    lane_block: torch.Tensor        # [S, L] ord() of the owning block ID char
    road_lane0: torch.Tensor
    road_nlanes: torch.Tensor
    road_negative: torch.Tensor
    road_succ: torch.Tensor
    road_valid: torch.Tensor
    route_roads: torch.Tensor   # [S, SLOT, K] per-spawn-slot checkpoint roads
    route_len: torch.Tensor     # [S, SLOT]
    light_lane: torch.Tensor    # [S, LT] PG traffic lights (opt-in)
    light_long: torch.Tensor
    light_pos: torch.Tensor     # [S, LT, 2]
    light_heading: torch.Tensor
    light_width: torch.Tensor
    light_offset: torch.Tensor  # [S, LT] phase offset in steps
    light_valid: torch.Tensor
    slot_lane: torch.Tensor     # [S, SLOT] spawn lane id
    slot_long: torch.Tensor     # [S, SLOT] spawn longitude
    slot_valid: torch.Tensor
    seg_p0: torch.Tensor
    seg_p1: torch.Tensor
    seg_type: torch.Tensor
    seg_halfwidth: torch.Tensor
    seg_valid: torch.Tensor
    npc_lane: torch.Tensor
    npc_long: torch.Tensor
    npc_class: torch.Tensor
    npc_trigger_road: torch.Tensor
    npc_valid: torch.Tensor
    npc_expert: torch.Tensor
    obj_pos: torch.Tensor
    obj_heading: torch.Tensor
    obj_len: torch.Tensor
    obj_wid: torch.Tensor
    obj_kind: torch.Tensor
    obj_valid: torch.Tensor
    ped_lane: torch.Tensor
    ped_lat: torch.Tensor
    ped_long: torch.Tensor
    ped_speed: torch.Tensor
    ped_kind: torch.Tensor
    ped_len: torch.Tensor
    ped_wid: torch.Tensor
    ped_valid: torch.Tensor
    lane_table: torch.Tensor      # [S, L, LANE_F] — LANE_* columns below
    road_table: torch.Tensor      # [S, R, ROAD_F]
    # lane_table joined with each lane's left and right neighbour geometry
    # (and the neighbour's successor id): one row lookup gives the IDM gap
    # search all three lanes
    lane_nbr_table: torch.Tensor  # [S, L, LANE_F + 2*NBR_F]
    route_flat: torch.Tensor      # [S*SLOT, K]
    route_len_flat: torch.Tensor  # [S*SLOT]
    # int16 boundary-segment endpoints, offsets from seg_origin at
    # seg_scale m/unit (seg_points dequantizes)
    seg_p0_q: torch.Tensor        # [S, B, 2] int16
    seg_p1_q: torch.Tensor        # [S, B, 2] int16
    seg_origin: torch.Tensor      # [S, 2] float32
    seg_scale: torch.Tensor       # [S] float32 (>= 0.025 m)
    # spawn poses computed on the host (static per scenario)
    npc_spawn_pos: torch.Tensor      # [S, N, 2]
    npc_spawn_heading: torch.Tensor  # [S, N]
    slot_pos: torch.Tensor           # [S, SLOT, 2]
    slot_heading: torch.Tensor       # [S, SLOT]

    @classmethod
    def from_pack(cls, pack: dict, device) -> "Scene":
        arrays = {k: np.asarray(v) for k, v in pack.items()}
        lane_cols = [
            pack["lane_kind"], pack["lane_p0"][..., 0], pack["lane_p0"][..., 1],
            pack["lane_dir"][..., 0], pack["lane_dir"][..., 1], pack["lane_radius"],
            pack["lane_start_phase"], pack["lane_arc_dir"], pack["lane_width"],
            pack["lane_length"], pack["lane_angle"], pack["lane_road"],
            pack["lane_idx_in_road"], pack["lane_succ"], pack["lane_left"],
            pack["lane_right"], pack["lane_valid"],
            pack["lane_speed_limit"], pack["lane_block"],
        ]
        lt = np.stack([np.asarray(c, np.float32) for c in lane_cols], axis=-1)
        arrays["lane_table"] = lt
        road_cols = [
            pack["road_lane0"], pack["road_nlanes"], pack["road_negative"], pack["road_succ"],
        ]
        arrays["road_table"] = np.stack([np.asarray(c, np.float32) for c in road_cols], axis=-1)
        rr = np.asarray(pack["route_roads"])
        S, SLOT, K = rr.shape
        arrays["route_flat"] = rr.reshape(S * SLOT, K)
        arrays["route_len_flat"] = np.asarray(pack["route_len"]).reshape(S * SLOT)

        L = lt.shape[1]
        s_col = np.arange(S)[:, None]

        def nbr_block(ids):
            ids = np.asarray(ids, np.int64)
            rows = lt[s_col, np.clip(ids, 0, L - 1)][..., NBR_GEOM_COLS]
            rows[ids < 0] = 0.0
            rows[..., NBR_F - 1] = np.where(ids < 0, -1.0, rows[..., NBR_F - 1])
            return rows

        arrays["lane_nbr_table"] = np.concatenate(
            [lt, nbr_block(pack["lane_left"]), nbr_block(pack["lane_right"])], axis=-1,
        ).astype(np.float32)

        # int16 segment quantization (per-scene origin + adaptive scale)
        p0 = np.asarray(pack["seg_p0"], np.float32)      # [S, B, 2]
        p1 = np.asarray(pack["seg_p1"], np.float32)
        both = np.concatenate([p0, p1], axis=1) if p0.shape[1] else p0
        if both.shape[1]:
            # padding rows (seg_valid False) must not widen the span: clamp
            # them to the valid extent before computing origin/scale
            valid2 = np.concatenate(
                [np.asarray(pack["seg_valid"], bool)] * 2, axis=1
            )[..., None]                                 # [S, 2B, 1]
            any_valid = valid2.any(axis=(1, 2), keepdims=True)
            big = np.float32(np.inf)
            lo = np.where(any_valid[:, 0], np.where(valid2, both, big).min(axis=1), 0.0)
            hi = np.where(any_valid[:, 0], np.where(valid2, both, -big).max(axis=1), 0.0)
            origin = (lo + hi) / 2
            span = np.abs(hi - origin).max(axis=1)       # [S]
        else:
            origin = np.zeros((p0.shape[0], 2), np.float32)
            span = np.zeros(p0.shape[0], np.float32)
        quantize_segments(arrays, p0, p1, origin, span)

        # host-side spawn poses (numpy twin of lane_geom.position /
        # heading_theta_at at lateral 0)
        def lane_pose(ids, longs):
            ids = np.asarray(ids, np.int64)
            longs = np.asarray(longs, np.float32)
            rows = lt[s_col, np.clip(ids, 0, L - 1)]
            kind = rows[..., LANE_KIND]
            p0xy = rows[..., LANE_P0X:LANE_P0Y + 1]
            dirv = rows[..., LANE_DIRX:LANE_DIRY + 1]
            radius = np.maximum(rows[..., LANE_RADIUS], 1e-6)
            phase0 = rows[..., LANE_START_PHASE]
            arc = rows[..., LANE_ARC_DIR]
            pos_s = p0xy + longs[..., None] * dirv
            head_s = np.arctan2(dirv[..., 1], dirv[..., 0])
            phi = arc * longs / radius + phase0
            pos_c = p0xy + radius[..., None] * np.stack([np.cos(phi), np.sin(phi)], axis=-1)
            head_c = phi + 0.5 * np.pi * arc
            circ = kind == float(LANE_CIRCULAR)
            pos = np.where(circ[..., None], pos_c, pos_s).astype(np.float32)
            head = np.where(circ, head_c, head_s).astype(np.float32)
            return pos, head

        arrays["npc_spawn_pos"], arrays["npc_spawn_heading"] = lane_pose(
            pack["npc_lane"], pack["npc_long"])
        arrays["slot_pos"], arrays["slot_heading"] = lane_pose(
            pack["slot_lane"], pack["slot_long"])
        return cls(**{k: _device_array(v, device) for k, v in arrays.items()})

    @property
    def num_scenarios(self):
        return self.lane_kind.shape[0]


# lane_table column indices
LANE_KIND, LANE_P0X, LANE_P0Y, LANE_DIRX, LANE_DIRY, LANE_RADIUS, \
    LANE_START_PHASE, LANE_ARC_DIR, LANE_WIDTH, LANE_LENGTH, LANE_ANGLE, \
    LANE_ROAD, LANE_IDX_IN_ROAD, LANE_SUCC, LANE_LEFT, LANE_RIGHT, LANE_VALID, \
    LANE_SPEED_LIMIT, LANE_BLOCK = range(19)
LANE_F = 19

# columns of one neighbour block in lane_nbr_table (SUCC must stay last:
# from_pack writes the missing-neighbour sentinel there)
NBR_GEOM_COLS = [
    LANE_KIND, LANE_P0X, LANE_P0Y, LANE_DIRX, LANE_DIRY, LANE_RADIUS,
    LANE_START_PHASE, LANE_ARC_DIR, LANE_WIDTH, LANE_LENGTH, LANE_ANGLE,
    LANE_SUCC,
]
NBR_F = len(NBR_GEOM_COLS)

# road_table column indices
ROAD_LANE0, ROAD_NLANES, ROAD_NEGATIVE, ROAD_SUCC = range(4)


@dataclasses.dataclass
class VehicleParams(_Tree):
    """Per-vehicle-class dynamics parameters, batched alongside the vehicle."""

    length: torch.Tensor
    width: torch.Tensor
    accel_gain: torch.Tensor      # full-throttle acceleration [m/s^2]
    brake_gain: torch.Tensor      # full-brake deceleration [m/s^2]
    max_steer_rad: torch.Tensor   # max road-wheel angle [rad]
    max_speed_kmh: torch.Tensor
    wheelbase_eff: torch.Tensor   # effective wheelbase of the bicycle fit


@dataclasses.dataclass
class EgoState(_Tree):
    pos: torch.Tensor            # [E,2]
    heading: torch.Tensor        # [E]
    speed: torch.Tensor          # [E] signed m/s (negative = reversing)
    vel_dir: torch.Tensor        # [E] slip angle beta
    steering: torch.Tensor       # [E] normalized applied steering
    throttle: torch.Tensor       # [E] normalized throttle/brake
    last_action: torch.Tensor    # [E,2] action at t-1
    current_action: torch.Tensor  # [E,2] action at t
    last_pos: torch.Tensor       # [E,2]
    last_heading: torch.Tensor   # [E]
    lane: torch.Tensor           # [E] current lane id
    route_idx: torch.Tensor      # [E] checkpoint index into route_roads
    slot: torch.Tensor           # [E] spawn-slot index (selects the route)
    on_lane: torch.Tensor        # [E] bool
    crash_vehicle: torch.Tensor  # [E] bool
    crash_object: torch.Tensor
    crash_human: torch.Tensor
    crash_building: torch.Tensor
    crash_sidewalk: torch.Tensor
    on_yellow_line: torch.Tensor
    on_white_line: torch.Tensor
    out_of_route: torch.Tensor
    past_pos: torch.Tensor        # [E, PAST_POS_STEPS, 2] position history
    break_down: torch.Tensor      # [E] broken-down vehicles ignore actions
    params: VehicleParams         # [E] fields


PAST_POS_STEPS = 10


@dataclasses.dataclass
class NpcState(_Tree):
    pos: torch.Tensor            # [E,N,2]
    heading: torch.Tensor        # [E,N]
    speed: torch.Tensor          # [E,N]
    vel_dir: torch.Tensor        # [E,N]
    lane: torch.Tensor           # [E,N] routing target lane
    active: torch.Tensor         # [E,N] bool — spawned and alive
    released: torch.Tensor       # [E,N] bool — trigger fired
    heading_pid_i: torch.Tensor  # [E,N] PID integrator
    heading_pid_e: torch.Tensor  # [E,N] PID previous error
    lateral_pid_i: torch.Tensor
    lateral_pid_e: torch.Tensor
    overtake_timer: torch.Tensor  # [E,N] steps since last lane change
    params: VehicleParams        # [E,N] fields


@dataclasses.dataclass
class PedState(_Tree):
    """Pedestrians/cyclists walk in lane-arc coordinates along their
    sidewalk/edge line; the world pose is derived per step."""

    long: torch.Tensor           # [E,P] arc-length position
    direction: torch.Tensor      # [E,P] +1 along lane, -1 against
    active: torch.Tensor         # [E,P]


@dataclasses.dataclass
class SimState(_Tree):
    rng: torch.Tensor            # [E,2] per-env threefry key (int64 holding uint32)
    sidx: torch.Tensor           # [E] scenario index into Scene arrays
    step_count: torch.Tensor     # [E] episode length so far
    episode_reward: torch.Tensor
    episode_cost: torch.Tensor
    episode_energy: torch.Tensor  # [E] fuel use in mL
    dead_timer: torch.Tensor     # [E] multi-agent delay-done countdown
    scenario_cap: torch.Tensor   # [E] auto-reset samples sidx in [0, cap)
    aux: torch.Tensor            # [E, 4] env-family-specific counters
    policy_state: torch.Tensor   # [E, 4] agent-policy PID/latch state
    ego: EgoState
    npc: NpcState
    ped: PedState
