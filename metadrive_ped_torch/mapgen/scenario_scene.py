"""ScenarioDescription -> replay scene arrays.

The reference rebuilds a Panda3D/Bullet scene per scenario
(ScenarioMapManager builds ScenarioMap from map_features,
ScenarioTrafficManager spawns per-track objects each frame,
manager/scenario_*.py). Here the whole dataset slice compiles once into
fixed-size arrays: the sdc reference trajectory, every track's time series,
and map boundary-line segments.
"""
import math

import numpy as np

from metadrive_ped_torch.constants import (
    IDM_ACT_BATCH_SIZE, SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE,
)
from metadrive_ped_torch.core.scenario_structs import TRK_CYCLIST, TRK_PEDESTRIAN, TRK_VEHICLE
from metadrive_ped_torch.mapgen.scene import _pad_to_shape
from metadrive_ped_torch.scenario.description import ScenarioDescription as SD

_TYPE_TO_KIND = {
    "VEHICLE": TRK_VEHICLE, "PEDESTRIAN": TRK_PEDESTRIAN, "CYCLIST": TRK_CYCLIST,
}

# map_features line type -> segment type (metadrive/type.py naming)
def _line_seg_type(feature_type):
    t = str(feature_type).upper()
    if "YELLOW" in t:
        return SEG_YELLOW_LINE
    if "SOLID" in t:
        return SEG_WHITE_LINE
    if "ROAD_EDGE" in t or "BOUNDARY" in t:
        return SEG_SIDEWALK
    return None  # broken lines / lane surfaces are not contact geometry


# MetaDriveType.is_lane (metadrive/type.py:109-113)
_LANE_TYPES = {
    "LANE_SURFACE_STREET", "LANE_SURFACE_UNSTRUCTURE", "LANE_UNKNOWN",
    "LANE_BIKE_LANE", "LANE_FREEWAY",
}
LANE_VIS_WIDTH = 6.0        # ScenarioLane.VIS_LANE_WIDTH (scenario_lane.py:23)
LANE_RESAMPLE_M = 6.0       # centerline resample interval (chord sagitta on a
                            # 30 m-radius arc ~0.15 m << half width)
LANE_MAX_PTS = 32

# fixed-spacing track routes: the chord holding an arc position is
# floor(long / spacing), one row gather (see ops/polyline.py uniform_pose)
TRK_SPACING_M = 2.5
# route points are stored as int16 offsets from the route origin at this
# quantum: 0.025 m resolution, +-819 m range (a route is at most
# (256-1)*TRK_SPACING_M = 637.5 m of arc from its origin). Halves the bytes
# of the per-env route gather; 1.25 cm worst-case pose error is far below
# every consumer's tolerance (IDM gaps, OBB contacts, 2 m despawn radius)
UPATH_QUANT = 0.025

# TrajectoryIDM spawn eligibility (scenario_traffic_manager.py:30-32)
IDM_CREATE_SIDE_CONSTRAINT = 15.0
IDM_CREATE_FORWARD_CONSTRAINT = -1.0
IDM_CREATE_MIN_LENGTH = 5.0


def _simplify_polyline(line, tol=0.05):
    """Douglas-Peucker simplification (iterative): drop points whose
    perpendicular deviation from the chord is below ``tol``. Boundary
    segments only — lane centerlines keep their uniform resample."""
    n = len(line)
    if n <= 2:
        return line
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i + 1:
            continue
        a, b = line[i], line[j]
        ab = b - a
        denom = float(np.hypot(ab[0], ab[1]))
        mid = line[i + 1:j]
        if denom < 1e-9:
            d = np.hypot(mid[:, 0] - a[0], mid[:, 1] - a[1])
        else:
            d = np.abs((mid[:, 0] - a[0]) * ab[1]
                       - (mid[:, 1] - a[1]) * ab[0]) / denom
        k = int(np.argmax(d))
        if d[k] > tol:
            keep[i + 1 + k] = True
            stack.append((i, i + 1 + k))
            stack.append((i + 1 + k, j))
    return line[keep]


def _resample(line, step=LANE_RESAMPLE_M, max_pts=LANE_MAX_PTS):
    """Uniform arc-length resample (utils/math.py resample_polyline)."""
    d = np.linalg.norm(np.diff(line, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    total = float(s[-1])
    n = int(np.clip(total // step + 2, 2, max_pts))
    ss = np.linspace(0.0, total, n)
    return np.stack(
        [np.interp(ss, s, line[:, 0]), np.interp(ss, s, line[:, 1])], axis=1
    ).astype(np.float32)


def _resample_split(line, step=LANE_RESAMPLE_M, max_pts=LANE_MAX_PTS):
    """Resample a centerline into one or more <=max_pts chunks.

    A single capped resample of a lane longer than (max_pts-1)*step would
    space points >step apart; on curves the chord sagitta can exceed the
    lane half-width and polyline.in_band would misclassify an on-lane pose
    as off-lane (terminating episodes via out_of_road). Chunks overlap by
    one point so band coverage stays continuous.
    """
    d = np.linalg.norm(np.diff(line, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    total = float(s[-1])
    span = (max_pts - 1) * step
    if total <= span:
        return [_resample(line, step, max_pts)]
    chunks = []
    n_chunks = int(np.ceil(total / span))
    bounds = np.linspace(0.0, total, n_chunks + 1)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        n = int(np.clip((hi - lo) // step + 2, 2, max_pts))
        ss = np.linspace(lo, hi, n)
        chunks.append(
            np.stack(
                [np.interp(ss, s, line[:, 0]), np.interp(ss, s, line[:, 1])],
                axis=1,
            ).astype(np.float32)
        )
    return chunks


def compile_scenario(sd):
    """One ScenarioDescription dict -> flat numpy arrays."""
    T = int(sd[SD.LENGTH])
    sdc_id = str(sd[SD.METADATA][SD.SDC_ID])
    tracks = sd[SD.TRACKS]

    sdc = tracks[sdc_id]
    sdc_state = sdc[SD.STATE]
    sdc_valid = np.asarray(sdc_state[SD.VALID], bool)
    sdc_xy = np.asarray(sdc_state[SD.POSITION], np.float32)[:, :2]
    pts = sdc_xy[sdc_valid]
    if len(pts) < 2:
        pts = np.concatenate([pts, pts + np.array([[0.1, 0.0]])], axis=0) if len(pts) else \
            np.zeros((2, 2), np.float32)
    # drop near-duplicate consecutive points (static frames)
    keep = np.concatenate([[True], np.linalg.norm(np.diff(pts, axis=0), axis=1) > 0.05])
    pts = pts[keep]
    if len(pts) < 2:
        pts = np.concatenate([pts, pts + np.array([[0.1, 0.0]])], axis=0)
    first_valid = int(np.argmax(sdc_valid)) if sdc_valid.any() else 0
    sdc_heading0 = float(np.asarray(sdc_state[SD.HEADING], np.float32)[first_valid])

    sdc_heading_all = np.asarray(sdc_state[SD.HEADING], np.float32)

    trk_pos, trk_heading, trk_valid, trk_len, trk_wid, trk_kind = [], [], [], [], [], []
    trk_first_t, trk_reactive_ok, trk_speed = [], [], []
    for tid, tr in tracks.items():
        if tid == sdc_id:
            continue
        kind = _TYPE_TO_KIND.get(str(tr[SD.TYPE]).upper())
        if kind is None:
            continue
        st = tr[SD.STATE]
        pos = np.asarray(st[SD.POSITION], np.float32)[:T, :2]
        heading = np.asarray(st[SD.HEADING], np.float32)[:T]
        valid = np.asarray(st[SD.VALID], bool)[:T]
        if not valid.any():
            continue
        length = float(np.asarray(st["length"]).reshape(-1)[0]) if "length" in st else 4.5
        width = float(np.asarray(st["width"]).reshape(-1)[0]) if "width" in st else 1.8

        def pad_t(a, fill=0):
            if a.shape[0] >= T:
                return a[:T]
            return np.concatenate([a, np.full((T - a.shape[0],) + a.shape[1:], fill, a.dtype)])

        first_t = int(np.argmax(valid))
        # TrajectoryIDM spawn eligibility, evaluated against the RECORDED sdc
        # pose at the track's first valid step (the reference evaluates
        # against the live ego at spawn time, scenario_traffic_manager.py:
        # 217-235; at spawn the RL ego is at/near the recorded pose)
        vpts = pos[valid]
        route_len = float(np.linalg.norm(vpts[0] - vpts[-1]))
        si = min(first_t, len(sdc_xy) - 1)
        sh = float(sdc_heading_all[si]) if len(sdc_heading_all) else 0.0
        rel = pos[first_t] - sdc_xy[si]
        fwd = rel[0] * math.cos(sh) + rel[1] * math.sin(sh)
        side = -rel[0] * math.sin(sh) + rel[1] * math.cos(sh)
        hdiff = (heading[first_t] - sh + math.pi) % (2 * math.pi) - math.pi
        reactive_ok = (
            kind == TRK_VEHICLE
            and route_len > IDM_CREATE_MIN_LENGTH
            and fwd < IDM_CREATE_FORWARD_CONSTRAINT
            and abs(side) < IDM_CREATE_SIDE_CONSTRAINT
            and abs(hdiff) < math.pi / 2
        )

        # recorded body speed per frame (IDM front-gap reads the true speed
        # of replayed candidates, like the reference's front_obj.speed on a
        # kinematic body); derived from positions when velocity is absent —
        # finite differences over VALID frames only: a gradient across the
        # zero-filled invalid padding invents huge spurious speeds exactly
        # at the frames a track becomes a valid candidate
        if "velocity" in st:
            vel = np.asarray(st["velocity"], np.float32)[:T, :2]
            speed = np.sqrt((vel ** 2).sum(-1))
        else:
            dt_rec = 0.1
            speed = np.zeros(len(pos), np.float32)
            idx = np.flatnonzero(valid)
            if len(idx) >= 2:
                vp = pos[idx]
                d = (np.linalg.norm(np.diff(vp, axis=0), axis=1)
                     / (np.diff(idx) * dt_rec))
                speed[idx[1:]] = d
                speed[idx[0]] = d[0]
        trk_pos.append(pad_t(pos))
        trk_heading.append(pad_t(heading))
        trk_valid.append(pad_t(valid, False))
        trk_len.append(length)
        trk_wid.append(width)
        trk_kind.append(kind)
        trk_first_t.append(first_t)
        trk_reactive_ok.append(reactive_ok)
        trk_speed.append(pad_t(speed.astype(np.float32)))
    TRK = len(trk_pos)

    # reactive-ELIGIBLE tracks first (stable order otherwise): the env keeps
    # TrajectoryIDM state only for the leading KR slots — the reference
    # instantiates IDM policies only for eligible vehicles
    # (scenario_traffic_manager.py:217-235); everything else pure-replays
    order = sorted(range(TRK), key=lambda k: not trk_reactive_ok[k])
    for lst in (trk_pos, trk_heading, trk_valid, trk_len, trk_wid, trk_kind,
                trk_first_t, trk_reactive_ok, trk_speed):
        lst[:] = [lst[k] for k in order]

    # traffic lights (dynamic_map_states; reference:
    # manager/scenario_light_manager.py — stop point + per-step status)
    _STATUS = {"TRAFFIC_LIGHT_GREEN": 1, "TRAFFIC_LIGHT_YELLOW": 2, "TRAFFIC_LIGHT_RED": 3}
    light_pos, light_status = [], []
    for lid_, light in (sd.get(SD.DYNAMIC_MAP_STATES) or {}).items():
        state = light.get("state", {})
        stop = light.get("metadata", {}).get("stop_point", state.get("stop_point"))
        statuses = state.get("object_state", state.get("status", []))
        if stop is None or len(statuses) == 0:
            continue
        codes = np.zeros(T, np.int32)
        for t in range(min(T, len(statuses))):
            codes[t] = _STATUS.get(str(statuses[t]), 0)
        light_pos.append(np.asarray(stop, np.float32)[:2])
        light_status.append(codes)
    LG = len(light_pos)

    seg_p0, seg_p1, seg_type = [], [], []
    lane_pts, lane_width = [], []
    for fid, feat in (sd.get(SD.MAP_FEATURES) or {}).items():
        ftype = str(feat.get("type", "")).upper()
        if ftype in _LANE_TYPES:
            # lane centerline -> resampled PointLane (ScenarioBlock builds a
            # ScenarioLane per lane feature, scenario_block.py:25-31)
            line = np.asarray(feat.get("polyline", []), np.float32)
            if line.ndim == 2 and len(line) >= 2:
                for chunk in _resample_split(line[:, :2]):
                    lane_pts.append(chunk)
                    lane_width.append(float(feat.get("width", LANE_VIS_WIDTH)))
            continue
        styp = _line_seg_type(ftype)
        if styp is None:
            continue
        line = np.asarray(
            feat.get("polyline", feat.get("polygon", [])), np.float32
        )
        if line.ndim != 2 or len(line) < 2:
            continue
        # boundary polylines arrive densely sampled (Waymo edges carry a
        # point every ~0.5-2 m); collapse collinear runs before emitting
        # segments — the ray-vs-segment pass is O(E x rays x B) and B is
        # the side detector's whole cost. 5 cm tolerance sits at the int16
        # quantization floor (core/structs.py), far below obs resolution.
        line = _simplify_polyline(line[:, :2], tol=0.05)
        for a, b in zip(line[:-1], line[1:]):
            seg_p0.append(a)
            seg_p1.append(b)
            seg_type.append(styp)
    B = len(seg_p0)
    LN = len(lane_pts)
    LP = max([len(p) for p in lane_pts], default=2)
    lane_arr = np.zeros((LN, LP, 2), np.float32)
    lane_npts = np.zeros(LN, np.int32)
    for i, p in enumerate(lane_pts):
        lane_arr[i, : len(p)] = p
        lane_arr[i, len(p):] = p[-1]  # pad by repeating the endpoint
        lane_npts[i] = len(p)

    def pad_t_sdc(a, fill=0):
        if a.shape[0] >= T:
            return a[:T]
        return np.concatenate([a, np.full((T - a.shape[0],) + a.shape[1:], fill, a.dtype)])

    return dict(
        sdc_pts=pts.astype(np.float32), sdc_npts=np.int32(len(pts)),
        sdc_track_pos=pad_t_sdc(sdc_xy).astype(np.float32),
        sdc_track_heading=pad_t_sdc(np.asarray(sdc_state[SD.HEADING], np.float32)),
        sdc_track_valid=pad_t_sdc(sdc_valid, False),
        trk_pos=np.asarray(trk_pos, np.float32).reshape(TRK, T, 2),
        trk_heading=np.asarray(trk_heading, np.float32).reshape(TRK, T),
        trk_valid=np.asarray(trk_valid, bool).reshape(TRK, T),
        trk_speed=np.asarray(trk_speed, np.float32).reshape(TRK, T),
        trk_len=np.asarray(trk_len, np.float32), trk_wid=np.asarray(trk_wid, np.float32),
        trk_kind=np.asarray(trk_kind, np.int32),
        trk_first_t=np.asarray(trk_first_t, np.int32).reshape(TRK),
        trk_reactive_ok=np.asarray(trk_reactive_ok, bool).reshape(TRK),
        scenario_len=np.int32(T),
        lane_pts=lane_arr, lane_npts=lane_npts,
        lane_width=np.asarray(lane_width, np.float32).reshape(LN),
        lane_valid=np.ones(LN, bool),
        seg_p0=np.asarray(seg_p0, np.float32).reshape(B, 2),
        seg_p1=np.asarray(seg_p1, np.float32).reshape(B, 2),
        seg_type=np.asarray(seg_type, np.int32),
        seg_halfwidth=np.full(B, 0.075, np.float32),
        seg_valid=np.ones(B, bool),
        light_pos=np.asarray(light_pos, np.float32).reshape(LG, 2),
        light_status=np.asarray(light_status, np.int32).reshape(LG, T),
        light_valid=np.ones(LG, bool),
        sdc_start_pos=pts[0], sdc_start_heading=np.float32(sdc_heading0),
    )


def build_scenario_pack(sds):
    """Compile + stack with padding -> dict [S, ...]."""
    scenes = [compile_scenario(sd) for sd in sds]
    keys = scenes[0].keys()
    max_shape = {}
    for k in keys:
        arrs = [np.asarray(sc[k]) for sc in scenes]
        if arrs[0].ndim > 0:
            max_shape[k] = tuple(
                max(max(a.shape[d] for a in arrs), 1) for d in range(arrs[0].ndim)
            )
    pack = {}
    for k in keys:
        arrs = [np.asarray(sc[k]) for sc in scenes]
        if arrs[0].ndim == 0:
            pack[k] = np.stack(arrs)
        else:
            pack[k] = np.stack([_pad_to_shape(a, max_shape[k]) for a in arrs])

    # static arc-length tables — computed once here so the jit'd step never
    # re-runs the cumsum over T/PT (polyline.* accept them via s=)
    def np_arc(pts, npts):
        d = np.sqrt(((pts[..., 1:, :] - pts[..., :-1, :]) ** 2).sum(-1))
        idx = np.arange(pts.shape[-2] - 1)
        valid = idx < (npts[..., None] - 1)
        d = np.where(valid, d, 0.0)
        return np.concatenate(
            [np.zeros_like(d[..., :1]), np.cumsum(d, axis=-1)], axis=-1
        ).astype(np.float32)

    trk_npts = pack["trk_valid"].sum(-1).astype(np.int32)
    pack["trk_npts"] = trk_npts
    pack["trk_arclen"] = np_arc(pack["trk_pos"], trk_npts)
    pack["sdc_arclen"] = np_arc(pack["sdc_pts"], pack["sdc_npts"])
    pack["lane_arclen"] = np_arc(pack["lane_pts"], pack["lane_npts"])

    # time-major flat copies: pose-at-t = one ROW gather a[sidx*T + t]
    S, TRK, T, _ = pack["trk_pos"].shape
    pack["trk_pos_t"] = np.ascontiguousarray(
        np.moveaxis(pack["trk_pos"], 2, 1)).reshape(S * T, TRK, 2)
    pack["trk_heading_t"] = np.ascontiguousarray(
        np.moveaxis(pack["trk_heading"], 2, 1)).reshape(S * T, TRK)
    pack["trk_valid_t"] = np.ascontiguousarray(
        np.moveaxis(pack["trk_valid"], 2, 1)).reshape(S * T, TRK)
    LG, LT = pack["light_status"].shape[1:3]
    assert LT == T, f"light horizon {LT} != track horizon {T}"
    pack["light_status_t"] = np.ascontiguousarray(
        np.moveaxis(pack["light_status"], 2, 1)).reshape(S * T, LG)
    pack["trk_speed_t"] = np.ascontiguousarray(
        np.moveaxis(pack["trk_speed"], 2, 1)).reshape(S * T, TRK)
    del pack["trk_speed"]
    pack["sdc_pos_t"] = pack["sdc_track_pos"].reshape(S * T, 2)
    pack["sdc_heading_t"] = pack["sdc_track_heading"].reshape(S * T)

    # compact reactive axis: TrajectoryIDM state exists only for the KR
    # ELIGIBLE slots (sorted first in compile_scenario) — the reference
    # instantiates IDM policies per eligible vehicle only; everything else
    # replays. KR rounds up to the act-batch size so the fresh batch is one
    # dynamic slice [S, KR/5, ...]
    n_elig = int(pack["trk_reactive_ok"].sum(axis=1).max(initial=0))
    KR = ((max(n_elig, 1) + IDM_ACT_BATCH_SIZE - 1)
          // IDM_ACT_BATCH_SIZE) * IDM_ACT_BATCH_SIZE
    KRT = min(KR, TRK)  # overlay width onto the full track axis

    # fixed-spacing resampled routes for the KR reactive slots: with uniform
    # chords, arc->point lookup is floor(long/spacing) — one row index
    # serves position, heading, and every +k*spacing probe
    utotal = np.zeros((S, KR), np.float32)
    utotal[:, :KRT] = pack["trk_arclen"][:, :KRT].max(axis=-1)
    P5 = int(np.clip(np.ceil(utotal.max(initial=0.0) / TRK_SPACING_M) + 2, 4, 256))
    upath = np.zeros((S, KR, P5, 2), np.float32)
    unpts = np.zeros((S, KR), np.int32)
    for s in range(S):
        for k in range(KRT):
            n = int(trk_npts[s, k])
            if n < 2:
                upath[s, k] = pack["trk_pos"][s, k, 0]
                unpts[s, k] = 1
                continue
            arc = pack["trk_arclen"][s, k, :n]
            pts = pack["trk_pos"][s, k, :n]
            m = min(int(arc[-1] // TRK_SPACING_M) + 2, P5)
            ss = np.arange(m) * TRK_SPACING_M
            ss = np.minimum(ss, arc[-1])
            upath[s, k, :m, 0] = np.interp(ss, arc, pts[:, 0])
            upath[s, k, :m, 1] = np.interp(ss, arc, pts[:, 1])
            upath[s, k, m:] = upath[s, k, m - 1]
            unpts[s, k] = m
    origin = upath[:, :, :1, :].copy()                       # [S,KR,1,2]
    q = np.round((upath - origin) / UPATH_QUANT)
    assert np.abs(q).max(initial=0) < 32767, "route offset exceeds int16 range"
    pack["trk_uorigin"] = origin[:, :, 0, :]                 # [S,KR,2]
    pack["trk_upath_q"] = q.astype(np.int16)                 # [S,KR,P5,2]
    pack["trk_unpts"] = unpts
    pack["trk_utotal"] = utotal.astype(np.float32)
    # KR-sized eligibility/spawn tables for the reactive path (zero-padded
    # past the real track axis when TRK < KR)
    def _kr(a, fill=0):
        out = np.full((S, KR), fill, a.dtype)
        out[:, :KRT] = a[:, :KRT]
        return out
    pack["trk_reactive_ok"] = _kr(pack["trk_reactive_ok"], False)
    pack["trk_first_t"] = _kr(pack["trk_first_t"])
    # recorded speed at the spawn frame: reactive cars start at their
    # recorded velocity like the reference's log-spawned IDM vehicles
    spawn_speed = np.take_along_axis(
        pack["trk_speed_t"].reshape(S, T, TRK)[:, :, :KRT],
        np.minimum(pack["trk_first_t"][:, :KRT], T - 1)[:, None, :], axis=1
    )[:, 0, :]
    out = np.zeros((S, KR), np.float32)
    out[:, :KRT] = spawn_speed
    pack["trk_spawn_speed"] = out
    return pack
