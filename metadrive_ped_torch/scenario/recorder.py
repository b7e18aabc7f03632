"""Episode export: rollout trajectories -> ScenarioDescription dicts.

The batched counterpart of BaseEnv.export_scenarios (envs/base_env.py:775-836 +
scenario/utils.py:95-323 convert_recorded_scenario_exported): the rollout's
collected per-step state arrays become per-object track arrays at 10 Hz
(one env step = 0.1 s simulated, so no resampling is needed).
"""
import numpy as np

from metadrive_ped_torch.constants import (
    SEG_BROKEN_LINE, SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE,
)
from metadrive_ped_torch.obs.top_down import _lane_centerline
from metadrive_ped_torch.scenario.description import MetaDriveType, ScenarioDescription as SD

_SEG_TYPE_NAME = {
    SEG_YELLOW_LINE: MetaDriveType.LINE_SOLID_SINGLE_YELLOW,
    SEG_WHITE_LINE: MetaDriveType.LINE_SOLID_SINGLE_WHITE,
    SEG_BROKEN_LINE: MetaDriveType.LINE_BROKEN_SINGLE_WHITE,
    SEG_SIDEWALK: MetaDriveType.BOUNDARY_SIDEWALK,
}


def _map_features(pack, s):
    """Scene arrays -> SD map_features (the reference exports lane
    centerlines + boundary lines from the map, scenario/utils.py:95-323 via
    BaseMap.get_map_features). Lane polylines come from the compiled closed
    forms; boundary segments chain back into per-line polylines."""
    feats = {}
    succ = pack.get("lane_succ")
    left = pack.get("lane_left")
    right = pack.get("lane_right")
    valid_ids = [
        lid for lid in range(pack["lane_kind"].shape[1])
        if "lane_valid" not in pack or pack["lane_valid"][s][lid]
    ]
    # entry lanes = inverse of the successor map (SD connectivity keys,
    # scenario_description.py:142-145; real Waymo packs carry these and
    # EdgeRoadNetwork routes over them — exported SDs must too, matching
    # the reference's export connectivity test,
    # tests/test_export_record_scenario/test_connectivity.py)
    entries = {lid: [] for lid in valid_ids}
    if succ is not None:
        for lid in valid_ids:
            nxt = int(succ[s][lid])
            if nxt >= 0 and nxt in entries:
                entries[nxt].append(f"lane_{lid}")
    for lid in valid_ids:
        poly = _lane_centerline(pack, s, lid)
        feat = {
            "type": MetaDriveType.LANE_SURFACE_STREET,
            "polyline": poly,
            "width": float(pack["lane_width"][s][lid]),
            "speed_limit_mps": float(pack["lane_speed_limit"][s][lid])
            if "lane_speed_limit" in pack else None,
            "entry_lanes": entries[lid],
            "exit_lanes": (
                [f"lane_{int(succ[s][lid])}"]
                if succ is not None and int(succ[s][lid]) >= 0 else []
            ),
            "left_neighbor": (
                [{"id": f"lane_{int(left[s][lid])}"}]
                if left is not None and int(left[s][lid]) >= 0 else []
            ),
            "right_neighbor": (
                [{"id": f"lane_{int(right[s][lid])}"}]
                if right is not None and int(right[s][lid]) >= 0 else []
            ),
        }
        feats[f"lane_{lid}"] = feat
    # chain consecutive boundary segments (p1[i] == p0[i+1], same type)
    p0 = np.asarray(pack["seg_p0"][s])
    p1 = np.asarray(pack["seg_p1"][s])
    styp = np.asarray(pack["seg_type"][s])
    valid = np.asarray(pack["seg_valid"][s]) if "seg_valid" in pack \
        else np.ones(len(p0), bool)
    run, run_t, k = [], None, 0
    def flush():
        nonlocal run, k
        if len(run) >= 2:
            feats[f"line_{k}"] = {
                "type": _SEG_TYPE_NAME.get(int(run_t), MetaDriveType.BOUNDARY_LINE),
                "polyline": np.asarray(run, np.float32),
            }
            k += 1
        run = []
    for i in range(len(p0)):
        if not valid[i]:
            flush()
            continue
        if run and (styp[i] != run_t or not np.allclose(run[-1], p0[i], atol=1e-3)):
            flush()
        if not run:
            run = [p0[i]]
            run_t = styp[i]
        run.append(p1[i])
    flush()
    return feats


def export_scenarios(env, n_steps, policy_fn=None, actions=None, seeds=None):
    """Roll out and convert each env's trajectory into an SD dict.

    Returns {env_index: ScenarioDescription}. Mirrors the reference's
    env.export_scenarios rollout-then-convert flow.
    """
    if seeds is not None:
        env.reset(seed=seeds)
    sidx0 = env._state.sidx.cpu().numpy() if env._state is not None else None
    outs, _ = env.rollout(
        n_steps, policy_fn=policy_fn, actions=actions,
        collect=("ego_pos", "ego_heading", "ego_speed",
                 "npc_pos", "npc_heading", "npc_speed", "npc_active", "terminated"),
    )
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    T = n_steps
    E = outs["ego_pos"].shape[1]
    scenarios = {}
    for e in range(E):
        # truncate at the first termination (auto-reset would stitch episodes)
        term = outs["terminated"][:, e]
        t_end = int(np.argmax(term)) + 1 if term.any() else T

        def track(obj_id, typ, pos2, heading, vel, valid, length, width, height):
            # zero out invalid frames so valid_check-style masking holds
            # (the reference nulls invalid state rows the same way)
            v = np.asarray(valid, bool)[:, None]
            return {
                SD.TYPE: typ,
                SD.STATE: {
                    SD.POSITION: np.concatenate(
                        [pos2 * v, np.zeros((T, 1), np.float32)], axis=-1
                    ).astype(np.float32),
                    SD.HEADING: (heading * v[:, 0]).astype(np.float32),
                    SD.VELOCITY: (vel * v).astype(np.float32),
                    SD.VALID: np.asarray(valid, bool),
                    "length": (np.full((T,), length) * v[:, 0]).astype(np.float32),
                    "width": (np.full((T,), width) * v[:, 0]).astype(np.float32),
                    "height": (np.full((T,), height) * v[:, 0]).astype(np.float32),
                },
                SD.METADATA: {
                    "track_length": T, SD.OBJECT_ID: obj_id, SD.TYPE: typ,
                    "dataset": "metadrive_ped_torch",
                },
            }

        valid_t = np.arange(T) < t_end
        ego_heading = outs["ego_heading"][:, e]
        ego_vel = (
            outs["ego_speed"][:, e, None]
            * np.stack([np.cos(ego_heading), np.sin(ego_heading)], axis=-1)
        )
        tracks = {
            "sdc": track(
                "sdc", MetaDriveType.VEHICLE, outs["ego_pos"][:, e], ego_heading,
                ego_vel, valid_t, 4.515, 1.852, 1.19
            )
        }
        npc_active = outs["npc_active"][:, e]  # [T,N]
        for n in range(npc_active.shape[1]):
            if not npc_active[:, n].any():
                continue
            h = outs["npc_heading"][:, e, n]
            v = outs["npc_speed"][:, e, n, None] * np.stack([np.cos(h), np.sin(h)], axis=-1)
            tracks[f"npc_{n}"] = track(
                f"npc_{n}", MetaDriveType.VEHICLE, outs["npc_pos"][:, e, n], h, v,
                npc_active[:, n] & valid_t, 4.515, 1.852, 1.19
            )

        sd = SD(
            {
                SD.TRACKS: tracks,
                SD.VERSION: "metadrive_ped_torch",
                SD.ID: f"env{e}",
                SD.DYNAMIC_MAP_STATES: {},
                SD.MAP_FEATURES: _map_features(env._pack, int(sidx0[e]))
                if sidx0 is not None and getattr(env, "_pack", None) is not None
                else {},
                SD.LENGTH: T,
                SD.METADATA: {
                    SD.METADRIVE_PROCESSED: True,
                    SD.COORDINATE: SD.COORDINATE_METADRIVE,
                    SD.TIMESTEP: np.arange(T, dtype=np.float32) * 0.1,
                    SD.SDC_ID: "sdc",
                    "scenario_id": f"env{e}",
                    "seed": int(sidx0[e]) if sidx0 is not None else 0,
                },
            }
        )
        scenarios[e] = sd
    return scenarios
