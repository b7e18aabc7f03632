"""Synthetic Waymo-scale ScenarioDescriptions, made from a seed.

Data for driving the scenario path at the size of real Waymo scenarios
(about 200 frames, 64 tracks, 80 lanes of 220 points) when no dataset is
at hand: the chip smoke test and the tests replay them. Pure numpy.
"""
import numpy as np


def synthetic_waymo_sd(seed, T=198, n_tracks=64, n_lanes=80, lane_pts=220,
                        n_lights=8):
    """One ScenarioDescription with Waymo-like shapes AND structure.

    Shapes (track count, episode length, lane polyline length) follow
    scenarionet Waymo stats: ~200 frames at 10 Hz, tens of tracks, long
    multi-point lanes. The map is geometrically honest:

    - four distinct lane GROUPS (main corridor, opposing carriageway, a
      far parallel street, an off-ramp branch + connectors), each with its
      own per-seed curvature profile (two superposed sines, random
      amplitude/period/phase) — all 80 polylines are distinct geometry;
    - every column is split into consecutive lane PIECES with per-seed
      jittered, heterogeneous lengths, chained by entry_lanes/exit_lanes
      (scenario_description.py:138-145 lane topology keys);
    - a branching connection: the ramp peels off main column 7 mid-route
      (its first piece's entry_lanes point INTO the corridor, and that
      corridor piece has two exit lanes).

    Carries cycling traffic lights in dynamic_map_states (schema:
    scenario/scenario_description.py:124 + manager/scenario_light_manager
    .py consumes stop_point + per-frame object_state) and a ~20%
    pedestrian/cyclist track share, so a replay exercises light replay
    and participant-type handling at scale."""
    rng = np.random.RandomState(seed)
    dt = 0.1
    lane_w = 3.8
    n_cols = 8                      # parallel lanes per carriageway
    length_m = (lane_pts - 1) * 1.5

    # per-seed curvature profile of each group: two superposed sines
    def curve_profile():
        a1 = rng.uniform(1.0, 3.5)
        p1 = rng.uniform(45.0, 85.0)
        a2 = rng.uniform(0.3, 1.2)
        p2 = rng.uniform(16.0, 30.0)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        return lambda x: (a1 * np.sin(x / p1 + ph1)
                          + a2 * np.sin(x / p2 + ph2))

    main_curve = curve_profile()
    opp_curve = curve_profile()
    far_curve = curve_profile()

    def main_y(col, x):
        return col * lane_w + main_curve(x)

    map_features = {}

    def add_group(name, n_cols_g, n_pieces, y_of, x0=0.0, x1=length_m,
                  reverse=False):
        """One carriageway: n_cols_g parallel columns, each split into
        n_pieces consecutive lane pieces at per-seed jittered boundaries.
        Returns the [col][piece] -> feature-id table."""
        cuts = np.linspace(0.0, 1.0, n_pieces + 1)
        ids = []
        for c in range(n_cols_g):
            jit = rng.uniform(-0.06, 0.06, n_pieces + 1)
            jit[0] = jit[-1] = 0.0
            frac = np.clip(cuts + jit, 0.0, 1.0)
            col_ids = []
            for k in range(n_pieces):
                xa = x0 + frac[k] * (x1 - x0)
                xb = x0 + frac[k + 1] * (x1 - x0)
                npts = max(2, int(round((xb - xa) / 1.5)) + 1)
                xs = np.linspace(xa, xb, npts)
                pts = np.stack([xs, y_of(c, xs)], axis=1)
                if reverse:
                    pts = pts[::-1]
                fid = f"{name}_{c}_{k}"
                map_features[fid] = dict(
                    type="LANE_SURFACE_STREET",
                    polyline=pts.astype(np.float32), width=lane_w,
                    entry_lanes=[], exit_lanes=[],
                )
                col_ids.append(fid)
            if reverse:
                col_ids = col_ids[::-1]
            for a, b in zip(col_ids[:-1], col_ids[1:]):
                map_features[a]["exit_lanes"].append(b)
                map_features[b]["entry_lanes"].append(a)
            ids.append(col_ids)
        return ids

    # main corridor: 8 cols x 4 pieces = 32 lanes
    main_ids = add_group("main", n_cols, 4, main_y)
    # opposing carriageway (reversed travel direction): 8 x 3 = 24 lanes
    opp_off = -2.5 * lane_w
    opp_ids = add_group(
        "opp", n_cols, 3,
        lambda c, x: opp_off - c * lane_w + opp_curve(x), reverse=True)
    # far parallel street: 8 x 2 = 16 lanes
    far_off = (n_cols + 4.5) * lane_w + 10.0
    far_ids = add_group("far", n_cols, 2,
                        lambda c, x: far_off + c * lane_w + far_curve(x))
    # off-ramp branch: 2 lanes x 2 pieces = 4, peeling off main col 7
    # between x_b and length_m with a smoothstep lateral ease to the far
    # street's offset minus a shoulder
    x_b = length_m * rng.uniform(0.45, 0.6)
    ramp_rise = far_off - 6.0 - main_y(n_cols - 1, x_b).item()

    def ramp_y(c, x):
        t = np.clip((x - x_b) / (length_m - x_b), 0.0, 1.0)
        ease = t * t * (3.0 - 2.0 * t)
        return (main_y(n_cols - 1 + c, x) + ease * ramp_rise)

    ramp_ids = add_group("ramp", 2, 2, ramp_y, x0=x_b, x1=length_m)
    # branching connection: ramp lane 0 enters FROM the main corridor
    # piece that spans x_b (two exit lanes from one corridor piece)
    donor = main_ids[n_cols - 1][min(2, len(main_ids[n_cols - 1]) - 1)]
    map_features[donor]["exit_lanes"].append(ramp_ids[0][0])
    map_features[ramp_ids[0][0]]["entry_lanes"].append(donor)
    # 4 short connectors chain the ramp end onto the far street entries
    for ci in range(4):
        a = np.asarray(map_features[ramp_ids[ci % 2][-1]]["polyline"])[-1]
        target = far_ids[ci][0]
        b = np.asarray(map_features[target]["polyline"])[0]
        npts = max(2, int(round(np.linalg.norm(b - a) / 1.5)) + 1)
        pts = np.linspace(a, b, npts)
        fid = f"conn_{ci}"
        map_features[fid] = dict(
            type="LANE_SURFACE_STREET", polyline=pts.astype(np.float32),
            width=lane_w,
            entry_lanes=[ramp_ids[ci % 2][-1]], exit_lanes=[target],
        )
        map_features[ramp_ids[ci % 2][-1]]["exit_lanes"].append(fid)
        map_features[target]["entry_lanes"].append(fid)
    assert sum(1 for f in map_features.values()
               if f["type"] == "LANE_SURFACE_STREET") == n_lanes

    # road edges hug the outer columns of the two carriageways
    for fid, col_y in (("edge_main_r", lambda x: main_y(-0.5, x)),
                       ("edge_main_l", lambda x: main_y(n_cols - 0.5, x)),
                       ("edge_opp_l", lambda x: opp_off
                        - (n_cols - 0.5) * lane_w + opp_curve(x))):
        xs = np.linspace(0.0, length_m, lane_pts)
        edge = np.stack([xs, col_y(xs)], axis=1)
        map_features[fid] = dict(
            type="ROAD_EDGE_BOUNDARY", polyline=edge.astype(np.float32)
        )

    # cycling traffic lights at stop points spaced along the corridor; each
    # cycles green(15 s) -> yellow(2 s) -> red(8 s), phase-offset per light
    dynamic_map_states = {}
    for li in range(n_lights):
        col = li % n_cols
        x = 20.0 + (li * 31.0) % (length_m * 0.8)
        stop = [float(x), float(main_y(col, np.float64(x))), 0.0]
        g, y, r = 150, 20, 80  # frames at 10 Hz
        cyc = (["TRAFFIC_LIGHT_GREEN"] * g + ["TRAFFIC_LIGHT_YELLOW"] * y
               + ["TRAFFIC_LIGHT_RED"] * r)
        off = (li * 83) % len(cyc)
        states = [cyc[(t + off) % len(cyc)] for t in range(T)]
        dynamic_map_states[f"light_{li}"] = dict(
            type="TRAFFIC_LIGHT",
            state=dict(object_state=states),
            metadata=dict(stop_point=stop, track_length=T,
                          object_id=f"light_{li}"),
        )

    def track(col, x0, speed, kind="VEHICLE"):
        xs = x0 + speed * dt * np.arange(T)
        ys = main_y(col, xs)
        pos = np.stack([xs, ys, np.zeros(T)], axis=1).astype(np.float32)
        heading = np.arctan2(np.gradient(ys), np.gradient(xs)).astype(np.float32)
        vel = np.stack([np.gradient(xs) / dt, np.gradient(ys) / dt], axis=1)
        return dict(
            type=kind,
            state=dict(
                position=pos, heading=heading, velocity=vel.astype(np.float32),
                valid=np.ones(T, bool),
                length=np.full(T, 4.8, np.float32),
                width=np.full(T, 2.0, np.float32),
                height=np.full(T, 1.6, np.float32),
            ),
            metadata=dict(track_length=T, type=kind, object_id="x"),
        )

    tracks = {"sdc": track(3, 5.0, 11.0)}
    for k in range(n_tracks):
        col = int(rng.randint(0, n_cols))
        # ~20% pedestrians/cyclists (10% each), the high end of real Waymo
        # packs' participant share; they move at walking/riding speeds.
        # Only slots outside the spawn-behind (IDM-qualifying) quarter, so
        # the reactive-car count per scene stays ~16.
        if k % 5 == 2 and k % 4 != 1:
            kind = "PEDESTRIAN" if k % 10 == 2 else "CYCLIST"
            speed = float(rng.uniform(0.5, 2.0) if kind == "PEDESTRIAN"
                          else rng.uniform(2.0, 6.0))
            x0 = float(rng.uniform(0.0, length_m * 0.6))
        elif k % 4 == 1:
            # a realistic share spawns BEHIND the sdc: these qualify for
            # TrajectoryIDM (spawn fwd < -1 m, |side| < 15 m, aligned —
            # scenario_traffic_manager.py:217-235), so a replay actually
            # exercises the reactive path at scale (~16 IDM cars/scene)
            kind = "VEHICLE"
            col = int(rng.randint(0, 7))
            x0 = float(rng.uniform(-45.0, 0.0))
            speed = float(rng.uniform(4.0, 14.0))
        else:
            kind = "VEHICLE"
            x0 = float(rng.uniform(0.0, length_m * 0.6))
            speed = float(rng.uniform(4.0, 14.0))
        tracks[f"o{k}"] = track(col, x0, speed, kind)

    return {
        "id": f"synthetic_waymo_{seed}",
        "version": "MetaDrive v0.4.1.1",
        "length": T,
        "tracks": tracks,
        "dynamic_map_states": dynamic_map_states,
        "map_features": map_features,
        "metadata": dict(
            sdc_id="sdc", dataset="synthetic-waymo-scale", coordinate="metadrive",
            ts=(np.arange(T) * dt).astype(np.float32), seed=seed,
        ),
    }
