"""Scene compiler: road network -> fixed-size `SceneSpec` arrays.

This is the bridge between host-side procedural generation (mapgen/big.py)
and the batched device step. Each scenario seed compiles once into flat numpy
arrays (mirroring the reference's per-seed map cache,
metadrive/manager/pg_map_manager.py:52-66); `build_scene_pack` stacks many
scenarios along a leading axis with padding so envs can index their scenario
on the device.

Array schema (single scene):
  lanes   : closed-form geometry (straight / circular), road membership,
            successor/left/right adjacency
  roads   : contiguous lane ranges [lane0, lane0+nlanes), successor road
  route   : ego checkpoint roads (reference: NodeNetworkNavigation.set_route,
            node_network_navigation.py:93-128)
  segs    : boundary segments — yellow center line, white side line,
            sidewalk (reference builds these as Bullet ghost/static bodies,
            component/block/base_block.py + pg_block.py:259-333)
  npcs    : traffic spawn slots (reference: PGTrafficManager trigger mode,
            manager/traffic_manager.py:231-277)
"""
import math

import numpy as np

from benchmarks.reference.constants import (
    LANE_CIRCULAR, LINE_BROKEN, LINE_COLOR_YELLOW, LINE_CONTINUOUS,
    LINE_GUARDRAIL, LINE_SIDE,
    SEG_BROKEN_LINE, SEG_SIDEWALK, SEG_WHITE_LINE, SEG_YELLOW_LINE,
)
from benchmarks.reference.mapgen.big import generate_map
from benchmarks.reference.mapgen.network import Road

VEHICLE_GAP = 10.0  # reference: traffic_manager.py:32 VEHICLE_GAP

# static object kinds + footprints (reference: traffic_object.py:43-160)
OBJ_CONE = 0      # cylinder r=0.2
OBJ_WARNING = 1   # cylinder r=0.5
OBJ_BARRIER = 2   # box 2.0 x 0.3, long side across the lane
OBJ_BUILDING = 3  # toll booth air wall (tollgate_building.py:7-26) -> crash_building
OBJ_DIMS = {OBJ_CONE: (0.4, 0.4), OBJ_WARNING: (1.0, 1.0), OBJ_BARRIER: (0.3, 2.0)}

# participant kinds (reference: pedestrian.py:12-118, cyclist.py:13-47)
PED_WALKER = 0    # cylinder r=0.35, speeds {0.4, 1.2} m/s
PED_CYCLIST = 1   # box 1.75 x 0.4
PED_DIMS = {PED_WALKER: (0.7, 0.7), PED_CYCLIST: (1.75, 0.4)}
PED_SPEEDS = [0.4, 1.2]  # pedestrian.py:22 SPEED_LIST

# accident scene constants (reference: object_manager.py:15-27)
ALERT_DIST = 10.0
ACCIDENT_AREA_LEN = 10.0
CONE_LONGITUDE = 2.0
CONE_LATERAL = 1.0
PROHIBIT_SCENE_PROB = 0.67
SIDEWALK_LINE_DIST = 0.6  # reference: constants.py:320
SIDEWALK_HALF_WIDTH = 1.0  # sidewalk is 2 m wide (constants.py:319)
LINE_CONTACT_HALF_WIDTH = 0.075  # lane line width 0.15 (constants.py:314)
ARC_CHORD_LEN = 4.0  # legacy fixed chord (callers may still pass max_chord)
ARC_SAG_TOL = 0.1    # max chord-to-arc deviation, metres

# Traffic vehicle class sampling weights over (s, m, l, xl, default)
# (reference: vehicle_type.py random_vehicle_type + traffic_manager.py:300).
NPC_CLASS_PROBS = np.array([0.2, 0.3, 0.3, 0.2, 0.0])


def _lane_polyline(lane, lateral, max_chord=None):
    """Sample a lateral-offset line of `lane` as a polyline.

    Arc chords are sized by SAG, not a fixed length: chord L on radius R
    deviates from the arc by L^2/(8R), so L = sqrt(8*R*tol) keeps every
    boundary within ARC_SAG_TOL of the true arc — tighter than the old
    fixed 4 m chords on small radii (20 cm sag at R=10) AND emitting
    fewer segments on gentle arcs (the per-step contact pass is O(E x B),
    see the round-5 scenario profile)."""
    if lane.kind == LANE_CIRCULAR:
        if max_chord is None:
            radius = max(abs(getattr(lane, "radius", 10.0) + lateral), 1.0)
            max_chord = max(1.0, math.sqrt(8.0 * radius * ARC_SAG_TOL))
        n = max(2, int(math.ceil(lane.length / max_chord)) + 1)
    else:
        n = 2
    longs = np.linspace(0.0, lane.length, n)
    return np.stack([lane.position(s, lateral) for s in longs])


def _polyline_segments(points):
    return points[:-1], points[1:]


def compile_scene(seed, config):
    """Compile one scenario seed into a dict of flat numpy arrays."""
    map_config = config.get("map_config", {})
    if config.get("random_lane_width") or config.get("random_lane_num"):
        # PGMapManager.add_random_to_map (pg_map_manager.py:66-74): per-seed
        # lane width in [MIN_LANE_WIDTH, MAX_LANE_WIDTH]=[3.0, 4.5], lane
        # count in [MIN_LANE_NUM, MAX_LANE_NUM]=[2, 3] (base_map.py:38-41).
        # Stream-exact: engine.seed re-seeds every manager with the episode
        # seed on reset (base_engine.py:546-553), so the manager's rand()/
        # randint() here are the first draws of get_np_random(seed) — which
        # is precisely ref_rng(seed).
        from benchmarks.reference.mapgen.ref_random import ref_rng
        rng = ref_rng(seed)
        map_config = dict(map_config)
        if config.get("random_lane_width"):
            map_config["lane_width"] = float(rng.rand() * (4.5 - 3.0) + 3.0)
        if config.get("random_lane_num"):
            map_config["lane_num"] = int(rng.randint(2, 4))
    network, blocks = generate_map(seed, map_config)

    # ---- enumerate lanes/roads (contiguous lane ids per road) ------------
    lane_list = []
    road_list = []  # (road, lane0, nlanes)
    road_key_to_id = {}
    for start in network.graph:
        for end in network.graph[start]:
            lanes = network.graph[start][end]
            rid = len(road_list)
            road_key_to_id[(start, end)] = rid
            road_list.append((Road(start, end), len(lane_list), len(lanes)))
            lane_list.extend(lanes)

    L, R = len(lane_list), len(road_list)
    lane_kind = np.zeros(L, np.int32)
    lane_p0 = np.zeros((L, 2), np.float32)
    lane_dir = np.zeros((L, 2), np.float32)
    lane_radius = np.ones(L, np.float32)
    lane_start_phase = np.zeros(L, np.float32)
    lane_arc_dir = np.ones(L, np.float32)
    lane_width = np.zeros(L, np.float32)
    lane_length = np.zeros(L, np.float32)
    lane_angle = np.zeros(L, np.float32)  # signed arc angle, 0 for straight
    lane_road = np.zeros(L, np.int32)
    lane_idx_in_road = np.zeros(L, np.int32)
    lane_speed_limit = np.full(L, 1000.0, np.float32)  # m/s; HostLane default
    lane_block = np.zeros(L, np.int32)  # ord of the owning block's ID char

    def _road_block_char(road):
        """Block ID char of a road (reference: road_network/road.py:42-47)."""
        node = road.start_node if road.is_negative_road() else road.end_node
        if ">" in node:
            return ">"
        for ch in node:
            if ch.isalpha() or ch == "$":
                return ch
        return "?"

    for rid, (road, lane0, nlanes) in enumerate(road_list):
        block_code = ord(_road_block_char(road))
        for i in range(nlanes):
            lid = lane0 + i
            lane = lane_list[lid]
            lane_road[lid] = rid
            lane_idx_in_road[lid] = i
            lane_width[lid] = lane.width
            lane_length[lid] = lane.length
            lane_speed_limit[lid] = lane.speed_limit
            lane_block[lid] = block_code
            if lane.kind == LANE_CIRCULAR:
                lane_kind[lid] = LANE_CIRCULAR
                lane_p0[lid] = lane.center
                lane_radius[lid] = lane.radius
                lane_start_phase[lid] = lane.start_phase
                lane_arc_dir[lid] = lane.direction  # +1 ccw, -1 cw
                lane_angle[lid] = lane.angle
            else:
                lane_p0[lid] = lane.start
                lane_dir[lid] = lane.direction

    # ---- road adjacency ---------------------------------------------------
    road_lane0 = np.array([r[1] for r in road_list], np.int32) if R else np.zeros(0, np.int32)
    road_nlanes = np.array([r[2] for r in road_list], np.int32) if R else np.zeros(0, np.int32)
    road_negative = np.array(
        [r[0].is_negative_road() for r in road_list], bool
    ) if R else np.zeros(0, bool)
    road_succ = np.full(R, -1, np.int32)
    for rid, (road, _, _) in enumerate(road_list):
        nxts = network.graph.get(road.end_node, {})
        for end2 in nxts:
            road_succ[rid] = road_key_to_id[(road.end_node, end2)]
            break

    # lane successors are chosen GEOMETRICALLY: among lanes of every road
    # leaving this road's end node, take the one whose start point is nearest
    # to this lane's end (handles ramp merge lanes and intersection
    # connectors where index-matching is wrong). Fallback: index clamp.
    node_out_roads = {}
    for rid2, (road2, _, _) in enumerate(road_list):
        node_out_roads.setdefault(road2.start_node, []).append(rid2)
    lane_succ = np.full(L, -1, np.int32)
    lane_left = np.full(L, -1, np.int32)
    lane_right = np.full(L, -1, np.int32)
    for lid in range(L):
        rid = lane_road[lid]
        i = lane_idx_in_road[lid]
        if i > 0:
            lane_left[lid] = lid - 1
        if i < road_nlanes[rid] - 1:
            lane_right[lid] = lid + 1
        end_node = road_list[rid][0].end_node
        best, best_d = -1, 0.75  # must join within 0.75 m
        lane_end = lane_list[lid].end
        for srid in node_out_roads.get(end_node, []):
            for j in range(road_nlanes[srid]):
                cand = road_lane0[srid] + j
                d = float(np.hypot(*(lane_list[cand].start - lane_end)))
                if d < best_d:
                    best, best_d = cand, d
        if best < 0:
            srid = road_succ[rid]
            if srid >= 0:
                best = road_lane0[srid] + min(i, road_nlanes[srid] - 1)
        lane_succ[lid] = best

    # ---- spawn slots + per-slot routes ------------------------------------
    # Single-agent: one slot on the FirstPGBlock entrance lane 0 at long 5
    # (base_env.py:146 spawn_longitude) routed to a random last-block socket
    # (auto_assign_task, node_network_navigation.py:70-91). Multi-agent:
    # slots tile every spawn road's lanes at RESPAWN_REGION_LONGITUDE=8 m
    # intervals (spawn_manager.py:27-29,108-120), each routed to a random
    # OTHER arm's exit.
    rs_dest = np.random.RandomState(seed)
    spawn_roads_cfg = config.get("spawn_roads")  # list of (start,end) or None
    dest_nodes_default = config.get("spawn_dest_nodes")
    # OpenDrive maps carry their own spawn/destination defaults (the block
    # shim from mapgen/opendrive.py)
    if spawn_roads_cfg is None and hasattr(blocks[-1], "xodr_spawn"):
        spawn_roads_cfg = blocks[-1].xodr_spawn
        if dest_nodes_default is None:
            dest_nodes_default = blocks[-1].xodr_dests
    RESPAWN_REGION_LONGITUDE = 8.0

    def route_from(start_node, dest_node):
        checkpoints = network.shortest_path((start_node, None, 0), dest_node)
        if len(checkpoints) < 2:
            return None
        return [road_key_to_id[(a, b)] for a, b in zip(checkpoints[:-1], checkpoints[1:])]

    slot_lane, slot_long, slot_routes = [], [], []
    if spawn_roads_cfg is None:
        last_block = blocks[-1]
        sockets = last_block.get_socket_list()
        socket = rs_dest.choice(sockets) if len(sockets) > 1 else sockets[0]
        dest_node = socket.positive_road.end_node
        spawn_road = Road(">", ">>")
        for lane_i, lane in enumerate(spawn_road.get_lanes(network)):
            rr = route_from(">", dest_node)
            assert rr, "no route to destination"
            slot_lane.append(lane_list.index(lane))
            slot_long.append(5.0)
            slot_routes.append(rr)
    else:
        arms = [Road(a, b) for a, b in spawn_roads_cfg]
        # each arm's exit node = end of the reversed arm road (see -Road)
        exit_nodes = [(-r).end_node for r in arms]
        # single-arm fallback: auto-assign to a last-block socket exit
        # (the reference MA base on PG maps, spawn_manager update_destination)
        last_sockets = blocks[-1].get_socket_list()
        fallback_dests = [s.positive_road.end_node for s in last_sockets]
        # optional per-arm destination candidates (parking lot: in-arms route
        # to parking spaces, spaces route back out; marl_parking_lot.py
        # ParkingLotSpawnManager.update_destination_for)
        dest_nodes_cfg = dest_nodes_default
        for ai, road in enumerate(arms):
            lanes = road.get_lanes(network)
            length = lanes[0].length
            longs = [5.0 + RESPAWN_REGION_LONGITUDE * j
                     for j in range(int((length - 5.0) / RESPAWN_REGION_LONGITUDE) + 1)]
            if dest_nodes_cfg is not None:
                dest_choices = list(dest_nodes_cfg[ai])
            elif config.get("spawn_u_turn_dests"):
                # the reference's default MAIntersectionSpawnManager keeps
                # the agent's OWN road among the end roads (u-turn routes,
                # marl_intersection.py:70-79 disable_u_turn=False)
                dest_choices = list(exit_nodes)
            else:
                dest_choices = [exit_nodes[aj] for aj in range(len(arms)) if aj != ai] or fallback_dests
            for long in longs:
                for lane in lanes:
                    # random dest first, then fall back over the remaining
                    # candidates until one is routable
                    first = rs_dest.randint(len(dest_choices))
                    rr = None
                    for di in [first] + [d for d in range(len(dest_choices)) if d != first]:
                        rr = route_from(road.start_node, dest_choices[di])
                        if rr is not None:
                            break
                    if rr is None:
                        continue
                    slot_lane.append(lane_list.index(lane))
                    slot_long.append(float(long))
                    slot_routes.append(rr)
    assert slot_routes, "no valid spawn slots"
    SLOT = len(slot_routes)
    K = max(len(r) for r in slot_routes)
    route_roads = np.full((SLOT, K), -1, np.int32)
    route_len = np.zeros((SLOT,), np.int32)
    for i, r in enumerate(slot_routes):
        route_roads[i, :len(r)] = r
        route_len[i] = len(r)

    # ---- PG traffic lights (the reference ships BaseTrafficLight lane
    #      components, component/traffic_light/base_traffic_light.py, but no
    #      PG-map light manager — lights are placed per-test. Here an opt-in
    #      compiler pass lights every intersection approach with an
    #      alternating signal cycle.) ----------------------------------------
    lights_cfg = config.get("pg_traffic_lights") or None
    light_lane, light_long, light_pos, light_offset = [], [], [], []
    light_heading, light_width = [], []
    if lights_cfg:
        from benchmarks.reference.mapgen.blocks import InterSection
        g_dur = int(lights_cfg.get("green", 30)) if isinstance(lights_cfg, dict) else 30
        y_dur = int(lights_cfg.get("yellow", 4)) if isinstance(lights_cfg, dict) else 4
        half = g_dur + y_dur
        for block in blocks[1:]:
            if not isinstance(block, InterSection):
                continue
            approaches = [block.pre_block_socket.positive_road] + [
                s.negative_road for s in block.get_socket_list()
            ]
            for arm, rd in enumerate(approaches):
                try:
                    lanes = rd.get_lanes(network)
                except KeyError:
                    continue
                for lane in lanes:
                    light_lane.append(lane_list.index(lane))
                    light_long.append(lane.length)
                    light_pos.append(np.asarray(lane.position(lane.length, 0), np.float32))
                    # the air-wall stop region spans the lane at its end
                    # (BaseTrafficLight: AIR_WALL_LENGTH x lane width,
                    # base_traffic_light.py:17,44-51)
                    light_heading.append(float(lane.heading_theta_at(lane.length)))
                    light_width.append(float(lane.width))
                    # opposite arms share a phase (0/2 vs 1/3)
                    light_offset.append((arm % 2) * half)
    LT = len(light_lane)

    # ---- boundary segments ------------------------------------------------
    seg_p0, seg_p1, seg_type, seg_halfwidth = [], [], [], []

    def add_polyline(points, typ, halfwidth):
        a, b = _polyline_segments(points)
        for p, q in zip(a, b):
            seg_p0.append(p)
            seg_p1.append(q)
            seg_type.append(typ)
            seg_halfwidth.append(halfwidth)

    for rid, (road, lane0, nlanes) in enumerate(road_list):
        first, last = lane_list[lane0], lane_list[lane0 + nlanes - 1]
        w = first.width
        if first.line_types[0] in (LINE_CONTINUOUS, LINE_SIDE):
            # grey continuous center lines (parking spaces) classify as
            # white, not yellow (constants PGLineColor; base_vehicle.py:714)
            center_type = (
                SEG_YELLOW_LINE if first.line_colors[0] == LINE_COLOR_YELLOW
                else SEG_WHITE_LINE
            )
            add_polyline(_lane_polyline(first, -w / 2), center_type, LINE_CONTACT_HALF_WIDTH)
        if last.line_types[1] in (LINE_CONTINUOUS, LINE_SIDE):
            add_polyline(_lane_polyline(last, w / 2), SEG_WHITE_LINE, LINE_CONTACT_HALF_WIDTH)
        if last.line_types[1] == LINE_SIDE:
            off = w / 2 + SIDEWALK_LINE_DIST + SIDEWALK_HALF_WIDTH
            add_polyline(_lane_polyline(last, off), SEG_SIDEWALK, SIDEWALK_HALF_WIDTH)
        # guardrails: physical walls AT the line (racing tracks); contact
        # classifies as crash_sidewalk (PGLineType.GUARDRAIL)
        if first.line_types[0] == LINE_GUARDRAIL:
            add_polyline(_lane_polyline(first, -w / 2), SEG_SIDEWALK, 0.2)
        if last.line_types[1] == LINE_GUARDRAIL:
            add_polyline(_lane_polyline(last, w / 2), SEG_SIDEWALK, 0.2)
        if config.get("include_broken_line_segs"):
            # broken lane lines exist as static-world ghost bodies in the
            # reference and are seen by the LaneLineDetector (BrokenLaneLine
            # mask, distance_detector.py:209). Off the default path because
            # they inflate the segment count for every contact test.
            if first.line_types[0] == LINE_BROKEN:
                add_polyline(_lane_polyline(first, -w / 2), SEG_BROKEN_LINE,
                             LINE_CONTACT_HALF_WIDTH)
            for li in range(nlanes - 1):
                inner = lane_list[lane0 + li]
                add_polyline(_lane_polyline(inner, inner.width / 2),
                             SEG_BROKEN_LINE, LINE_CONTACT_HALF_WIDTH)

    B = len(seg_p0)

    # ---- accident scenes (reference: TrafficObjectManager.reset,
    #      object_manager.py:40-152) ----------------------------------------
    from benchmarks.reference.mapgen.blocks import (
        Curve, InRampOnStraight, OutRampOnStraight, Straight
    )
    accident_prob = config.get("accident_prob", 0.0)
    obj_pos, obj_heading, obj_kind, obj_len, obj_wid = [], [], [], [], []

    def add_obj(kind, pos, heading, dims=None):
        obj_pos.append(np.asarray(pos, np.float32))
        obj_heading.append(float(heading))
        obj_kind.append(kind)
        length, width = OBJ_DIMS[kind] if dims is None else dims
        obj_len.append(float(length))
        obj_wid.append(float(width))

    # toll booth buildings (tollgate.py:64-75 spawns TollGateBuilding per odd
    # lane; here they are compile-time static boxes with crash_building)
    for block in blocks:
        for lane, long, blength, bwidth in getattr(block, "buildings", []):
            add_obj(
                OBJ_BUILDING, lane.position(long, 0), lane.heading_theta_at(long),
                dims=(blength, bwidth),
            )

    accident_lanes = set()
    breakdown_npcs = []  # (lane, long, class)
    if accident_prob > 1e-2:
        rs_obj = np.random.RandomState((seed * 31 + 17) % (2 ** 31))
        lane_width_cfg = map_config.get("lane_width", 3.5)

        def prohibit_scene(lane, longitude, lateral_len, on_left):
            # cone corridor closing one lane (object_manager.py:119-152)
            lat_num = int(lateral_len / CONE_LATERAL)
            long_num = int(ACCIDENT_AREA_LEN / CONE_LONGITUDE)
            lat_seq = (
                [l * CONE_LATERAL for l in range(lat_num)]
                + [lat_num * CONE_LATERAL] * (long_num + 1)
                + [(lat_num - l - 1) * CONE_LATERAL for l in range(lat_num)]
            )
            total = lat_num * 2 + long_num + 1
            left = 1 if on_left else -1
            for k, lat in zip(range(-total // 2, total // 2), lat_seq):
                p_long = k * CONE_LONGITUDE + longitude
                p_lat = left * (lat - lane.width / 2)
                add_obj(OBJ_CONE, lane.position(p_long, p_lat), lane.heading_theta_at(p_long))

        for block in blocks[1:]:
            if type(block) not in (Straight, Curve, InRampOnStraight, OutRampOnStraight):
                continue
            if rs_obj.rand() > accident_prob:
                continue
            road_1 = Road(block.pre_block_socket.positive_road.end_node, block.road_node(0, 0))
            road_2 = (
                Road(block.road_node(0, 0), block.road_node(0, 1))
                if not isinstance(block, Straight) else None
            )
            is_ramp = isinstance(block, (InRampOnStraight, OutRampOnStraight))
            if rs_obj.rand() > PROHIBIT_SCENE_PROB:
                acc_road = (rs_obj.choice([road_1, road_2]) if not isinstance(block, Curve) else road_2)
                acc_road = road_1 if acc_road is None else acc_road
                on_left = True if rs_obj.rand() > 0.5 or (acc_road is road_2 and is_ramp) else False
                idx = 0 if on_left else -1
                lanes = acc_road.get_lanes(network)
                lane = lanes[idx]
                longitude = lane.length - ACCIDENT_AREA_LEN - 5
                accident_lanes.add(id(lane))
                prohibit_scene(lane, longitude, lane_width_cfg, on_left)
            else:
                acc_road = rs_obj.choice([road_1, road_2]) if road_2 is not None else road_1
                acc_road = road_1 if acc_road is None else acc_road
                on_left = True if rs_obj.rand() > 0.5 or (acc_road is road_2 and is_ramp) else False
                lanes = acc_road.get_lanes(network)
                if len(lanes) - 1 == 0:
                    idx = -1
                else:
                    idx = rs_obj.randint(0, len(lanes) - 1) if on_left else -1
                lane = lanes[idx]
                accident_lanes.add(id(lane))
                longitude = rs_obj.rand() * lane.length / 2 + lane.length / 2
                if rs_obj.rand() > 0.5:
                    # breakdown vehicle + warning sign (object_manager.py:93-109)
                    cls = int(rs_obj.choice(5, p=NPC_CLASS_PROBS))
                    breakdown_npcs.append((lane, float(longitude), cls))
                    w_long = longitude - ALERT_DIST
                    add_obj(OBJ_WARNING, lane.position(w_long, 0), lane.heading_theta_at(w_long))
                else:
                    add_obj(OBJ_BARRIER, lane.position(longitude, 0), lane.heading_theta_at(longitude))

    # ---- traffic spawn slots (trigger mode,
    #      traffic_manager.py:231-277 _create_vehicles_once) ----------------
    density = config.get("traffic_density", 0.0)
    # MixedPGTrafficManager: each spawned NPC is expert-driven with
    # probability rl_agent_ratio (traffic_manager.py:403-409)
    rl_ratio = config.get("rl_agent_ratio", 0.0) or 0.0
    npc_lane, npc_long, npc_class, npc_trigger, npc_expert = [], [], [], [], []
    if density > 0:
        rs_traffic = np.random.RandomState((seed * 1000003 + 7) % (2 ** 31))
        for block in blocks[1:]:
            candidates = []
            if hasattr(block, "npc_chains"):
                # OpenDrive maps: candidates tile whole lane CHAINS (the
                # mini-lanes are shorter than VEHICLE_GAP)
                total_len = 0.0
                for chain in block.npc_chains:
                    chain_len = sum(l.length for l in chain)
                    total_len += chain_len
                    target = 0.0
                    cum = 0.0
                    ci = 0
                    while target < chain_len - 1e-6 and ci < len(chain):
                        if target < cum + chain[ci].length:
                            candidates.append((chain[ci], target - cum))
                            target += VEHICLE_GAP
                        else:
                            cum += chain[ci].length
                            ci += 1
            else:
                trigger_lanes = block.get_intermediate_spawn_lanes()
                for lanes in trigger_lanes:
                    for lane in lanes:
                        if id(lane) in accident_lanes:  # traffic_manager.py:249
                            continue
                        total = int(lane.length / VEHICLE_GAP)
                        for k in range(total):
                            candidates.append((lane, k * VEHICLE_GAP))
                total_len = sum(l.length for lanes in trigger_lanes for l in lanes)
            n_spawn = int(math.floor(math.floor(total_len / VEHICLE_GAP) * density))
            rs_traffic.shuffle(candidates)
            selected = candidates[:min(n_spawn, len(candidates))]
            trig_road = block.pre_block_socket.positive_road
            trig_id = road_key_to_id[trig_road.key()]
            for lane, long in selected:
                cls = int(rs_traffic.choice(5, p=NPC_CLASS_PROBS))
                lid = lane_list.index(lane)
                npc_lane.append(lid)
                npc_long.append(long)
                npc_class.append(cls)
                npc_trigger.append(trig_id)
                npc_expert.append(bool(rl_ratio > 0 and rs_traffic.random_sample() < rl_ratio))
    # breakdown vehicles join the NPC arrays, never released (trigger -2)
    for lane, long, cls in breakdown_npcs:
        npc_lane.append(lane_list.index(lane))
        npc_long.append(long)
        npc_class.append(cls)
        npc_trigger.append(-2)
        npc_expert.append(False)
    N = len(npc_lane)

    # ---- pedestrians / cyclists on sidewalks (the _ped fork's participant
    #      path; geometry from pedestrian.py/cyclist.py; spawning is a
    #      extension controlled by pedestrian_density) ------------
    ped_density = config.get("pedestrian_density", 0.0)
    ped_lane, ped_lat, ped_long, ped_speed, ped_kind = [], [], [], [], []
    if ped_density > 0:
        rs_ped = np.random.RandomState((seed * 7919 + 3) % (2 ** 31))
        side_off = None
        for rid, (road, lane0, nlanes) in enumerate(road_list):
            last = lane_list[lane0 + nlanes - 1]
            if last.line_types[1] != LINE_SIDE:
                continue
            w = last.width
            walk_lat = w / 2 + SIDEWALK_LINE_DIST + SIDEWALK_HALF_WIDTH
            total = int(last.length * ped_density / 10.0)
            for _ in range(total):
                kind = PED_CYCLIST if rs_ped.rand() < 0.2 else PED_WALKER
                ped_lane.append(lane0 + nlanes - 1)
                ped_lat.append(walk_lat if kind == PED_WALKER else w / 2 - 0.5)
                ped_long.append(float(rs_ped.rand() * last.length))
                ped_speed.append(
                    float(rs_ped.choice(PED_SPEEDS)) if kind == PED_WALKER else 4.0
                )
                ped_kind.append(kind)
    P = len(ped_lane)

    return dict(
        lane_kind=lane_kind, lane_p0=lane_p0, lane_dir=lane_dir, lane_radius=lane_radius,
        lane_start_phase=lane_start_phase, lane_arc_dir=lane_arc_dir, lane_width=lane_width,
        lane_length=lane_length, lane_angle=lane_angle, lane_road=lane_road,
        lane_idx_in_road=lane_idx_in_road, lane_succ=lane_succ, lane_left=lane_left,
        lane_right=lane_right, lane_valid=np.ones(L, bool),
        lane_speed_limit=lane_speed_limit, lane_block=lane_block,
        road_lane0=road_lane0, road_nlanes=road_nlanes, road_negative=road_negative,
        road_succ=road_succ, road_valid=np.ones(R, bool),
        route_roads=route_roads, route_len=route_len,
        light_lane=np.asarray(light_lane, np.int32),
        light_long=np.asarray(light_long, np.float32),
        light_pos=np.asarray(light_pos, np.float32).reshape(LT, 2),
        light_heading=np.asarray(light_heading, np.float32),
        light_width=np.asarray(light_width, np.float32),
        light_offset=np.asarray(light_offset, np.int32),
        light_valid=np.ones(LT, bool),
        slot_lane=np.asarray(slot_lane, np.int32), slot_long=np.asarray(slot_long, np.float32),
        slot_valid=np.ones(SLOT, bool),
        seg_p0=np.asarray(seg_p0, np.float32).reshape(B, 2),
        seg_p1=np.asarray(seg_p1, np.float32).reshape(B, 2),
        seg_type=np.asarray(seg_type, np.int32), seg_halfwidth=np.asarray(seg_halfwidth, np.float32),
        seg_valid=np.ones(B, bool),
        npc_lane=np.asarray(npc_lane, np.int32), npc_long=np.asarray(npc_long, np.float32),
        npc_class=np.asarray(npc_class, np.int32), npc_trigger_road=np.asarray(npc_trigger, np.int32),
        npc_valid=np.ones(N, bool), npc_expert=np.asarray(npc_expert, bool),
        obj_pos=np.asarray(obj_pos, np.float32).reshape(len(obj_pos), 2),
        obj_heading=np.asarray(obj_heading, np.float32),
        obj_len=np.asarray(obj_len, np.float32),
        obj_wid=np.asarray(obj_wid, np.float32),
        obj_kind=np.asarray(obj_kind, np.int32),
        obj_valid=np.ones(len(obj_kind), bool),
        ped_lane=np.asarray(ped_lane, np.int32), ped_lat=np.asarray(ped_lat, np.float32),
        ped_long=np.asarray(ped_long, np.float32), ped_speed=np.asarray(ped_speed, np.float32),
        ped_kind=np.asarray(ped_kind, np.int32),
        ped_len=np.asarray([PED_DIMS[k][0] for k in ped_kind], np.float32),
        ped_wid=np.asarray([PED_DIMS[k][1] for k in ped_kind], np.float32),
        ped_valid=np.ones(P, bool),
    )


_PAD_VALUES = dict(route_roads=-1, npc_lane=0, npc_trigger_road=-1, lane_succ=-1, lane_left=-1,
                   lane_right=-1, road_succ=-1)


def _pad_to_shape(arr, shape, pad_value=0):
    if arr.shape == tuple(shape):
        return arr
    out = np.full(shape, pad_value, dtype=arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def build_scene_pack(seeds, config, min_npc_slots=0):
    """Compile scenes for all seeds, stack with padding -> dict [S, ...]."""
    scenes = [compile_scene(s, config) for s in seeds]
    keys = scenes[0].keys()
    max_shape = {}
    for k in keys:
        arrs = [sc[k] for sc in scenes]
        if arrs[0].ndim > 0:
            max_shape[k] = tuple(
                max(max(a.shape[d] for a in arrs), 1) for d in range(arrs[0].ndim)
            )
    if "npc_lane" in max_shape:
        npc_n = max(max_shape["npc_lane"][0], min_npc_slots, 1)
        for k in ("npc_lane", "npc_long", "npc_class", "npc_trigger_road", "npc_valid", "npc_expert"):
            max_shape[k] = (npc_n,) + max_shape[k][1:]
    pack = {}
    for k in keys:
        arrs = [sc[k] for sc in scenes]
        if arrs[0].ndim == 0:
            pack[k] = np.stack(arrs)
        else:
            pack[k] = np.stack(
                [_pad_to_shape(a, max_shape[k], _PAD_VALUES.get(k, 0)) for a in arrs]
            )
    return pack
