"""Procedural PG block types (host-side).

Re-implements the reference block family
(metadrive/component/pgblock/*.py) without Panda3D/Bullet: each block only
mutates a NodeRoadNetwork of HostLanes; physical geometry (lane-line and
sidewalk segments) is derived later by the scene compiler.

Block construction protocol mirrors base_block.py:95-130: sample parameters
from PARAMETER_SPACE -> _try_plug_into_previous_block() -> merge into the
global network on success.
"""
import math
from collections import OrderedDict

import numpy as np

from benchmarks.reference.constants import (
    LINE_BROKEN, LINE_COLOR_GREY, LINE_COLOR_YELLOW, LINE_CONTINUOUS, LINE_NONE, LINE_SIDE
)
from benchmarks.reference.mapgen.lanes import (
    HostStraightLane, create_bend_straight, create_wave_lanes, extend_straight_lane
)
from benchmarks.reference.mapgen.network import NodeRoadNetwork, Road
from benchmarks.reference.mapgen import spaces
from benchmarks.reference.mapgen.spaces import Parameter


class PGBlockSocket:
    """A pair of positive/negative roads (reference: pg_block.py:19-59)."""

    def __init__(self, positive_road, negative_road):
        self.positive_road = positive_road
        self.negative_road = negative_road
        self.index = None

    def get_positive_lanes(self, network):
        return self.positive_road.get_lanes(network)

    def get_negative_lanes(self, network):
        return self.negative_road.get_lanes(network)

    def is_socket_node(self, node):
        return node in (
            self.positive_road.start_node, self.positive_road.end_node,
            self.negative_road.start_node, self.negative_road.end_node
        )

    def get_socket_in_reverse(self):
        """Socket with positive/negative roads swapped
        (reference: pg_block.py:44-50)."""
        return PGBlockSocket(self.negative_road, self.positive_road)


def _offset_lane(cur, direction):
    """Copy of a lane shifted one width laterally; direction=-1 left, +1 right
    (CreateRoadFrom inner loop, create_pg_block_utils.py:104-126)."""
    width = cur.width
    if isinstance(cur, HostStraightLane):
        return HostStraightLane(
            cur.position(0, direction * width), cur.position(cur.length, direction * width),
            cur.width, list(cur.line_types)
        )
    from benchmarks.reference.mapgen.lanes import HostCircularLane
    if direction < 0:  # leftward: clockwise arcs grow, ccw shrink
        radius2 = cur.radius + width if cur.is_clockwise() else cur.radius - width
    else:  # rightward
        radius2 = cur.radius - width if cur.is_clockwise() else cur.radius + width
    return HostCircularLane(
        cur.center, radius2, cur.start_phase, cur.angle, cur.is_clockwise(), cur.width,
        list(cur.line_types)
    )


def create_road_from(lane, lane_num, road, block_network, roadnet_to_check_cross=None,
                     side_line_type=LINE_SIDE, center_line_type=LINE_CONTINUOUS,
                     inner_line_type=LINE_BROKEN, toward_smaller_lane_index=True,
                     center_line_color=LINE_COLOR_YELLOW, ignore_start=None,
                     ignore_end=None, detect_one_side=True,
                     ignore_intersection_checking=False):
    """Clone ``lane`` laterally into lane_num lanes on ``road``.

    Geometry and overlap checking match CreateRoadFrom
    (create_pg_block_utils.py:50-176). toward_smaller_lane_index=True: the
    given lane becomes the LAST index (rightmost); clones stack leftward;
    lane 0 carries the center line on its left, the given lane the side line
    on its right. False: the given lane is index 0 and clones stack
    rightward.

    When ``roadnet_to_check_cross`` (the previously merged global network)
    is given and checking is not disabled, returns the reference's no_cross
    verdict: the origin lane sampled at the sidewalk-padded lateral factor
    (and, with detect_one_side=False, lanes[0] at -0.95) must not land on
    any existing lane (overlap.check_lane_on_road, the exact port of
    utils/pg/utils.py:37-72). Without a check network, returns True.
    """
    lane_width = lane.width_at(0)
    origin_lane = lane
    lanes = [lane]
    cur = lane
    for i in range(lane_num - 1, 0, -1):
        side = _offset_lane(cur, -1 if toward_smaller_lane_index else +1)
        if i == 1:
            side.line_types = (
                [center_line_type, inner_line_type] if toward_smaller_lane_index
                else [inner_line_type, side_line_type]
            )
        else:
            side.line_types = [inner_line_type, inner_line_type]
        lanes.append(side)
        cur = side
    if toward_smaller_lane_index:
        lanes.reverse()  # index 0 = leftmost (center-line side)
        lane.line_types = [inner_line_type if lane_num > 1 else center_line_type, side_line_type]
    elif lane_num > 1:
        lane.line_types = [lane.line_types[0], lanes[-1].line_types[0]]

    # overlap rejection at the reference call site
    # (create_pg_block_utils.py:136-167)
    no_cross = True
    if roadnet_to_check_cross is not None and not ignore_intersection_checking:
        from benchmarks.reference.mapgen.overlap import (
            SIDEWALK_LINE_DIST, SIDEWALK_WIDTH, check_lane_on_road
        )
        ignore = (ignore_start, ignore_end)
        factor = (SIDEWALK_WIDTH + SIDEWALK_LINE_DIST + lane_width / 2.0) * 2.0 / lane_width
        if not detect_one_side:
            no_cross = not (
                check_lane_on_road(roadnet_to_check_cross, origin_lane, factor,
                                   ignore, ignore_intersection_checking=False)
                or check_lane_on_road(roadnet_to_check_cross, lanes[0], -0.95,
                                      ignore, ignore_intersection_checking=False)
            )
        else:
            no_cross = not check_lane_on_road(
                roadnet_to_check_cross, origin_lane, factor, ignore,
                ignore_intersection_checking=False,
            )

    for l in lanes:
        block_network.add_lane(road.start_node, road.end_node, l)
    # single-lane roads carry center + side lines in BOTH stacking
    # directions (create_pg_block_utils.py:171-172)
    if lane_num == 1:
        lanes[-1].line_types = [center_line_type, side_line_type]
    # center-line color on lane 0's left line (create_pg_block_utils.py:174)
    lanes[0].line_colors = [center_line_color, LINE_COLOR_GREY]
    return no_cross


def create_adverse_road(positive_road, block_network, roadnet_to_check_cross=None,
                        side_line_type=LINE_SIDE, center_line_type=LINE_CONTINUOUS,
                        inner_line_type=LINE_BROKEN, center_line_color=LINE_COLOR_YELLOW,
                        ignore_start=None, ignore_end=None,
                        ignore_intersection_checking=False):
    """Mirror of CreateAdverseRoad (create_pg_block_utils.py:203-282),
    including the no_cross verdict from the inner create_road_from."""
    adverse = -positive_road
    lanes = positive_road.get_lanes(block_network)
    reference_lane = lanes[-1]
    num = len(lanes) * 2
    width = reference_lane.width_at(0)
    if isinstance(reference_lane, HostStraightLane):
        start_point = reference_lane.position(reference_lane.length, -(num - 1) * width)
        end_point = reference_lane.position(0, -(num - 1) * width)
        symmetric = HostStraightLane(start_point, end_point, width, list(reference_lane.line_types))
    else:
        from benchmarks.reference.mapgen.lanes import HostCircularLane
        new_clockwise = not reference_lane.is_clockwise()
        if not new_clockwise:
            radius = reference_lane.radius + (num - 1) * width
        else:
            radius = reference_lane.radius - (num - 1) * width
        symmetric = HostCircularLane(
            reference_lane.center, radius, reference_lane.end_phase, reference_lane.angle,
            new_clockwise, width, list(reference_lane.line_types)
        )
    return create_road_from(
        symmetric, len(lanes), adverse, block_network, roadnet_to_check_cross,
        side_line_type=side_line_type, center_line_type=center_line_type,
        inner_line_type=inner_line_type, center_line_color=center_line_color,
        ignore_start=ignore_start, ignore_end=ignore_end,
        ignore_intersection_checking=ignore_intersection_checking,
    )


def create_two_way_road(road_to_change, block_network, new_road,
                        center_line_type=LINE_CONTINUOUS, side_line_type=LINE_SIDE,
                        inner_line_type=LINE_BROKEN):
    """Overlay a reverse-direction road on the SAME physical lanes
    (reference: create_pg_block_utils.py:284-356 CreateTwoWayRoad — the
    offset is -(num-1)*width, so a 1-lane road reverses in place)."""
    lanes = road_to_change.get_lanes(block_network)
    reference_lane = lanes[-1]
    num = len(lanes)
    width = reference_lane.width_at(0)
    if isinstance(reference_lane, HostStraightLane):
        start_point = reference_lane.position(reference_lane.length, -(num - 1) * width)
        end_point = reference_lane.position(0, -(num - 1) * width)
        symmetric = HostStraightLane(start_point, end_point, width, list(reference_lane.line_types))
    else:
        from benchmarks.reference.mapgen.lanes import HostCircularLane
        new_clockwise = not reference_lane.is_clockwise()
        radius = (
            reference_lane.radius + (num - 1) * width if not new_clockwise
            else reference_lane.radius - (num - 1) * width
        )
        symmetric = HostCircularLane(
            reference_lane.center, radius, reference_lane.end_phase, reference_lane.angle,
            new_clockwise, width, list(reference_lane.line_types)
        )
    return create_road_from(
        symmetric, num, new_road, block_network,
        center_line_type=center_line_type, side_line_type=side_line_type,
        inner_line_type=inner_line_type,
    )


class PGBlock:
    ID = None
    SOCKET_NUM = 1
    PARAMETER_SPACE = {}

    def __init__(self, block_index, pre_block_socket, global_network, random_seed):
        self.block_index = block_index
        self.pre_block_socket = pre_block_socket
        self.global_network = global_network
        from benchmarks.reference.mapgen.ref_random import ref_rng
        self.random_seed = random_seed
        self.np_random = ref_rng(random_seed)
        self.number_of_sample_trial = 0
        self.block_network = None
        self._sockets = OrderedDict()
        self._respawn_roads = []
        self._node_cnt = 0
        self._part_idx = 0
        self.config = {}
        # one-way / walled variants (reference: base_block.py
        # remove_negative_lanes + PGLineType.GUARDRAIL side/center lines,
        # used by the racing map, marl_racing_env.py:91-99)
        self.remove_negative_lanes = False
        self.center_line_override = None
        self.side_line_override = None
        # when True, every check_lane_on_road call is skipped (the path the
        # reference's config-built maps take, pg_map.py:92-103); BIG sampling
        # always runs with checking ON (BIG.py:114 ignore=False)
        self.ignore_intersection_checking = False
        # BaseRunnable.__init__ samples the parameter space once at
        # construction (base_runnable.py:26) — that config is immediately
        # re-sampled by construct_block, but the randint it consumes shifts
        # the block's np_random stream; replicate the draw for seed parity
        self.sample_parameters()

    # -- naming ------------------------------------------------------------
    def set_part_idx(self, idx):
        self._part_idx = idx
        self._node_cnt = 0

    def add_road_node(self):
        name = f"{self.block_index}{self.ID}{self._part_idx}_{self._node_cnt}_"
        self._node_cnt += 1
        return name

    # -- sockets -----------------------------------------------------------
    def add_sockets(self, *sockets):
        for s in sockets:
            s.index = len(self._sockets)
            self._sockets[s.index] = s

    def get_socket(self, index):
        return self._sockets[index]

    def get_socket_indices(self):
        return list(self._sockets.keys())

    def get_socket_list(self):
        return list(self._sockets.values())

    @staticmethod
    def create_socket_from_positive_road(road):
        return PGBlockSocket(road, -road)

    # -- construction ------------------------------------------------------
    @property
    def positive_basic_lane(self):
        return self.pre_block_socket.get_positive_lanes(self.global_network)[-1]

    @property
    def positive_lanes(self):
        return self.pre_block_socket.get_positive_lanes(self.global_network)

    @property
    def positive_lane_num(self):
        return len(self.pre_block_socket.get_positive_lanes(self.global_network))

    def sample_parameters(self):
        # reference: base_runnable.py:81-93 — one randint(1e6) per trial,
        # then every member space is re-seeded with that value and consumes
        # exactly one uniform, so all parameters derive from the same u
        # (see mapgen/ref_random.parameter_u)
        from benchmarks.reference.mapgen.ref_random import parameter_u
        seed = self.np_random.randint(0, int(1e6))
        u = parameter_u(seed)
        self.config = {k: space.sample_from_u(u) for k, space in self.PARAMETER_SPACE.items()}

    def construct(self, config=None, check_overlap=True):
        """Sample + build + merge into the global network; returns the
        no_cross success verdict (reference construct_block,
        base_block.py:95-130: topology is merged into the global network
        REGARDLESS of success — the BIG FSM destructs failed blocks)."""
        self.number_of_sample_trial += 1
        self.sample_parameters()
        if config:
            self.config.update(config)
        self.ignore_intersection_checking = not check_overlap
        self.block_network = NodeRoadNetwork()
        self._sockets = OrderedDict()
        self._respawn_roads = []
        self._node_cnt = 0
        ok = self._try_plug_into_previous_block()
        self.global_network.add(self.block_network)
        return ok

    def destruct(self):
        """Remove this block's roads from the global network. The decoration
        road is SHARED between blocks — remove only this block's lanes by
        identity (reference node_road_network.py:107-115 __isub__)."""
        from benchmarks.reference.mapgen.overlap import DECORATION_START
        for start, ends in self.block_network.graph.items():
            gstart = self.global_network.graph.get(start)
            if not gstart:
                continue
            if start == DECORATION_START:
                # the (possibly now-empty) decoration entry stays in the
                # graph, exactly like the reference __isub__
                for end, lanes in ends.items():
                    glanes = gstart.get(end)
                    if glanes:
                        gstart[end] = [l for l in glanes if all(l is not m for m in lanes)]
                continue
            for end in list(ends.keys()):
                gstart.pop(end, None)
            if not gstart:
                self.global_network.graph.pop(start, None)

    def get_respawn_roads(self):
        return self._respawn_roads

    def add_respawn_roads(self, roads):
        if isinstance(roads, Road):
            roads = [roads]
        self._respawn_roads.extend(roads)

    def get_respawn_lanes(self, network=None):
        network = network or self.block_network
        return [road.get_lanes(network) for road in self._respawn_roads]

    def road_node(self, part_idx, road_idx):
        """Node name for (part, road) — matches add_road_node's scheme
        (reference: pg_block.py:226-234)."""
        return f"{self.block_index}{self.ID}{part_idx}_{road_idx}_"

    @property
    def lane_width(self):
        return self.positive_basic_lane.width_at(0)

    def get_intermediate_spawn_lanes(self):
        """Positive lanes of this block usable as traffic spawn points
        (reference: pg_block.py:236-242 via get_positive_lanes, which
        excludes negative roads AND the decoration road — road.py
        is_valid_road)."""
        from benchmarks.reference.mapgen.overlap import DECORATION_START
        lanes = []
        for start, ends in self.block_network.graph.items():
            if start.startswith("-") or start == DECORATION_START:
                continue
            for end, road_lanes in ends.items():
                lanes.append(road_lanes)
        return lanes

    def _try_plug_into_previous_block(self):
        raise NotImplementedError

    def _cross_kwargs(self, **extra):
        """kwargs wiring a create_road_from/create_adverse_road call to the
        reference's cross-check site (roadnet_to_check_cross =
        self._global_network, e.g. straight.py:33-52)."""
        kw = dict(
            roadnet_to_check_cross=self.global_network,
            ignore_intersection_checking=self.ignore_intersection_checking,
        )
        kw.update(extra)
        return kw

    def _check_lane(self, lane, positive):
        """not check_lane_on_road(global, lane, positive) — the explicit
        sample-test call sites inside intersection/ramp construction
        (intersection.py:137-141, ramp.py:131-194, 307-370)."""
        from benchmarks.reference.mapgen.overlap import check_lane_on_road
        if self.ignore_intersection_checking:
            return True
        return not check_lane_on_road(
            self.global_network, lane, positive,
            ignore_intersection_checking=False,
        )


class FirstPGBlock(PGBlock):
    """Spawn block (reference: pgblock/first_block.py:13-117): a 10 m
    entrance road (> to >>) plus an exit_length-10 road (>> to >>>),
    both with adverse twins."""

    NODE_1 = ">"
    NODE_2 = ">>"
    NODE_3 = ">>>"
    ID = "I"
    ENTRANCE_LENGTH = 10.0

    def __init__(self, global_network, lane_width, lane_num, length=50.0,
                 remove_negative_lanes=False, center_line_type=None, side_line_type=None):
        super().__init__(0, None, global_network, random_seed=0)
        self.remove_negative_lanes = remove_negative_lanes
        center = center_line_type or LINE_CONTINUOUS
        side = side_line_type or LINE_SIDE
        self.block_network = NodeRoadNetwork()
        basic = HostStraightLane(
            [0.0, 0.0], [self.ENTRANCE_LENGTH, 0.0], width=lane_width,
            line_types=[LINE_BROKEN, side]
        )
        spawn_road = Road(self.NODE_1, self.NODE_2)
        create_road_from(basic, lane_num, spawn_road, self.block_network,
                         center_line_type=center, side_line_type=side)
        if not remove_negative_lanes:
            create_adverse_road(spawn_road, self.block_network)

        next_lane = extend_straight_lane(basic, length - self.ENTRANCE_LENGTH, [LINE_BROKEN, side])
        other_road = Road(self.NODE_2, self.NODE_3)
        create_road_from(next_lane, lane_num, other_road, self.block_network,
                         center_line_type=center, side_line_type=side)
        if not remove_negative_lanes:
            create_adverse_road(other_road, self.block_network)

        self.global_network.add(self.block_network)
        socket = self.create_socket_from_positive_road(other_road)
        self.add_sockets(socket)
        self._respawn_roads = [other_road]

    def _try_plug_into_previous_block(self):
        raise RuntimeError("FirstPGBlock cannot be re-constructed")


class Straight(PGBlock):
    """reference: pgblock/straight.py"""

    ID = "S"
    PARAMETER_SPACE = spaces.STRAIGHT_SPACE

    def _try_plug_into_previous_block(self):
        self.set_part_idx(0)
        length = self.config[Parameter.length]
        center = self.center_line_override or LINE_CONTINUOUS
        side = self.side_line_override or LINE_SIDE
        basic_lane = self.positive_basic_lane
        new_lane = extend_straight_lane(basic_lane, length, [LINE_BROKEN, side])
        start = self.pre_block_socket.positive_road.end_node
        end = self.add_road_node()
        socket_road = Road(start, end)
        # no_cross wiring mirrors straight.py:33-55
        no_cross = create_road_from(
            new_lane, self.positive_lane_num, socket_road, self.block_network,
            center_line_type=center, side_line_type=side, **self._cross_kwargs()
        )
        if not self.remove_negative_lanes:
            no_cross = create_adverse_road(
                socket_road, self.block_network,
                center_line_type=center, side_line_type=side, **self._cross_kwargs()
            ) and no_cross
        self.add_sockets(PGBlockSocket(socket_road, -socket_road))
        return no_cross


class Curve(PGBlock):
    """reference: pgblock/curve.py — bend + straight continuation pair."""

    ID = "C"
    PARAMETER_SPACE = spaces.CURVE_SPACE

    def _try_plug_into_previous_block(self):
        self.set_part_idx(0)
        para = self.config
        basic_lane = self.positive_basic_lane
        lane_num = self.positive_lane_num
        center = self.center_line_override or LINE_CONTINUOUS
        side = self.side_line_override or LINE_SIDE

        start_node = self.pre_block_socket.positive_road.end_node
        end_node = self.add_road_node()
        positive_road = Road(start_node, end_node)
        curve, straight = create_bend_straight(
            basic_lane,
            para[Parameter.length],
            para[Parameter.radius],
            math.radians(para[Parameter.angle]),
            bool(para[Parameter.dir]),
            width=basic_lane.width,
            line_types=[LINE_BROKEN, side],
        )
        # no_cross wiring mirrors curve.py:44-90
        no_cross = create_road_from(
            curve, lane_num, positive_road, self.block_network,
            center_line_type=center, side_line_type=side, **self._cross_kwargs()
        )
        if not self.remove_negative_lanes:
            no_cross = create_adverse_road(
                positive_road, self.block_network,
                center_line_type=center, side_line_type=side, **self._cross_kwargs()
            ) and no_cross

        start_node = end_node
        end_node = self.add_road_node()
        positive_road2 = Road(start_node, end_node)
        no_cross = create_road_from(
            straight, lane_num, positive_road2, self.block_network,
            center_line_type=center, side_line_type=side, **self._cross_kwargs()
        ) and no_cross
        if not self.remove_negative_lanes:
            no_cross = create_adverse_road(
                positive_road2, self.block_network,
                center_line_type=center, side_line_type=side, **self._cross_kwargs()
            ) and no_cross

        self.add_sockets(self.create_socket_from_positive_road(positive_road2))
        return no_cross


class InterSection(PGBlock):
    """4-way intersection (reference: pgblock/intersection.py:17-260).

    Lane-count change across the intersection (change_lane_num) is forced to
    0 — matching StdInterSection, the only variant in the v2 distribution."""

    ID = "X"
    SOCKET_NUM = 3
    PARAMETER_SPACE = spaces.INTERSECTION_SPACE
    ANGLE = 90.0
    EXIT_PART_LENGTH = 35.0

    def _try_plug_into_previous_block(self):
        from collections import deque
        self.config[Parameter.change_lane_num] = 0  # Std variant semantics
        radius = self.config[Parameter.radius]
        attach_road = self.pre_block_socket.positive_road
        _attach_road = self.pre_block_socket.negative_road
        attach_lanes = attach_road.get_lanes(self.global_network)
        if not isinstance(attach_lanes[0], HostStraightLane):
            return False  # can't create an intersection following an arc
        intersect_nodes = deque(
            [self.road_node(0, 0), self.road_node(1, 0), self.road_node(2, 0), _attach_road.start_node]
        )
        lane_num = self.positive_lane_num
        no_cross = True  # wiring mirrors intersection.py:64-100
        for i in range(4):
            right_lane, success = self._create_part(
                attach_lanes, attach_road, radius, intersect_nodes, i
            )
            no_cross = no_cross and success
            if right_lane is None:
                return False
            if i != 3:
                exit_road = Road(self.road_node(i, 0), self.road_node(i, 1))
                no_cross = create_road_from(
                    right_lane, lane_num, exit_road, self.block_network,
                    **self._cross_kwargs()
                ) and no_cross
                no_cross = create_adverse_road(
                    exit_road, self.block_network, **self._cross_kwargs()
                ) and no_cross
                socket = PGBlockSocket(exit_road, -exit_road)
                self.add_respawn_roads(socket.negative_road)
                self.add_sockets(socket)
                attach_road = -exit_road
                attach_lanes = attach_road.get_lanes(self.block_network)
        return no_cross

    def _create_part(self, attach_lanes, attach_road, radius, intersect_nodes, part_idx):
        lane_num = self.positive_lane_num
        width = self.lane_width
        attach_left_lane = attach_lanes[0]
        if not isinstance(attach_left_lane, HostStraightLane):
            return None, False

        # left-turn connector (intersection.py:167-230, diff==0 branch);
        # its create-road verdict is DROPPED by the reference (:210-222)
        exit_part_length = self.config.get("exit_part_length", self.EXIT_PART_LENGTH)
        left_turn_radius = radius + lane_num * width
        left_bend, _ = create_bend_straight(
            attach_left_lane, exit_part_length, left_turn_radius,
            math.radians(self.ANGLE), False, width, [LINE_NONE, LINE_NONE]
        )
        create_road_from(
            left_bend, lane_num, Road(attach_road.end_node, intersect_nodes[2]),
            self.block_network, toward_smaller_lane_index=False,
            center_line_type=LINE_NONE, side_line_type=LINE_NONE, inner_line_type=LINE_NONE,
            **self._cross_kwargs()
        )

        # u-turn connector (intersection.py:112-115, 223-248): a 180-degree
        # bend of radius lane_width/2 from the arm's leftmost lane onto the
        # arm's OWN adverse road. Off by default; the MARL intersection map
        # enables it for lane_num > 1 (marl_intersection.py:61-65) via the
        # custom_blocks "u_turn" spec key.
        if getattr(self, "_enable_u_turn", False):
            lanes_u = (attach_road.get_lanes(self.block_network)
                       if part_idx != 0 else
                       self.pre_block_socket.get_positive_lanes(self.global_network))
            u_left = lanes_u[0]
            u_bend, _ = create_bend_straight(
                u_left, 0.1, width / 2, math.radians(180), False,
                u_left.width, [LINE_NONE, LINE_NONE],
            )
            create_road_from(
                u_bend, len(lanes_u),
                Road(attach_road.end_node, (-attach_road).start_node),
                self.block_network, toward_smaller_lane_index=False,
                center_line_type=LINE_NONE, side_line_type=LINE_NONE,
                inner_line_type=LINE_NONE, **self._cross_kwargs()
            )

        # straight-through lanes (intersection.py:118-127)
        straight_len = 2 * radius + (2 * lane_num - 1) * width
        for l in attach_lanes:
            nxt = extend_straight_lane(l, straight_len, [LINE_NONE, LINE_NONE])
            self.block_network.add_lane(attach_road.end_node, intersect_nodes[1], nxt)

        # right-turn connector + exit straight (intersection.py:129-160):
        # only the explicit right_bend sample test (positive=1) feeds the
        # part's verdict (:136-141); the create-road result is dropped
        right_turn_lane = attach_lanes[-1]
        right_bend, right_straight = create_bend_straight(
            right_turn_lane, exit_part_length, radius,
            math.radians(self.ANGLE), True, width, [LINE_NONE, LINE_SIDE]
        )
        non_cross = self._check_lane(right_bend, 1)
        create_road_from(
            right_bend, lane_num, Road(attach_road.end_node, intersect_nodes[0]),
            self.block_network, toward_smaller_lane_index=True,
            side_line_type=LINE_SIDE, inner_line_type=LINE_NONE, center_line_type=LINE_NONE,
            **self._cross_kwargs()
        )
        intersect_nodes.rotate(-1)
        right_straight.line_types = [LINE_BROKEN, LINE_SIDE]
        return right_straight, non_cross

    def get_socket(self, index):
        socket = super().get_socket(index)
        if socket.negative_road in self._respawn_roads:
            self._respawn_roads.remove(socket.negative_road)
        return socket

    def get_intermediate_spawn_lanes(self):
        """No traffic inside the intersection box (intersection.py:256-259)."""
        return self.get_respawn_lanes()


class StdInterSection(InterSection):
    """reference: pgblock/std_intersection.py (change_lane_num forced to 0)."""


class TInterSection(InterSection):
    """T-intersection: an X with one arm removed
    (reference: pgblock/t_intersection.py)."""

    ID = "T"
    SOCKET_NUM = 2
    PARAMETER_SPACE = spaces.T_INTERSECTION_SPACE

    GOAL_RIGHT, GOAL_STRAIGHT, GOAL_LEFT, GOAL_ADVERSE = 0, 1, 2, 3

    def _try_plug_into_previous_block(self):
        ok = super()._try_plug_into_previous_block()
        if not ok:
            return False
        self._exclude_lanes()
        return True

    def _exclude_lanes(self):
        # (t_intersection.py:57-88) remove the t_type arm and every
        # connector into/out of it
        t_type = self.config[Parameter.t_intersection_type]
        sockets = self.get_socket_list()  # 0,1,2 from the X loop
        all_sockets = sockets + [self.pre_block_socket]
        kept = all_sockets[t_type]
        start_node = kept.negative_road.end_node if t_type != self.GOAL_ADVERSE \
            else kept.positive_road.end_node
        end_node = kept.positive_road.start_node if t_type != self.GOAL_ADVERSE \
            else kept.negative_road.start_node
        for i in range(4):
            if i == t_type:
                continue
            s = all_sockets[i]
            exit_node = s.positive_road.start_node if i != self.GOAL_ADVERSE \
                else s.negative_road.start_node
            entry_node = s.negative_road.end_node if i != self.GOAL_ADVERSE \
                else s.positive_road.end_node
            self.block_network.remove_all_roads(start_node, exit_node)
            self.block_network.remove_all_roads(entry_node, end_node)
        # drop the removed socket and its arm roads
        removed = self._sockets.pop(t_type)
        self.block_network.remove_all_roads(
            removed.positive_road.start_node, removed.positive_road.end_node
        )
        self.block_network.remove_all_roads(
            removed.negative_road.start_node, removed.negative_road.end_node
        )
        if removed.negative_road in self._respawn_roads:
            self._respawn_roads.remove(removed.negative_road)
        # re-index remaining sockets 0..1
        remaining = list(self._sockets.values())
        self._sockets = OrderedDict()
        self.add_sockets(*remaining)


class StdTInterSection(TInterSection):
    """reference: pgblock/std_t_intersection.py."""


class Roundabout(PGBlock):
    """4-exit roundabout (reference: pgblock/roundabout.py:12-196)."""

    ID = "O"
    SOCKET_NUM = 3
    PARAMETER_SPACE = spaces.ROUNDABOUT_SPACE
    EXIT_PART_LENGTH = 35.0

    def _try_plug_into_previous_block(self):
        self._spawn_segments = []
        attach_road = self.pre_block_socket.positive_road
        if not isinstance(attach_road.get_lanes(self.global_network)[0], HostStraightLane):
            return False
        no_cross = True  # wiring mirrors roundabout.py:30-46
        for i in range(4):
            exit_road, success = self._create_circular_part(
                attach_road, i,
                self.config[Parameter.radius_exit], self.config[Parameter.radius_inner],
                self.config[Parameter.angle],
            )
            no_cross = no_cross and success
            if i < 3:
                no_cross = create_adverse_road(
                    exit_road, self.block_network, **self._cross_kwargs()
                ) and no_cross
                attach_road = -exit_road
        self.add_respawn_roads([s.negative_road for s in self.get_socket_list()])
        return no_cross

    def _create_circular_part(self, road, part_idx, radius_exit, radius_inner, angle):
        self.set_part_idx(part_idx)
        lane_num = self.positive_lane_num
        width = self.lane_width
        radius_big = (lane_num * 2 - 1) * width + radius_inner

        # entry curve into the ring (roundabout.py:58-83)
        seg_start = road.end_node
        seg_end = self.add_road_node()  # node 0
        lanes = road.get_lanes(self.global_network if part_idx == 0 else self.block_network)
        right_lane = lanes[-1]
        bend, straight = create_bend_straight(
            right_lane, 10.0, radius_exit, math.radians(angle), True, width, [LINE_BROKEN, LINE_SIDE]
        )
        # the entry ignores the PREVIOUS part's entry road — quirk preserved:
        # the reference builds the ignore pair from the same node twice
        # (roundabout.py:66-67), so the ignore never matches a real road
        ignore_node = self.road_node((part_idx + 3) % 4, 0)
        none_cross = create_road_from(
            bend, lane_num, Road(seg_start, seg_end), self.block_network,
            ignore_start=ignore_node, ignore_end=ignore_node, **self._cross_kwargs()
        )
        for k, lane in enumerate(Road(seg_start, seg_end).get_lanes(self.block_network)):
            lane.line_types = [LINE_NONE, LINE_SIDE] if k == lane_num - 1 else [LINE_NONE, LINE_NONE]

        # ring segment (roundabout.py:85-108)
        tool = HostStraightLane(straight.position(-5, 0), straight.position(0, 0), width)
        bend2, straight_next = create_bend_straight(
            tool, 10.0, radius_big, math.radians(2 * angle - 90), False, width, [LINE_BROKEN, LINE_SIDE]
        )
        seg_start, seg_end = seg_end, self.add_road_node()  # node 1
        none_cross = create_road_from(
            bend2, lane_num, Road(seg_start, seg_end), self.block_network,
            **self._cross_kwargs()
        ) and none_cross
        self._spawn_segments.append(Road(seg_start, seg_end).get_lanes(self.block_network))

        # exit curve off the ring (roundabout.py:110-133); the MARL
        # roundabout map sets Roundabout.EXIT_PART_LENGTH = exit_length
        # (marl_inout_roundabout.py:46) — honored here per-instance via the
        # "exit_part_length" config key, like InterSection
        tool = HostStraightLane(straight_next.position(-5, 0), straight_next.position(0, 0), width)
        bend3, straight3 = create_bend_straight(
            tool, self.config.get("exit_part_length", self.EXIT_PART_LENGTH),
            radius_exit, math.radians(angle), True, width,
            [LINE_BROKEN, LINE_SIDE]
        )
        seg_start = seg_end
        seg_end = self.add_road_node() if part_idx < 3 else self.pre_block_socket.negative_road.start_node  # node 2
        none_cross = create_road_from(
            bend3, lane_num, Road(seg_start, seg_end), self.block_network,
            **self._cross_kwargs()
        ) and none_cross
        for k, lane in enumerate(Road(seg_start, seg_end).get_lanes(self.block_network)):
            lane.line_types = [LINE_NONE, LINE_SIDE] if k == lane_num - 1 else [LINE_NONE, LINE_NONE]

        # exit straight + socket (roundabout.py:135-149)
        exit_start, exit_end = seg_end, self.add_road_node()  # node 3
        if part_idx < 3:
            exit_road = Road(exit_start, exit_end)
            none_cross = create_road_from(
                straight3, lane_num, exit_road, self.block_network,
                **self._cross_kwargs()
            ) and none_cross
            self.add_sockets(self.create_socket_from_positive_road(exit_road))

        # closing ring arc to the next part's entry (roundabout.py:151-177)
        seg_road = Road(self.road_node(part_idx, 1), self.road_node((part_idx + 1) % 4, 0))
        tool = HostStraightLane(straight_next.position(-6, 0), straight_next.position(0, 0), width)
        beneath = (lane_num * 2 - 1) * width / 2 + radius_exit
        radius_this = beneath / math.cos(math.radians(angle)) - radius_exit
        bend4, _ = create_bend_straight(
            tool, 5.0, radius_this, math.radians(180 - 2 * angle), False, width, [LINE_BROKEN, LINE_SIDE]
        )
        # closing-arc verdict is dropped by the reference (roundabout.py:172)
        create_road_from(bend4, lane_num, seg_road, self.block_network,
                         **self._cross_kwargs())
        for k, lane in enumerate(seg_road.get_lanes(self.block_network)):
            if k == 0:
                lane.line_types = [LINE_CONTINUOUS, LINE_BROKEN if lane_num > 1 else LINE_NONE]
            else:
                lane.line_types = [LINE_BROKEN, LINE_BROKEN]
        return Road(exit_start, exit_end), none_cross

    def get_socket(self, index):
        socket = super().get_socket(index)
        if socket.negative_road in self._respawn_roads:
            self._respawn_roads.remove(socket.negative_road)
        return socket

    def get_intermediate_spawn_lanes(self):
        return self.get_respawn_lanes() + self._spawn_segments


class Ramp(PGBlock):
    """Common ramp constants (reference: pgblock/ramp.py:14-36)."""

    PARAMETER_SPACE = spaces.RAMP_SPACE
    RADIUS = 40.0
    ANGLE = 10.0
    LANE_TYPE = [LINE_CONTINUOUS, LINE_CONTINUOUS]
    SPEED_LIMIT = 12.0
    CONNECT_PART_LEN = 20.0
    RAMP_LEN = 15.0


class InRampOnStraight(Ramp):
    """On-ramp merging into a straight road
    (reference: pgblock/ramp.py:38-216)."""

    ID = "r"
    EXTRA_PART = 10.0
    SOCKET_LEN = 20.0

    def _try_plug_into_previous_block(self):
        acc_lane_len = self.config[Parameter.length]
        if not isinstance(self.positive_basic_lane, HostStraightLane):
            return False
        width = self.lane_width
        lane_num = self.positive_lane_num

        self.set_part_idx(0)
        sin_a, cos_a = math.sin(math.radians(self.ANGLE)), math.cos(math.radians(self.ANGLE))
        longitude_len = sin_a * self.RADIUS * 2 + cos_a * self.CONNECT_PART_LEN + self.RAMP_LEN

        extend_lane = extend_straight_lane(
            self.positive_basic_lane, longitude_len + self.EXTRA_PART, [LINE_BROKEN, LINE_CONTINUOUS]
        )
        extend_road = Road(self.pre_block_socket.positive_road.end_node, self.add_road_node())
        # no_cross wiring mirrors ramp.py:44-97
        no_cross = create_road_from(
            extend_lane, lane_num, extend_road, self.block_network,
            side_line_type=LINE_CONTINUOUS, **self._cross_kwargs()
        )
        extend_road.get_lanes(self.block_network)[-1].line_types = [
            LINE_BROKEN if lane_num != 1 else LINE_CONTINUOUS, LINE_CONTINUOUS
        ]
        no_cross = create_adverse_road(
            extend_road, self.block_network, **self._cross_kwargs()
        ) and no_cross
        (-extend_road).get_lanes(self.block_network)[-1].line_types = [
            LINE_NONE if lane_num == 1 else LINE_BROKEN, LINE_SIDE
        ]

        # acceleration-lane section
        acc_side_lane = extend_straight_lane(
            extend_lane, acc_lane_len + width, [extend_lane.line_types[0], LINE_SIDE]
        )
        acc_road = Road(extend_road.end_node, self.add_road_node())
        no_cross = create_road_from(
            acc_side_lane, lane_num, acc_road, self.block_network,
            side_line_type=LINE_CONTINUOUS, **self._cross_kwargs()
        ) and no_cross
        no_cross = create_adverse_road(
            acc_road, self.block_network, **self._cross_kwargs()
        ) and no_cross
        acc_road.get_lanes(self.block_network)[-1].line_types = [
            LINE_CONTINUOUS if lane_num == 1 else LINE_BROKEN, LINE_BROKEN
        ]

        # socket section
        socket_side_lane = extend_straight_lane(acc_side_lane, self.SOCKET_LEN, acc_side_lane.line_types)
        socket_road = Road(acc_road.end_node, self.add_road_node())
        no_cross = create_road_from(
            socket_side_lane, lane_num, socket_road, self.block_network,
            side_line_type=LINE_CONTINUOUS, **self._cross_kwargs()
        ) and no_cross
        no_cross = create_adverse_road(
            socket_road, self.block_network, **self._cross_kwargs()
        ) and no_cross
        self.add_sockets(self.create_socket_from_positive_road(socket_road))

        # the ramp itself (part 1): straight entry, two bends, acc lane
        self.set_part_idx(1)
        lateral_dist = (1 - cos_a) * self.RADIUS * 2 + sin_a * self.CONNECT_PART_LEN
        start_point = extend_lane.position(self.EXTRA_PART, lateral_dist + width)
        end_point = extend_lane.position(self.EXTRA_PART + self.RAMP_LEN, lateral_dist + width)
        straight_part = HostStraightLane(start_point, end_point, width, list(self.LANE_TYPE),
                                         speed_limit=self.SPEED_LIMIT)
        straight_road = Road(self.add_road_node(), self.add_road_node())
        self.block_network.add_lane(straight_road.start_node, straight_road.end_node, straight_part)
        no_cross = self._check_lane(straight_part, 0.95) and no_cross  # ramp.py:131-138
        self.add_respawn_roads(straight_road)

        bend_1, connect_part = create_bend_straight(
            straight_part, self.CONNECT_PART_LEN, self.RADIUS, math.radians(self.ANGLE),
            False, width, list(self.LANE_TYPE)
        )
        bend_1_road = Road(straight_road.end_node, self.add_road_node())
        connect_road = Road(bend_1_road.end_node, self.add_road_node())
        self.block_network.add_lane(bend_1_road.start_node, bend_1_road.end_node, bend_1)
        self.block_network.add_lane(connect_road.start_node, connect_road.end_node, connect_part)
        no_cross = self._check_lane(bend_1, 0.95) and no_cross       # ramp.py:156-160
        no_cross = self._check_lane(connect_part, 0.95) and no_cross  # ramp.py:161-168

        bend_2, acc_lane = create_bend_straight(
            connect_part, acc_lane_len, self.RADIUS, math.radians(self.ANGLE),
            True, width, list(self.LANE_TYPE)
        )
        acc_lane.line_types = [LINE_BROKEN, LINE_CONTINUOUS]
        bend_2_road = Road(connect_road.end_node, self.road_node(0, 0))
        self.block_network.add_lane(bend_2_road.start_node, bend_2_road.end_node, bend_2)
        # merge lane rides alongside the acc section as an extra right lane
        self.block_network.add_lane(acc_road.start_node, acc_road.end_node, acc_lane)
        no_cross = self._check_lane(bend_2, 0.95) and no_cross       # ramp.py:185-189
        no_cross = self._check_lane(acc_lane, 0.95) and no_cross     # ramp.py:190-194
        # decorative quarter-circle merge tip on the Decoration road
        # (ramp.py:196-201) — real world geometry in the reference, skipped
        # by the overlap check (utils/pg/utils.py:56)
        from benchmarks.reference.mapgen.overlap import DECORATION_END, DECORATION_START
        merge_lane, _ = create_bend_straight(
            acc_lane, 10, width / 2, math.pi / 2, False, width,
            [LINE_BROKEN, LINE_CONTINUOUS]
        )
        self.block_network.add_lane(DECORATION_START, DECORATION_END, merge_lane)
        return no_cross

    def get_intermediate_spawn_lanes(self):
        """Exclude the socket road (ramp.py:203-216)."""
        socket_lanes = self.get_socket_list()[0].get_positive_lanes(self.block_network)
        return [
            lanes for lanes in super().get_intermediate_spawn_lanes()
            if socket_lanes[0] not in lanes
        ]


class OutRampOnStraight(Ramp):
    """Off-ramp leaving a straight road (reference: pgblock/ramp.py:219-346)."""

    ID = "R"
    EXTRA_LEN = 15.0

    def _try_plug_into_previous_block(self):
        if not isinstance(self.positive_basic_lane, HostStraightLane):
            return False
        width = self.lane_width
        lane_num = self.positive_lane_num
        sin_a, cos_a = math.sin(math.radians(self.ANGLE)), math.cos(math.radians(self.ANGLE))
        longitude_len = sin_a * self.RADIUS * 2 + cos_a * self.CONNECT_PART_LEN + self.RAMP_LEN + self.EXTRA_LEN

        self.set_part_idx(0)
        dec_lane_len = self.config[Parameter.length]
        dec_lane = extend_straight_lane(
            self.positive_basic_lane, dec_lane_len + width,
            [self.positive_basic_lane.line_types[0], LINE_SIDE]
        )
        dec_road = Road(self.pre_block_socket.positive_road.end_node, self.add_road_node())
        # no_cross wiring mirrors ramp.py:245-296
        no_cross = create_road_from(
            dec_lane, lane_num, dec_road, self.block_network,
            side_line_type=LINE_CONTINUOUS, **self._cross_kwargs()
        )
        no_cross = create_adverse_road(
            dec_road, self.block_network, **self._cross_kwargs()
        ) and no_cross
        dec_right_lane = dec_road.get_lanes(self.block_network)[-1]
        dec_right_lane.line_types = [
            LINE_CONTINUOUS if lane_num == 1 else LINE_BROKEN, LINE_BROKEN
        ]

        extend_lane = extend_straight_lane(
            dec_right_lane, longitude_len, [dec_right_lane.line_types[0], LINE_CONTINUOUS]
        )
        extend_road = Road(dec_road.end_node, self.add_road_node())
        no_cross = create_road_from(
            extend_lane, lane_num, extend_road, self.block_network,
            side_line_type=LINE_CONTINUOUS, **self._cross_kwargs()
        ) and no_cross
        no_cross = create_adverse_road(
            extend_road, self.block_network, **self._cross_kwargs()
        ) and no_cross
        (-extend_road).get_lanes(self.block_network)[-1].line_types = [
            LINE_NONE if lane_num == 1 else LINE_BROKEN, LINE_SIDE
        ]
        self.add_sockets(self.create_socket_from_positive_road(extend_road))

        # deceleration side lane + off-ramp (part 1, ramp.py:303-374)
        self.set_part_idx(1)
        dec_side_lane = HostStraightLane(
            dec_right_lane.position(width, width),
            dec_right_lane.position(dec_right_lane.length, width),
            width, [LINE_BROKEN, LINE_CONTINUOUS]
        )
        self.block_network.add_lane(dec_road.start_node, dec_road.end_node, dec_side_lane)
        no_cross = self._check_lane(dec_side_lane, 0.95) and no_cross

        bend_1, connect_part = create_bend_straight(
            dec_side_lane, self.CONNECT_PART_LEN, self.RADIUS, math.radians(self.ANGLE),
            True, width, list(self.LANE_TYPE)
        )
        bend_1_road = Road(dec_road.end_node, self.add_road_node())
        connect_road = Road(bend_1_road.end_node, self.add_road_node())
        self.block_network.add_lane(bend_1_road.start_node, bend_1_road.end_node, bend_1)
        self.block_network.add_lane(connect_road.start_node, connect_road.end_node, connect_part)
        no_cross = self._check_lane(bend_1, 0.95) and no_cross
        no_cross = self._check_lane(connect_part, 0.95) and no_cross

        bend_2, straight_part = create_bend_straight(
            connect_part, self.RAMP_LEN, self.RADIUS, math.radians(self.ANGLE),
            False, width, list(self.LANE_TYPE)
        )
        bend_2_road = Road(connect_road.end_node, self.add_road_node())
        straight_road = Road(bend_2_road.end_node, self.add_road_node())
        self.block_network.add_lane(bend_2_road.start_node, bend_2_road.end_node, bend_2)
        self.block_network.add_lane(straight_road.start_node, straight_road.end_node, straight_part)
        no_cross = self._check_lane(bend_2, 0.95) and no_cross
        no_cross = self._check_lane(straight_part, 0.95) and no_cross
        # decoration merge tip off the reversed dec side lane
        # (ramp.py:231-242 _get_merge_part + :372-373)
        from benchmarks.reference.mapgen.overlap import DECORATION_END, DECORATION_START
        tool_lane = HostStraightLane(dec_side_lane.end, dec_side_lane.start, width)
        decoration_part, _ = create_bend_straight(
            tool_lane, 10, width / 2, math.pi / 2, True, width,
            [LINE_CONTINUOUS, LINE_BROKEN]
        )
        self.block_network.add_lane(DECORATION_START, DECORATION_END, decoration_part)
        return no_cross




class Bottleneck(PGBlock):
    """Lane-count change via S-curve transitions
    (reference: pgblock/bottleneck.py:10-30)."""

    PARAMETER_SPACE = {
        Parameter.length: spaces.BoxSpace(20.0, 50.0),
        Parameter.lane_num: spaces.DiscreteSpace(1, 2),
        "bottle_len": spaces.ConstantSpace(20.0),
        "solid_center_line": spaces.ConstantSpace(0),
    }

    def get_intermediate_spawn_lanes(self):
        return [
            lanes for lanes in super().get_intermediate_spawn_lanes()
            if isinstance(lanes[0], HostStraightLane)
        ]


class Merge(Bottleneck):
    """In-bottleneck: lane count decreases (reference: bottleneck.py:33-175)."""

    ID = "y"

    def _try_plug_into_previous_block(self):
        para = self.config
        if not isinstance(self.positive_basic_lane, HostStraightLane):
            return False
        center_line_type = LINE_CONTINUOUS if para["solid_center_line"] else LINE_BROKEN
        bottle_len = para["bottle_len"]
        straight_num = max(1, self.positive_lane_num - para[Parameter.lane_num])
        circular_num = self.positive_lane_num - straight_num
        start_node = self.pre_block_socket.positive_road.end_node

        basic = self.positive_lanes[straight_num - 1]
        ref_lane = extend_straight_lane(basic, bottle_len, [LINE_NONE, LINE_NONE])
        straight_road = Road(start_node, self.road_node(0, 0))
        # no_cross wiring mirrors bottleneck.py:46-174
        no_cross = create_road_from(
            ref_lane, straight_num, straight_road, self.block_network,
            center_line_type=center_line_type,
            side_line_type=LINE_SIDE if circular_num == 0 else LINE_NONE,
            inner_line_type=LINE_NONE, **self._cross_kwargs())
        no_cross = create_adverse_road(
            straight_road, self.block_network,
            center_line_type=center_line_type,
            side_line_type=LINE_SIDE if circular_num == 0 else LINE_NONE,
            inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross

        ref_lane = extend_straight_lane(ref_lane, para[Parameter.length], [LINE_NONE, LINE_NONE])
        socket_road = Road(self.road_node(0, 0), self.road_node(0, 1))
        no_cross = create_road_from(
            ref_lane, straight_num, socket_road, self.block_network,
            center_line_type=center_line_type, **self._cross_kwargs()) and no_cross
        no_cross = create_adverse_road(
            socket_road, self.block_network, center_line_type=center_line_type,
            **self._cross_kwargs()) and no_cross
        self.add_sockets(PGBlockSocket(socket_road, -socket_road))

        # merging side lanes: S-curves from the outer lanes into road_node(0,0)
        for index, lane in enumerate(self.positive_lanes[straight_num:], 1):
            lateral_dist = index * self.lane_width / 2
            inner = self.road_node(1, index)
            side = LINE_SIDE if index == circular_num else LINE_NONE
            c1, c2, _ = create_wave_lanes(lane, lateral_dist, bottle_len, 5.0, self.lane_width)
            no_cross = create_road_from(
                c1, 1, Road(start_node, inner), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross
            no_cross = create_road_from(
                c2, 1, Road(inner, self.road_node(0, 0)), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross
            neg_lane = (-socket_road).get_lanes(self.block_network)[-1]
            c2b, c1b, _ = create_wave_lanes(neg_lane, lateral_dist, bottle_len, 5.0,
                                            self.lane_width, False)
            no_cross = create_road_from(
                c2b, 1, -Road(inner, self.road_node(0, 0)), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross
            no_cross = create_road_from(
                c1b, 1, -Road(start_node, inner), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross
        return no_cross


class Split(Bottleneck):
    """Out-bottleneck: lane count increases (reference: bottleneck.py:177-330)."""

    ID = "Y"

    def _try_plug_into_previous_block(self):
        para = self.config
        if not isinstance(self.positive_basic_lane, HostStraightLane):
            return False
        center_line_type = LINE_CONTINUOUS if para["solid_center_line"] else LINE_BROKEN
        bottle_len = para["bottle_len"]
        straight_num = self.positive_lane_num
        circular_num = para[Parameter.lane_num]
        total_num = straight_num + circular_num
        start_node = self.pre_block_socket.positive_road.end_node

        basic = self.positive_lanes[straight_num - 1]
        ref_lane = extend_straight_lane(basic, bottle_len, [LINE_NONE, LINE_NONE])
        straight_road = Road(start_node, self.road_node(0, 0))
        # no_cross wiring mirrors bottleneck.py:190-325
        no_cross = create_road_from(
            ref_lane, straight_num, straight_road, self.block_network,
            center_line_type=center_line_type, side_line_type=LINE_NONE,
            inner_line_type=LINE_NONE, **self._cross_kwargs())
        no_cross = create_adverse_road(
            straight_road, self.block_network,
            center_line_type=center_line_type, side_line_type=LINE_NONE,
            inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross

        # diverging side lanes out of start_node
        lane = self.positive_lanes[-1]
        socket_ref = None
        for index in range(1, circular_num + 1):
            lateral_dist = index * self.lane_width / 2
            inner = self.road_node(1, index)
            side = LINE_SIDE if index == circular_num else LINE_NONE
            c1, c2, straight = create_wave_lanes(
                lane, lateral_dist, bottle_len, para[Parameter.length], self.lane_width, False
            )
            if index == circular_num:
                socket_ref = straight
            no_cross = create_road_from(
                c1, 1, Road(start_node, inner), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross
            no_cross = create_road_from(
                c2, 1, Road(inner, self.road_node(0, 0)), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross

        socket_road = Road(self.road_node(0, 0), self.road_node(0, 1))
        no_cross = create_road_from(
            socket_ref, total_num, socket_road, self.block_network,
            **self._cross_kwargs()) and no_cross
        no_cross = create_adverse_road(
            socket_road, self.block_network, **self._cross_kwargs()) and no_cross
        self.add_sockets(PGBlockSocket(socket_road, -socket_road))

        # adverse merging lanes back toward the previous block
        lanes = (-socket_road).get_lanes(self.block_network)
        for index, lane in enumerate(lanes[straight_num:], 1):
            lateral_dist = index * self.lane_width / 2
            inner = self.road_node(1, index)
            side = LINE_SIDE if index == circular_num else LINE_NONE
            c1, c2, _ = create_wave_lanes(lane, lateral_dist, bottle_len, 5.0, self.lane_width)
            no_cross = create_road_from(
                c1, 1, -Road(inner, self.road_node(0, 0)), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross
            no_cross = create_road_from(
                c2, 1, -Road(start_node, inner), self.block_network,
                center_line_type=LINE_NONE, side_line_type=side,
                inner_line_type=LINE_NONE, **self._cross_kwargs()) and no_cross
        return no_cross


class Bidirection(PGBlock):
    """Single shared lane with opposing traffic (reference:
    pgblock/bidirection.py:73-119; the overlap adverse road reuses the same
    physical span)."""

    ID = "B"
    PARAMETER_SPACE = {Parameter.length: spaces.BoxSpace(40.0, 80.0)}

    def _try_plug_into_previous_block(self):
        self.set_part_idx(0)
        para = self.config
        basic = self.positive_lanes[0]
        if not isinstance(basic, HostStraightLane):
            return False
        length = para[Parameter.length]
        start_position = basic.position(basic.length, -basic.width / 2)
        end_position = basic.position(basic.length + length, -basic.width / 2)
        new_lane = HostStraightLane(start_position, end_position, basic.width,
                                    [LINE_BROKEN, LINE_SIDE])
        start = self.pre_block_socket.positive_road.end_node
        end = self.add_road_node()
        socket = Road(start, end)
        # no_cross wiring mirrors bidirection.py:99-116
        no_cross = create_road_from(
            new_lane, 1, socket, self.block_network, **self._cross_kwargs())
        # the adverse road overlaps the same physical lane
        # (create_overlap_road, bidirection.py:18-56)
        overlap = HostStraightLane(end_position, start_position, basic.width,
                                   [LINE_BROKEN, LINE_SIDE])
        no_cross = create_road_from(
            overlap, 1, -socket, self.block_network, **self._cross_kwargs()
        ) and no_cross
        self.add_sockets(PGBlockSocket(socket, -socket))
        return no_cross


class TollGate(PGBlock):
    """Toll plaza: a straight with continuous lines, a 3 m/s speed limit and
    booth buildings occupying every odd lane (reference: pgblock/tollgate.py
    + buildings/tollgate_building.py). Buildings are recorded on
    ``self.buildings`` as (lane, longitude, length, width) and become static
    box obstacles in the compiled scene (crash_building flag)."""

    ID = "$"
    PARAMETER_SPACE = {Parameter.length: spaces.ConstantSpace(20.0)}
    SPEED_LIMIT = 3.0  # m/s (tollgate.py:19)
    BUILDING_LENGTH = 10.0  # tollgate_building.py:8

    def _try_plug_into_previous_block(self):
        self.set_part_idx(0)
        self.buildings = []
        length = self.config[Parameter.length]
        basic_lane = self.positive_basic_lane
        new_lane = extend_straight_lane(basic_lane, length, [LINE_CONTINUOUS, LINE_SIDE])
        start = self.pre_block_socket.positive_road.end_node
        end = self.add_road_node()
        socket = Road(start, end)
        no_cross = create_road_from(
            new_lane, self.positive_lane_num, socket, self.block_network,
            center_line_type=LINE_CONTINUOUS, inner_line_type=LINE_CONTINUOUS,
            side_line_type=LINE_SIDE, **self._cross_kwargs()
        )
        no_cross = create_adverse_road(
            socket, self.block_network,
            center_line_type=LINE_CONTINUOUS, inner_line_type=LINE_CONTINUOUS,
            side_line_type=LINE_SIDE, **self._cross_kwargs()
        ) and no_cross
        self.add_sockets(PGBlockSocket(socket, -socket))
        self._add_building_and_speed_limit(socket)
        self._add_building_and_speed_limit(-socket)
        return no_cross

    def _add_building_and_speed_limit(self, road):
        # booth on every odd lane (tollgate.py:64-75)
        lanes = road.get_lanes(self.block_network)
        for idx, lane in enumerate(lanes):
            lane.speed_limit = self.SPEED_LIMIT
            if idx % 2 == 1:
                self.buildings.append(
                    (lane, lane.length / 2, self.BUILDING_LENGTH, lane.width)
                )


class ParkingLot(PGBlock):
    """Parking lot: a 1-lane two-way main aisle with 2N right-angle parking
    spaces, N on each side (reference: pgblock/parking_lot.py:13-333).

    Each space k (part index 1..2N) is a small road graph:
      node(k,1)->(k,2)  in-direction parking space (a destination)
      node(k,5)->(k,6)  the SAME physical span reversed (two-way road;
                        spawn road for vehicles leaving the lot)
    plus 90-degree entry/exit bends connecting both main-aisle directions.
    """

    ID = "P"
    ANGLE = math.radians(90.0)
    SOCKET_LENGTH = 4.0
    PARAMETER_SPACE = {
        Parameter.one_side_vehicle_num: spaces.DiscreteSpace(2, 10),
        Parameter.radius: spaces.ConstantSpace(4.0),
        Parameter.length: spaces.ConstantSpace(8.0),
    }

    def _lanes_of(self, road):
        """Lanes of a road living in either the block or global network."""
        try:
            return road.get_lanes(self.block_network)
        except KeyError:
            return road.get_lanes(self.global_network)

    def _try_plug_into_previous_block(self):
        self.spawn_roads = []
        self.dest_roads = []
        para = self.config
        assert self.positive_lane_num == 1, \
            "Lane number of previous block must be 1 in each direction"
        self.parking_space_length = para[Parameter.length]
        self.parking_space_width = self.lane_width
        n = int(para[Parameter.one_side_vehicle_num])
        radius = para[Parameter.radius]

        # main aisle (parking_lot.py:38-66): broken grey center, no side line
        main_len = 2 * radius + (n - 1) * self.parking_space_width
        main_lane = extend_straight_lane(
            self.positive_lanes[0], main_len, [LINE_BROKEN, LINE_NONE]
        )
        road = Road(self.pre_block_socket.positive_road.end_node, self.road_node(0, 0))
        # counted aisle/socket checks mirror parking_lot.py:45-93; the
        # per-space conditional checks (:116-333) are NOT replicated — the
        # space graph here is a simplified twin and ParkingLot is absent
        # from the BIG v2 sampling distribution (blocks_prob_dist.py:22-41),
        # so rejection parity cannot affect sampled maps
        no_cross = create_road_from(
            main_lane, 1, road, self.block_network,
            center_line_type=LINE_BROKEN, inner_line_type=LINE_BROKEN,
            side_line_type=LINE_NONE, center_line_color=LINE_COLOR_GREY,
            **self._cross_kwargs()
        )
        no_cross = create_adverse_road(
            road, self.block_network,
            center_line_type=LINE_BROKEN, inner_line_type=LINE_BROKEN,
            side_line_type=LINE_NONE, center_line_color=LINE_COLOR_GREY,
            **self._cross_kwargs()
        ) and no_cross

        # out socket (parking_lot.py:68-96)
        out_lane = extend_straight_lane(main_lane, self.SOCKET_LENGTH, [LINE_BROKEN, LINE_NONE])
        out_road = Road(self.road_node(0, 0), self.road_node(0, 1))
        no_cross = create_road_from(
            out_lane, 1, out_road, self.block_network,
            center_line_type=LINE_BROKEN, inner_line_type=LINE_BROKEN,
            side_line_type=LINE_SIDE, **self._cross_kwargs()
        ) and no_cross
        no_cross = create_adverse_road(
            out_road, self.block_network,
            center_line_type=LINE_BROKEN, inner_line_type=LINE_BROKEN,
            side_line_type=LINE_SIDE, **self._cross_kwargs()
        ) and no_cross
        self._no_cross = no_cross
        socket = self.create_socket_from_positive_road(out_road)
        self.add_sockets(socket)

        # one side entered driving back from the socket, the other driving in
        # from the previous block (parking_lot.py:98-113)
        w = self.parking_space_width
        for i in range(n):
            self._add_one_parking_space(
                socket.get_socket_in_reverse(),
                self.pre_block_socket.get_socket_in_reverse(),
                i + 1, radius, i * w, (n - i - 1) * w,
            )
        for i in range(n, 2 * n):
            j = i - n
            self._add_one_parking_space(
                self.pre_block_socket, socket, i + 1, radius, j * w, (n - j - 1) * w
            )
        return self._no_cross

    def _add_one_parking_space(self, in_socket, out_socket, part_idx, radius,
                               dist_to_in, dist_to_out):
        """One space + its four connector bends (parking_lot.py:116-333)."""
        w = self.parking_space_width
        NONE = dict(center_line_type=LINE_NONE, inner_line_type=LINE_NONE,
                    side_line_type=LINE_NONE)

        # entry from in_socket: optional straight, right 90-degree bend,
        # then the space itself (in direction)
        in_lane = self._lanes_of(in_socket.positive_road)[0]
        start_node = in_socket.positive_road.end_node
        if dist_to_in > 1e-3:
            in_lane = extend_straight_lane(in_lane, dist_to_in, [LINE_NONE, LINE_NONE])
            create_road_from(
                in_lane, 1, Road(start_node, self.road_node(part_idx, 0)),
                self.block_network, **NONE,
            )
            start_node = self.road_node(part_idx, 0)
        side = LINE_SIDE if dist_to_in < 1e-3 else LINE_NONE
        bend, straight = create_bend_straight(
            in_lane, self.parking_space_length, radius, self.ANGLE, True, w
        )
        create_road_from(
            bend, 1, Road(start_node, self.road_node(part_idx, 1)),
            self.block_network, center_line_type=LINE_NONE,
            inner_line_type=LINE_NONE, side_line_type=side,
        )
        straight_road = Road(self.road_node(part_idx, 1), self.road_node(part_idx, 2))
        self.dest_roads.append(straight_road)
        create_road_from(
            straight, 1, straight_road, self.block_network,
            center_line_type=LINE_CONTINUOUS, inner_line_type=LINE_NONE,
            side_line_type=side, center_line_color=LINE_COLOR_GREY,
        )

        # entry from the out_socket direction: left 90-degree bend joining
        # the same space entrance (parking_lot.py:179-233)
        neg_lane = self._lanes_of(out_socket.negative_road)[0]
        start_node = out_socket.negative_road.end_node
        if dist_to_out > 1e-3:
            neg_lane = extend_straight_lane(neg_lane, dist_to_out, [LINE_NONE, LINE_NONE])
            create_road_from(
                neg_lane, 1, Road(start_node, self.road_node(part_idx, 3)),
                self.block_network, **NONE,
            )
            start_node = self.road_node(part_idx, 3)
        bend, straight = create_bend_straight(
            neg_lane, self.lane_width, radius, self.ANGLE, False, w
        )
        create_road_from(
            bend, 1, Road(start_node, self.road_node(part_idx, 4)),
            self.block_network, **NONE,
        )
        create_road_from(
            straight, 1, Road(self.road_node(part_idx, 4), self.road_node(part_idx, 1)),
            self.block_network, **NONE,
        )

        # the space as a two-way road: (k,5)->(k,6) reverses (k,1)->(k,2)
        parking_road = Road(self.road_node(part_idx, 5), self.road_node(part_idx, 6))
        self.spawn_roads.append(parking_road)
        create_two_way_road(
            straight_road, self.block_network, parking_road,
            center_line_type=LINE_NONE, inner_line_type=LINE_NONE,
            side_line_type=LINE_SIDE if dist_to_out < 1e-3 else LINE_NONE,
        )
        parking_lane = parking_road.get_lanes(self.block_network)[0]

        # exit 1: right bend toward out_socket (parking_lot.py:249-286)
        out_side = LINE_SIDE if dist_to_out < 1e-3 else LINE_NONE
        bend, straight = create_bend_straight(
            parking_lane, 0.1 if dist_to_out < 1e-3 else dist_to_out,
            radius, self.ANGLE, True, w
        )
        out_end = (
            self.road_node(part_idx, 7) if dist_to_out > 1e-3
            else out_socket.positive_road.start_node
        )
        create_road_from(
            bend, 1, Road(self.road_node(part_idx, 6), out_end),
            self.block_network, center_line_type=LINE_NONE,
            inner_line_type=LINE_NONE, side_line_type=out_side,
        )
        if dist_to_out > 1e-3:
            create_road_from(
                straight, 1,
                Road(self.road_node(part_idx, 7), out_socket.positive_road.start_node),
                self.block_network, **NONE,
            )

        # exit 2: short extension + left bend back toward in_socket
        # (parking_lot.py:287-331)
        ext = extend_straight_lane(parking_lane, self.lane_width, [LINE_NONE, LINE_NONE])
        create_road_from(
            ext, 1, Road(self.road_node(part_idx, 6), self.road_node(part_idx, 8)),
            self.block_network, **NONE,
        )
        bend, straight = create_bend_straight(
            ext, 0.1 if dist_to_in < 1e-3 else dist_to_in, radius, self.ANGLE, False, w
        )
        out_end = (
            self.road_node(part_idx, 9) if dist_to_in > 1e-3
            else in_socket.negative_road.start_node
        )
        create_road_from(
            bend, 1, Road(self.road_node(part_idx, 8), out_end),
            self.block_network, **NONE,
        )
        if dist_to_in > 1e-3:
            create_road_from(
                straight, 1,
                Road(self.road_node(part_idx, 9), in_socket.negative_road.start_node),
                self.block_network, **NONE,
            )

    def get_intermediate_spawn_lanes(self):
        """No background traffic inside the lot."""
        return []


class Fork(Ramp):
    """Fork base (reference: pgblock/fork.py:15-19)."""

    PARAMETER_SPACE = {
        Parameter.length: spaces.BoxSpace(20.0, 40.0),
        Parameter.lane_num: spaces.DiscreteSpace(0, 1),
    }


class InFork(Fork):
    """Disabled upstream: the reference raises
    ValueError("Bug exists in this block, Recommend to use Ramp")
    (fork.py:27-28). Kept for API parity."""

    ID = "f"

    def _try_plug_into_previous_block(self):
        raise ValueError("Bug exists in this block, Recommend to use Ramp")


class OutFork(Fork):
    """Disabled upstream, like InFork (reference: fork.py:177-178)."""

    ID = "F"

    def _try_plug_into_previous_block(self):
        raise ValueError("Bug exists in this block, Recommend to use Ramp")


# Registry used by BIG + the "map string" sugar
# (reference: blocks_prob_dist.py + pg_map.py parse_map_config).
PG_BLOCKS = {
    "S": Straight,
    "C": Curve,
    "X": StdInterSection,
    "T": StdTInterSection,
    "O": Roundabout,
    "r": InRampOnStraight,
    "R": OutRampOnStraight,
    "y": Merge,
    "Y": Split,
    "B": Bidirection,
    "$": TollGate,
    "P": ParkingLot,
    "f": InFork,
    "F": OutFork,
}

# reference: blocks_prob_dist.py:22-41 BLOCK_TYPE_DISTRIBUTION_V2
BLOCK_DIST_V2 = {
    "Curve": 0.3,
    "Straight": 0.1,
    "InRampOnStraight": 0.1,
    "OutRampOnStraight": 0.1,
    "StdInterSection": 0.15,
    "StdTInterSection": 0.15,
    "Roundabout": 0.1,
}
BLOCK_NAME_TO_CLASS = {
    "Curve": Curve,
    "Straight": Straight,
    "InRampOnStraight": InRampOnStraight,
    "OutRampOnStraight": OutRampOnStraight,
    "StdInterSection": StdInterSection,
    "StdTInterSection": StdTInterSection,
    "Roundabout": Roundabout,
}
