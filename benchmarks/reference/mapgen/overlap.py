"""Exact block-overlap rejection test for PG map construction.

Faithful port of the reference's deterministic sampling test
(metadrive/utils/pg/utils.py:37-140 ``check_lane_on_road`` /
``get_lanes_bounding_box`` and metadrive/utils/math.py:164-176
``get_points_bounding_box``): sample every integer longitude along the new
lane at the given lateral factor, and test the point on-lane against every
lane of every existing road, with a conservative per-road bounding-box
pre-filter. No RNG — the accept/reject outcome per candidate block is fully
deterministic, which is what makes whole maps reproduce the reference
seed-for-seed once the np_random stream and draw order match
(mapgen/ref_random.py + mapgen/big.py).
"""
import math

from benchmarks.reference.mapgen.lanes import HostCircularLane, HostStraightLane

# PGDrivableAreaProperty (reference constants.py:319-320); used by
# create_road_from's lateral check factor (create_pg_block_utils.py:138-141)
SIDEWALK_WIDTH = 2.0
SIDEWALK_LINE_DIST = 0.6

# Decoration road key skipped by the check (reference constants.py:93-98
# Decoration.start/end — isolated lanes not connecting any nodes)
DECORATION_START = "decoration"
DECORATION_END = "decoration_"


def get_points_bounding_box(points):
    """(x_max, x_min, y_max, y_min) of a point list (utils/math.py:164-176)."""
    x = [p[0] for p in points]
    y = [p[1] for p in points]
    return max(x), min(x), max(y), min(y)


def get_straight_contour(lanes, extra_lateral):
    """Corner points of a straight road incl. sidewalk margin
    (utils/pg/utils.py:101-113)."""
    ret = []
    for lane, direction in [(lanes[0], -1), (lanes[-1], 1)]:
        ret.append(lane.position(0.1, direction * (lane.width / 2.0 + extra_lateral)))
        ret.append(lane.position(lane.length - 0.1, direction * (lane.width / 2.0 + extra_lateral)))
    return ret


def get_curve_contour(lanes, extra_lateral):
    """Contour points of an arc road: endpoints plus every quarter-circle
    extreme the arc sweeps past (utils/pg/utils.py:115-140)."""
    points = []
    pi_2 = math.pi / 2.0
    for lane, lateral_dir in [(lanes[0], -1), (lanes[-1], 1)]:
        points += [
            lane.position(0.1, lateral_dir * (lane.width / 2.0 + extra_lateral)),
            lane.position(lane.length - 0.1, lateral_dir * (lane.width / 2.0 + extra_lateral)),
        ]
        start_phase = (lane.start_phase // pi_2) * pi_2
        start_phase += pi_2 if lane.is_clockwise() else 0
        for phi_index in range(4):
            phi = start_phase + phi_index * pi_2 * lane.direction
            if lane.direction * phi > lane.direction * lane.end_phase:
                break
            point = lane.center + (
                lane.radius - lateral_dir * (lane.width / 2.0 + extra_lateral) * lane.direction
            ) * _cos_sin(phi)
            points.append(point)
    return points


def _cos_sin(phi):
    import numpy as np
    return np.array([math.cos(phi), math.sin(phi)])


def get_lanes_bounding_box(lanes, extra_lateral=3):
    """Bounding box of one road's lane list (utils/pg/utils.py:76-89)."""
    if isinstance(lanes[0], HostCircularLane):
        points = get_curve_contour(lanes, extra_lateral)
    else:
        points = get_straight_contour(lanes, extra_lateral)
    return get_points_bounding_box(points)


def _local_coordinates_total(lane, point):
    """lane.local_coordinates, made total: the reference raises in the
    undetermined phase region of an arc (circular_lane.py:92-99);
    check_lane_on_road has NO try/except, so in the reference such a raise
    aborts map generation entirely. Here the sample counts as off-lane.

    Divergence status: VERIFIED EMPTY (round 4). Instrumented sweeps of the
    reference's own stack (tools/ref_map_oracle.py --watch-raise) over
    seeds 0-500 on all three golden configs (5-block l3/w3.5, 7-block
    l2/w3.0, CityMap 6-block) recorded 0 raises in 1.35M
    local_coordinates calls — the branch never fires on any seed that
    survives, so the port cannot diverge from a non-crashing reference."""
    if isinstance(lane, HostCircularLane):
        delta0 = point[0] - lane.center[0]
        delta1 = point[1] - lane.center[1]
        from benchmarks.reference.mapgen.lanes import wrap_to_pi
        abs_phase = wrap_to_pi(math.atan2(delta1, delta0))
        d_start = abs(wrap_to_pi(abs_phase - wrap_to_pi(lane.start_phase)))
        d_end = abs(wrap_to_pi(abs_phase - wrap_to_pi(lane.end_phase)))
        if d_start > math.pi and d_end > math.pi:
            return math.inf, math.inf
    return lane.local_coordinates(point)


def check_lane_on_road(road_network, lane, positive=0.0, ignored=None,
                       ignore_intersection_checking=None):
    """True when the new ``lane`` crosses existing drivable area
    (utils/pg/utils.py:37-72, exact semantics):

    - iterate every (from, to) road of the network, skipping the decoration
      road and (optionally) one ``ignored`` (from, to) pair;
    - conservative pre-filter: skip a road when its sidewalk-padded bounding
      box does not intersect the new lane's;
    - sample the new lane at every integer longitude i in [1, len), at
      lateral ``positive * width_at(i)/2``, and report a hit when any sample
      projects on-lane (|lat| <= width/2 and 0 <= long <= length) for any
      existing lane.
    """
    assert ignore_intersection_checking is not None
    if ignore_intersection_checking:
        return True
    graph = road_network.graph
    # the candidate lane's box is loop-invariant — hoisted (the reference
    # recomputes it per road; value-identical)
    x_max_2, x_min_2, y_max_2, y_min_2 = get_lanes_bounding_box([lane])
    for _from, to_dict in graph.items():
        for _to, lanes in to_dict.items():
            if ignored and (_from, _to) == ignored:
                continue
            if (_from, _to) == (DECORATION_START, DECORATION_END):
                continue
            if len(lanes) == 0:
                continue
            x_max_1, x_min_1, y_max_1, y_min_1 = get_lanes_bounding_box(lanes)
            if x_min_1 > x_max_2 or x_min_2 > x_max_1 or y_min_1 > y_max_2 or y_min_2 > y_max_1:
                continue
            for l in lanes:
                for i in range(1, int(lane.length), 1):
                    sample_point = lane.position(i, positive * lane.width_at(i) / 2.0)
                    longitudinal, lateral = _local_coordinates_total(l, sample_point)
                    is_on = (
                        math.fabs(lateral) <= l.width_at(longitudinal) / 2.0
                        and 0 <= longitudinal <= l.length
                    )
                    if is_on:
                        return True
    return False
