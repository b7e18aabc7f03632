"""Host-side lane primitives (numpy closed forms).

Semantics mirror the reference's lane classes:
- StraightLane: metadrive/component/lane/straight_lane.py:12-95
- CircularLane: metadrive/component/lane/circular_lane.py:12-177

Conventions (identical to reference):
- ``direction_lateral`` is the right-hand perpendicular of the travel
  direction: for direction (dx, dy) it is (dy, -dx). Positive lateral is to
  the RIGHT of travel; lane line_types = (left_line, right_line) sit at
  lateral -w/2 and +w/2.
- CircularLane ``direction`` = -1 if clockwise else +1;
  position(long, lat) = center + (radius + lat*direction) * (cos φ, sin φ)
  with φ = direction*long/radius + start_phase.
"""
import math

import numpy as np

from benchmarks.reference.constants import (
    LANE_CIRCULAR, LANE_STRAIGHT, LINE_BROKEN, LINE_SIDE
)


def wrap_to_pi(x):
    """Wrap radians to (-pi, pi] (reference: metadrive/utils/math.py:29-41)."""
    x = x % (2 * np.pi)
    return x - 2 * np.pi * (x > np.pi)


class HostLane:
    """Common base; concrete geometry in subclasses."""

    DEFAULT_WIDTH = 3.5  # reference: PGLane.DEFAULT_WIDTH

    kind = None

    def __init__(self, width, line_types, speed_limit=1000.0):
        self.width = float(width)
        self.line_types = list(line_types) if line_types else [LINE_BROKEN, LINE_BROKEN]
        # [left, right] colors; yellow center lines set by create_road_from
        # (reference: create_pg_block_utils.py:174 lanes[0].line_colors)
        self.line_colors = [0, 0]  # LINE_COLOR_GREY
        self.speed_limit = float(speed_limit)
        self.index = None  # (start_node, end_node, i) once added to a network
        self.forbidden = False

    # subclass API: position, heading_theta_at, local_coordinates, length

    def width_at(self, longitudinal):
        return self.width

    def is_previous_lane_of(self, next_lane, eps=1e-1):
        x1, y1 = self.end
        x2, y2 = next_lane.start
        return (x1 - x2) ** 2 + (y1 - y2) ** 2 < eps ** 2

    def point_on_lane(self, point, margin=0.0):
        long, lat = self.local_coordinates(point)
        return (-margin <= long <= self.length + margin) and (abs(lat) <= self.width / 2 + margin)

    def distance(self, point):
        long, lat = self.local_coordinates(point)
        return abs(lat) + max(long - self.length, 0.0) + max(-long, 0.0)


class HostStraightLane(HostLane):
    kind = LANE_STRAIGHT

    def __init__(self, start, end, width=HostLane.DEFAULT_WIDTH, line_types=None, speed_limit=1000.0):
        super().__init__(width, line_types, speed_limit)
        self.start = np.asarray(start, dtype=np.float64)
        self.end = np.asarray(end, dtype=np.float64)
        self.update_properties()

    def update_properties(self):
        delta = self.end - self.start
        self.length = float(math.hypot(delta[0], delta[1]))
        self.heading = math.atan2(delta[1], delta[0])
        self.direction = delta / self.length
        self.direction_lateral = np.array([self.direction[1], -self.direction[0]])

    def position(self, longitudinal, lateral):
        return self.start + longitudinal * self.direction + lateral * self.direction_lateral

    def heading_theta_at(self, longitudinal):
        return self.heading

    def local_coordinates(self, position):
        delta = np.asarray(position, dtype=np.float64) - self.start
        longitudinal = float(delta @ self.direction)
        lateral = float(delta @ self.direction_lateral)
        return longitudinal, lateral


class HostCircularLane(HostLane):
    kind = LANE_CIRCULAR

    def __init__(
        self, center, radius, start_phase, angle, clockwise=True,
        width=HostLane.DEFAULT_WIDTH, line_types=None, speed_limit=1000.0
    ):
        assert angle > 0, "arc angle must be positive"
        super().__init__(width, line_types, speed_limit)
        self.center = np.asarray(center, dtype=np.float64)
        self.radius = float(radius)
        self._clockwise = bool(clockwise)
        self.start_phase = float(wrap_to_pi(start_phase))
        self.angle = float(angle)
        self.update_properties()

    def is_clockwise(self):
        return self._clockwise

    @property
    def direction(self):
        return -1 if self._clockwise else 1

    def update_properties(self):
        self.end_phase = self.start_phase + (-self.angle if self._clockwise else self.angle)
        self.length = abs(self.radius * (self.end_phase - self.start_phase))
        self.start = self.position(0.0, 0.0)
        self.end = self.position(self.length, 0.0)

    def position(self, longitudinal, lateral):
        phi = self.direction * longitudinal / self.radius + self.start_phase
        return self.center + (self.radius + lateral * self.direction) * np.array([math.cos(phi), math.sin(phi)])

    def heading_theta_at(self, longitudinal):
        phi = self.direction * longitudinal / self.radius + self.start_phase
        return phi + math.pi / 2 * self.direction

    def local_coordinates(self, position):
        # Phase-disambiguated arc coordinates
        # (reference: circular_lane.py:71-121). The batched device op uses a total,
        # branchless re-formulation (ops/lane_geom.py); this host version
        # keeps the reference's closest-endpoint disambiguation.
        delta = np.asarray(position, dtype=np.float64) - self.center
        abs_phase = wrap_to_pi(math.atan2(delta[1], delta[0]))
        start_phase = wrap_to_pi(self.start_phase)
        end_phase = wrap_to_pi(self.end_phase)
        d_start = abs(wrap_to_pi(abs_phase - start_phase))
        d_end = abs(wrap_to_pi(abs_phase - end_phase))
        if d_start > d_end:
            diff = (end_phase - abs_phase) if self._clockwise else (abs_phase - end_phase)
            longitudinal = wrap_to_pi(diff) * self.radius + self.length
        else:
            diff = (start_phase - abs_phase) if self._clockwise else (abs_phase - start_phase)
            longitudinal = wrap_to_pi(diff) * self.radius
        dist = math.hypot(delta[0], delta[1])
        lateral = self.direction * (dist - self.radius)
        return float(longitudinal), float(lateral)


def extend_straight_lane(lane, extend_length, line_types):
    """New straight lane continuing ``lane`` for extend_length
    (reference: create_pg_block_utils.py ExtendStraightLane)."""
    assert isinstance(lane, HostStraightLane)
    start = lane.end.copy()
    end = lane.position(lane.length + extend_length, 0.0)
    return HostStraightLane(start, end, lane.width, line_types)


def create_wave_lanes(pre_lane, lateral_dist, wave_length, last_straight_length,
                      lane_width, toward_left=True):
    """Two opposing arcs shifting a lane laterally (bottleneck transitions;
    reference: create_pg_block_utils.py:359-380 create_wave_lanes)."""
    angle = math.pi - 2 * math.atan(wave_length / (2 * lateral_dist))
    radius = wave_length / (2 * math.sin(angle))
    circular_1, mid = create_bend_straight(
        pre_lane, 10.0, radius, angle, not toward_left, lane_width,
        [LINE_BROKEN, LINE_BROKEN]
    )
    mid = HostStraightLane(
        mid.position(-10.0, 0.0), mid.position(mid.length - 10.0, 0.0), lane_width
    )
    circular_2, straight = create_bend_straight(
        mid, last_straight_length, radius, angle, toward_left, lane_width,
        [LINE_BROKEN, LINE_BROKEN]
    )
    return circular_1, circular_2, straight


def create_bend_straight(
    previous_lane, following_lane_length, radius, angle, clockwise=True,
    width=HostLane.DEFAULT_WIDTH, line_types=None
):
    """Arc + straight continuation of a straight lane
    (reference: create_pg_block_utils.py:19-47 create_bend_straight)."""
    bend_direction = 1 if clockwise else -1
    center = previous_lane.position(previous_lane.length, bend_direction * radius)
    x, y = previous_lane.direction_lateral
    start_phase = math.atan2(y, x) + (math.pi if clockwise else 0)
    bend = HostCircularLane(center, radius, start_phase, angle, clockwise, width, line_types)
    bend_end = bend.position(bend.length, 0.0)
    radial = bend_end - center
    # vertical vectors of radial: [(-y,x), (y,-x)]/|r| (utils/math.py:44-47)
    length = math.hypot(radial[0], radial[1])
    v0 = np.array([-radial[1], radial[0]]) / length
    v1 = np.array([radial[1], -radial[0]]) / length
    nxt_dir = v0 if not clockwise else v1
    following_end = nxt_dir * following_lane_length + bend_end
    following = HostStraightLane(bend_end, following_end, width, line_types)
    return bend, following
