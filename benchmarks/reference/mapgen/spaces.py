"""Block/vehicle parameter spaces.

Mirrors metadrive/component/pg_space.py: BoxSpace (uniform), DiscreteSpace
(randint inclusive), ConstantSpace. Parameter names and ranges match
BlockParameterSpace (pg_space.py:275-327).
"""


class BoxSpace:
    def __init__(self, min, max):
        self.min, self.max = float(min), float(max)

    def sample(self, rs):
        return float(rs.uniform(self.min, self.max))

    def sample_from_u(self, u):
        """Reference Box.sample bounded branch: the gym Box is constructed
        with dtype float32, so low/high are float32-cast, uniform runs in
        float64, and the result is cast back to float32
        (pg_space.py:54-100 wrap2gym_space + gym Box.sample:443-473).
        Reproducing that rounding bit-for-bit matters: block geometry is
        built from these values, and the overlap test samples it."""
        import numpy as np
        lo = np.float64(np.float32(self.min))
        hi = np.float64(np.float32(self.max))
        return float(np.float32(lo + (hi - lo) * u))


class DiscreteSpace:
    """Inclusive integer range [min, max]."""

    def __init__(self, min, max):
        self.min, self.max = int(min), int(max)

    def sample(self, rs):
        return int(rs.randint(0, self.max - self.min + 1)) + self.min

    def sample_from_u(self, u):
        """Reference int-Box sample: floor(uniform(min, max+1))."""
        v = int(self.min + (self.max + 1 - self.min) * u)
        return min(v, self.max)


class ConstantSpace:
    def __init__(self, value):
        self.value = value

    def sample(self, rs):
        return self.value

    def sample_from_u(self, u):
        return self.value


class Parameter:
    length = "length"
    radius = "radius"
    angle = "angle"
    dir = "dir"
    radius_exit = "exit_radius"
    radius_inner = "inner_radius"
    t_intersection_type = "t_type"
    change_lane_num = "change_lane_num"
    decrease_increase = "decrease_increase"
    lane_num = "lane_num"
    one_side_vehicle_num = "one_side_vehicle_number"


# reference: pg_space.py:275-327 BlockParameterSpace
STRAIGHT_SPACE = {Parameter.length: BoxSpace(40.0, 80.0)}

CURVE_SPACE = {
    Parameter.length: BoxSpace(40.0, 80.0),
    Parameter.radius: BoxSpace(25.0, 60.0),
    Parameter.angle: BoxSpace(45.0, 135.0),
    Parameter.dir: DiscreteSpace(0, 1),
}

INTERSECTION_SPACE = {
    Parameter.radius: ConstantSpace(10.0),
    Parameter.change_lane_num: DiscreteSpace(0, 1),
    Parameter.decrease_increase: DiscreteSpace(0, 1),
}

ROUNDABOUT_SPACE = {
    Parameter.radius_exit: BoxSpace(5.0, 15.0),
    Parameter.radius_inner: BoxSpace(15.0, 45.0),
    Parameter.angle: ConstantSpace(60.0),
}

T_INTERSECTION_SPACE = {
    Parameter.radius: ConstantSpace(10.0),
    Parameter.t_intersection_type: DiscreteSpace(0, 2),
    Parameter.change_lane_num: DiscreteSpace(0, 1),
    Parameter.decrease_increase: DiscreteSpace(0, 1),
}

RAMP_SPACE = {Parameter.length: BoxSpace(20.0, 40.0)}

# Normalization constants used by navigation obs
# (node_network_navigation.py:273-291 reads CURVE radius/angle maxima).
CURVE_RADIUS_MAX = 60.0
CURVE_ANGLE_MAX = 135.0
