"""Shared constants.

String keys mirror the reference so downstream RL code sees identical info
dicts (reference: metadrive/constants.py:22-34 for TerminationState;
metadrive/constants.py:281-342 for line types and drivable-area properties).
"""
import math


class TerminationState:
    SUCCESS = "arrive_dest"
    OUT_OF_ROAD = "out_of_road"
    MAX_STEP = "max_step"
    CRASH = "crash"
    CRASH_VEHICLE = "crash_vehicle"
    CRASH_HUMAN = "crash_human"
    CRASH_OBJECT = "crash_object"
    CRASH_BUILDING = "crash_building"
    CRASH_SIDEWALK = "crash_sidewalk"
    IDLE = "idle"
    CURRENT_BLOCK = "current_block"
    ENV_SEED = "env_seed"


DEFAULT_AGENT = "default_agent"

# Physics timing (reference: metadrive/envs/base_env.py:184-186 and
# engine/core/engine_core.py:350-352 — dt=0.02 s stepped decision_repeat=5
# times per env.step, i.e. 0.1 simulated seconds per env step).
PHYSICS_DT = 0.02
DECISION_REPEAT = 5

# Integer lane-geometry kinds inside SceneSpec arrays.
LANE_STRAIGHT = 0
LANE_CIRCULAR = 1

# Lane line types (reference: metadrive/constants.py:281-300 PGLineType).
LINE_NONE = 0
LINE_BROKEN = 1
LINE_CONTINUOUS = 2
LINE_SIDE = 3  # side line = continuous + sidewalk beyond it
LINE_GUARDRAIL = 4  # physical barrier at the line (racing track walls);
                    # contact -> crash_sidewalk (PGLineType.GUARDRAIL)

# Lane line colors (reference: PGLineColor) — center line is yellow.
LINE_COLOR_GREY = 0
LINE_COLOR_YELLOW = 1

# Boundary-segment semantic types inside SceneSpec.
SEG_SIDEWALK = 0       # physical sidewalk body -> crash_sidewalk
SEG_YELLOW_LINE = 1    # continuous yellow center line
SEG_WHITE_LINE = 2     # continuous white line (side line)
SEG_BROKEN_LINE = 3    # broken line (no out-of-road consequence)

# Drivable-area property constants
# (reference: metadrive/constants.py:303-342 PGDrivableAreaProperty).
STRIPE_LENGTH = 1.5
LANE_LINE_GAP = 1.0
LANE_LINE_WIDTH = 0.15
SIDEWALK_WIDTH = 2.0
SIDEWALK_LENGTH = 3.0

# Default vehicle geometry: DefaultVehicle
# (reference: metadrive/component/vehicle/vehicle_type.py:8-33).
DEFAULT_VEHICLE_LENGTH = 4.515
DEFAULT_VEHICLE_WIDTH = 1.852
DEFAULT_VEHICLE_HEIGHT = 1.19
DEFAULT_VEHICLE_MASS = 1100.0

# Vehicle class table (LENGTH, WIDTH, MASS, max_engine_force, max_brake_force,
# max_steering_deg, max_speed_km_h). Forces are the midpoints of the reference
# BoxSpaces (metadrive/component/pg_space.py:226-272); geometry from
# vehicle_type.py. Index order matches the traffic-sampling weight vector
# [s, m, l, xl, default] (metadrive/component/vehicle/vehicle_type.py:283-294).
VEHICLE_CLASSES = {
    "s": dict(length=4.3, width=1.7, mass=800.0, engine=450.0, brake=57.5, steer=50.0,
              vmax=80.0, wheelbase=2.495),
    "m": dict(length=4.6, width=1.85, mass=1200.0, engine=750.0, brake=105.0, steer=45.0,
              vmax=80.0, wheelbase=2.488),
    "l": dict(length=4.87, width=2.046, mass=1300.0, engine=550.0, brake=90.0, steer=40.0,
              vmax=80.0, wheelbase=2.748),
    "xl": dict(length=5.74, width=2.3, mass=1600.0, engine=600.0, brake=75.0, steer=35.0,
               vmax=80.0, wheelbase=2.801),
    "default": dict(
        length=DEFAULT_VEHICLE_LENGTH, width=DEFAULT_VEHICLE_WIDTH, mass=DEFAULT_VEHICLE_MASS,
        engine=800.0, brake=130.0, steer=40.0, vmax=80.0, wheelbase=2.469
    ),
}
VEHICLE_CLASS_ORDER = ("s", "m", "l", "xl", "default")

# The reference's validated bicycle fit for DefaultVehicle uses
# accel 3 m/s^2 at full throttle, 9 m/s^2 at full brake, and an effective
# turning wheelbase of 4 m (bicycle_model.py:37-46). Other classes scale by
# engine force / mass and physical wheelbase.
BICYCLE_REF_ACCEL = 3.0
BICYCLE_REF_BRAKE = 9.0
BICYCLE_REF_WHEELBASE_EFF = 4.0

# Vehicle obs class const (reference: base_vehicle.py:80 MAX_STEERING = 60,
# used *only* for normalizing the steering observation in state_obs.py:114).
OBS_MAX_STEERING = 60.0

# TrajectoryIDM cars of the scenario path refresh their acceleration in
# staggered act batches (scenario_traffic_manager.py:27)
IDM_ACT_BATCH_SIZE = 5

MAX_LENGTH = 10.0  # reference: BaseVehicle.MAX_LENGTH (obs normalization)
MAX_WIDTH = 2.5  # reference: BaseVehicle.MAX_WIDTH

TWO_PI = 2.0 * math.pi
