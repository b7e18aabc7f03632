"""Batched vehicle dynamics (kinematic bicycle with slip).

Replaces the reference's Bullet raycast-vehicle integration
(base_vehicle.py:595-671 chassis/wheels; engine_core.py:350-352 doPhysics).
The model is the reference's own offline bicycle approximation
(component/vehicle_model/bicycle_model.py:17-51):

    beta  = atan(0.5 * tan(delta))           (slip angle)
    phi  += v / L_eff * tan(delta) * dt      (L_eff = 4 for DefaultVehicle)
    x    += v * cos(phi + beta_prev) * dt
    v    += (a - a_friction) * dt,  a_friction = 0.5 m/s^2, v floored at 0

with the Bullet actuation semantics of _apply_throttle_brake
(base_vehicle.py:468-484): engine force zeroed above max_speed_km_h,
braking (not reverse) for negative throttle unless enable_reverse.

All ops are elementwise over any batch shape.
"""
import torch

FRICTION_DECEL = 0.5  # m/s^2 (bicycle_model.py:38 `af`)


def substep(pos, heading, speed, vel_dir, steering_norm, throttle, params, dt, enable_reverse):
    """One physics substep (dt=0.02). Shapes broadcast over batch axes."""
    delta = steering_norm * params.max_steer_rad
    tan_delta = torch.tan(delta)
    new_beta = torch.atan(0.5 * tan_delta)

    speed_kmh = speed * 3.6
    over_governor = speed_kmh > params.max_speed_kmh
    accel_engine = torch.where(over_governor, 0.0, throttle * params.accel_gain)
    if enable_reverse:
        accel_back = throttle * params.accel_gain
    else:
        accel_back = -params.brake_gain * torch.abs(throttle) * torch.sign(speed)
    a = torch.where(throttle >= 0, accel_engine, accel_back)
    # rolling friction opposes motion (or the accel direction at rest) and is
    # applied inside the velocity update even from standstill; the car only
    # starts moving once engine torque exceeds it (bicycle_model.py:40-44)
    moving = torch.abs(speed) > 1e-5
    oppose = torch.where(moving, torch.sign(speed), torch.sign(a))
    net = a - FRICTION_DECEL * oppose
    can_start = torch.abs(a) > FRICTION_DECEL
    new_speed = torch.where(moving | can_start, speed + net * dt, 0.0)
    # friction/brake cannot reverse the motion direction by itself; only an
    # actively reversing vehicle may cross through zero
    crossed = speed * new_speed < 0
    if enable_reverse:
        crossed = crossed & ~(throttle < 0)
    new_speed = torch.where(crossed, 0.0, new_speed)

    new_heading = heading + speed / params.wheelbase_eff * tan_delta * dt
    # position integrates with the *previous* slip angle, matching the
    # reference's update order (bicycle_model.py:46-49)
    move_dir = heading + vel_dir
    new_pos = pos + (speed * dt)[..., None] * torch.stack(
        [torch.cos(move_dir), torch.sin(move_dir)], dim=-1
    )
    return new_pos, new_heading, new_speed, new_beta


def step_vehicle(pos, heading, speed, vel_dir, steering_norm, throttle, params,
                 dt=0.02, substeps=5, enable_reverse=False):
    """decision_repeat substeps (base_env.py:184-186)."""
    for _ in range(substeps):
        pos, heading, speed, vel_dir = substep(
            pos, heading, speed, vel_dir, steering_norm, throttle, params, dt, enable_reverse
        )
    return pos, heading, speed, vel_dir
