"""Pedestrian / cyclist kinematics.

The reference moves pedestrians kinematically by setting the body's linear
velocity each step (pedestrian.py:69-98 set_velocity); cyclists likewise
(cyclist.py). Here participants advance in the arc-length coordinates of
the lane whose sidewalk/edge they follow, bouncing at lane ends; the world
pose is derived from the lane closed form.
"""
import math

import torch

from benchmarks.reference.ops import lane_geom


def ped_world_pose(scene, sidx, ped):
    """(pos [E,P,2], heading [E,P]) of every participant."""
    lanes = scene.ped_lane[sidx.long()]
    g = lane_geom.gather_lane(scene, sidx[:, None], lanes)
    lat = scene.ped_lat[sidx.long()]
    pos = lane_geom.position(g, ped.long, lat)
    lane_heading = lane_geom.heading_theta_at(g, ped.long)
    heading = torch.where(ped.direction > 0, lane_heading, lane_heading + math.pi)
    return pos, heading


def step_peds(scene, sidx, ped, dt_total):
    """Advance participants one env step (dt_total = dt * decision_repeat)."""
    lanes = scene.ped_lane[sidx.long()]
    g = lane_geom.gather_lane(scene, sidx[:, None], lanes)
    speed = scene.ped_speed[sidx.long()]
    new_long = ped.long + ped.direction * speed * dt_total
    # bounce at lane ends
    over = new_long > g["length"]
    under = new_long < 0.0
    direction = torch.where(over, -1.0, torch.where(under, 1.0, ped.direction))
    new_long = torch.minimum(torch.clamp(new_long, min=0.0), g["length"])
    return ped.replace(long=new_long, direction=direction)
