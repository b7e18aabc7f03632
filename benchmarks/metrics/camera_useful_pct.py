"""Camera: the share of the (pixel, target slot) pairs the box test
computed whose slot is active, 100 x the tracer's `camera.boxes_live` /
`camera.boxes_computed` over the read steps."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.useful_pct(trace, env, "camera.boxes_live", "camera.boxes_computed")
