"""Step pipeline: the median device ms of the program's `observe` span
(lidar, state features) inside each replayed step, from the tracer's stage
stamps."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.replay_ms(trace, env, "observe")
