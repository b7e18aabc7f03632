"""Env API: the median host ms of the program's `env.step` span (the action
conversion, the load of the state into the graph's buffers, the launch,
the output clones, the frame and the host's bookkeeping), from the tracer's
host spans."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.host_ms(trace, env, "env.step")
