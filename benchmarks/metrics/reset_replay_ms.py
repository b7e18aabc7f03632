"""Step pipeline: the median device ms of the program's `advance.reset`
spans (the auto-reset's spawn and, in a multi-agent env, the delay-done
bookkeeping and respawn) inside each replayed step, from the tracer's
stage stamps."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.replay_ms(trace, env, "advance.reset")
