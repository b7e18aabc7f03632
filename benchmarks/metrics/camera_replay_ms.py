"""Camera: the median device ms of the program's `camera` span (the image
source's frame rendered from the stepped state) inside each replayed
rollout step, from the tracer's stage stamps."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.replay_ms(trace, env, "camera")
