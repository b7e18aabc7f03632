"""Expert traffic: the median device ms of the program's
`advance.traffic.expert` span (the expert's observation of every NPC slot,
its per-NPC lidar and the MLP) inside each replayed step, from the tracer's
stage stamps."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.replay_ms(trace, env, "advance.traffic.expert")
