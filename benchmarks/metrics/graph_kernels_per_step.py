"""Step graph: device operations (kernels, copies, sets) per step in the
traced window of replayed steps."""


def read(trace, env):
    return len(trace.kernels()) / trace.steps
