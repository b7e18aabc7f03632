"""Env API: the host's CUDA runtime and driver calls inside each `step`
call of the traced window (the graph launch, the action copy, the output
clones); nothing where the loop makes no `step` calls."""
from benchmarks import yardstick


def read(trace, env):
    calls = trace.host_api_calls(yardstick.ENV_STEP)
    return calls / trace.steps if calls else None
