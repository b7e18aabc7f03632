"""Step pipeline: device ms of one eager `_observe` (lidar, state features,
the detector clouds) on the state one eager `_advance` gives."""
from benchmarks import yardstick


def read(trace, env):
    advance, observe = getattr(env, "_advance", None), getattr(env, "_observe", None)
    if advance is None or observe is None:
        return None
    state, args, *_ = advance(env._state, trace.actions.reshape(env.num_envs, 2))
    return yardstick.device_ms(lambda: observe(state, *args), 3)
