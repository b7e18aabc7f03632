"""Step pipeline: device ms of one eager `_advance` (dynamics, traffic,
contacts, localization, reward, respawn, auto-reset) on the cell's state
and actions after the traced window."""
from benchmarks import yardstick


def read(trace, env):
    advance = getattr(env, "_advance", None)
    if advance is None:
        return None
    state, act = env._state, trace.actions.reshape(env.num_envs, 2)
    return yardstick.device_ms(lambda: advance(state, act), 3)
