"""Step graph: the share of a rollout call's device span outside its
replays (the collected copies, and the device idle between replays), 100 x
(1 - the `replay` spans / the `rollout` span) of the read call, with no
profiler attached."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.replay_gap_pct(trace, env)
