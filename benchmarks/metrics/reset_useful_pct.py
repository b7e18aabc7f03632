"""Step pipeline: the share of the rows the spawns computed that a step
kept, 100 x the tracer's `reset.rows` / `reset.computed` over the read
steps (0 where no row reset)."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.useful_pct(trace, env, "reset.rows", "reset.computed")
