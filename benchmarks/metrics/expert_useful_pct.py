"""Expert traffic: the share of the NPC slots the expert computed that are
active and expert-driven, 100 x the tracer's `expert.live` /
`expert.computed` over the read steps."""
from benchmarks import program_trace


def read(trace, env):
    return program_trace.useful_pct(trace, env, "expert.live", "expert.computed")
