"""The program's own spans and counters, for the per-layer metrics that
read them (metrics/*_replay_ms.py, *_useful_pct.py, replay_gap_pct.py,
step_host_ms.py).

The helper reaches the program's tracer through the env it is handed
(``env.tracer``) and imports nothing of the program: where the env has no
tracer, every reader finds nothing. After the traced window it reads the
cell's public loop again through the tracer's ``read``: tracing on, warm
calls until the replays have settled, one read call, tracing off. A call
of a step loop (its trace holds `bench.env_step` host spans) is STEPS
`step` calls with the window's last actions, each followed by the host
read of reward and the done flags, as the cell's; a call of a rollout loop is
one ``rollout`` of the cell's chunk, collecting what the cell collects
(the traffic of ``--workload``, the cell that benchmarks/run.py runs;
STEPS steps and the default fields where there is none). The records are
kept for the env's other readers.

Every capture is followed by a phase of slower replays (PERF.md §2), and
the first warm call captures the stamped graph: warm calls go on until
the median `replay` span of one lies within SETTLED of the traced
window's device busy ms a step (the cell's own graph, settled), and at
most WAIT_S seconds. Off the card (no device busy time) one warm call is
made.

A record is the tracer's: ``spans``, dicts with ``name``, ``parent`` (the
index of the enclosing span), ``clock`` ("host" or "device"),
``start_ns`` and ``end_ns``; ``counters``, totals over the read call.
"""
import argparse
import statistics
import sys
import time

from benchmarks import harness, yardstick

STEPS = 32
SETTLED = 1.005
WAIT_S = 40.0
_kept = [None, None]  # (the env, its records)


def records(trace, env):
    """The tracer's records of the read call on ``env``, or None where the
    env has no tracer."""
    tracer = getattr(env, "tracer", None)
    if tracer is None:
        return None
    if _kept[0] is not env:
        _kept[:] = [env, _run(trace, env, tracer)]
    return _kept[1]


def _traffic():
    """The traffic of the cell that benchmarks/run.py runs, or None."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    name = ap.parse_known_args(sys.argv[1:])[0].workload
    return harness.Cell(name).traffic if name else None


def _run(trace, env, tracer):
    act = trace.actions
    if any(name == yardstick.ENV_STEP for name, _, _ in trace.host):
        steps = STEPS

        def call():
            for _ in range(STEPS):
                _, reward, terminated, truncated, _ = env.step(act)
                reward.cpu(), terminated.cpu(), truncated.cpu()
    else:
        traffic = _traffic()
        kw = dict(collect=tuple(traffic["collect"])) if traffic else {}
        steps = traffic["chunk"] if traffic else STEPS

        def call():
            env.rollout(steps, actions=act, **kw)
    busy_ms = 1e3 * trace.busy_s / trace.steps
    warm = []

    def settled(recs):
        ms = _per_replay(recs, "replay")
        warm.append(statistics.median(ms) if ms else None)
        return bool(ms) and warm[-1] <= SETTLED * busy_ms
    t0 = time.perf_counter()
    recs = tracer.read(call, settled=settled if busy_ms > 0 else None, wait_s=WAIT_S)
    print(f"program trace: {time.perf_counter() - t0} s; the warm calls' median replay ms "
          f"{warm} against the traced window's busy {busy_ms} ms a step; the read call:\n"
          f"{tracer.table(recs, steps)}", file=sys.stderr)
    return recs


def _ms(span):
    return (span["end_ns"] - span["start_ns"]) / 1e6


def _closed(recs, clock):
    return [(i, s) for i, s in enumerate(recs["spans"])
            if s["clock"] == clock and s["end_ns"] is not None]


def _per_replay(recs, name):
    """The device ms of the spans named ``name`` inside each replay (summed
    where a replay holds several), one number a replay that holds one."""
    spans = recs["spans"]

    def replay_of(i):
        while i is not None and spans[i]["name"] != "replay":
            i = spans[i]["parent"]
        return i
    per_replay = {}
    for i, s in _closed(recs, "device"):
        if s["name"] == name:
            r = replay_of(i)
            if r is not None:
                per_replay[r] = per_replay.get(r, 0.0) + _ms(s)
    return list(per_replay.values())


def replay_ms(trace, env, name):
    """The median over the read replays of the device ms of the spans
    named ``name`` inside each (summed where a replay holds several), or
    None where no replay holds one."""
    recs = records(trace, env)
    if recs is None:
        return None
    ms = _per_replay(recs, name)
    return statistics.median(ms) if ms else None


def useful_pct(trace, env, used, computed):
    """100 x counter ``used`` / counter ``computed`` over the read call, or
    None where nothing was computed."""
    recs = records(trace, env)
    if recs is None or not recs["counters"].get(computed):
        return None
    return 100.0 * recs["counters"][used] / recs["counters"][computed]


def replay_gap_pct(trace, env):
    """100 x (1 - the replays' device time / the device span of the read
    `rollout` call), or None where the loop made no rollout call or its
    steps replayed no graph."""
    recs = records(trace, env)
    if recs is None:
        return None
    rollouts = [(i, s) for i, s in _closed(recs, "device") if s["name"] == "rollout"]
    if not rollouts:
        return None
    i, rollout = rollouts[-1]
    replays = [_ms(s) for _, s in _closed(recs, "device")
               if s["name"] == "replay" and s["parent"] == i]
    return 100.0 * (1.0 - sum(replays) / _ms(rollout)) if replays else None


def host_ms(trace, env, name):
    """The median host ms of the host spans named ``name``, or None."""
    recs = records(trace, env)
    if recs is None:
        return None
    ms = [_ms(s) for _, s in _closed(recs, "host") if s["name"] == name]
    return statistics.median(ms) if ms else None
