"""The port's tracer (metadrive_ped_torch/core/trace.py) on the CPU at tiny
sizes: tracing changes no output, the spans nest as listed and share their
call's id, the counters equal hand counts of the same steps, nothing is
recorded with tracing off, the host spans reach a profiler's events, and
the benchmark's readers of the records find their numbers. The replayed
paths run through tests/test_torch_graph.py's `EagerGraph` stand-in, as
the runner's other CPU tests do; tests/test_torch_cuda.py holds the stamp
kernel on the card."""
import pytest
import torch
from test_torch_graph import EagerGraph

import metadrive_ped_torch as T
from metadrive_ped_torch.core import graph, trace
from metadrive_ped_torch.core.structs import map_tensors

PG = dict(num_envs=4, map="SCS", num_scenarios=2, traffic_density=0.1, horizon=12)
MIXED = dict(num_envs=4, map="SCS", num_scenarios=2, traffic_density=0.2, rl_agent_ratio=0.5,
             horizon=12)
MARL = dict(num_envs=1, num_agents=8, horizon=20, delay_done=2)
IMAGE = dict(PG, num_envs=2, image_observation=True, sensors=dict(main_camera=("rgb", 16, 12)))
COLLECT = ("obs", "reward", "terminated", "truncated", "state")
SPANS = {**trace.HOST_SPANS, **trace.DEVICE_SPANS}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture
def replays(monkeypatch):
    monkeypatch.setattr(graph, "capture_backend", lambda device: EagerGraph)


def _full(env):
    return torch.tensor([[0.0, 1.0]] * env.num_envs)


def _run(cls, cfg, on, steps=14):
    """A rollout, then three steps, from one reset; tracing ``on`` after the
    reset. Returns (the outputs, the records)."""
    env = cls(cfg, device="cpu")
    env.reset(seed=5)
    if on:
        trace.enable()
    outs = [env.rollout(steps, actions=_full(env), collect=COLLECT)[0]]
    outs += [map_tensors(torch.clone, env.step(_full(env))) for _ in range(3)]
    outs.append(map_tensors(torch.clone, (env._state, env._last_obs)))
    trace.disable()
    return outs, trace.records()


def _equal(x, y):
    xs, ys = graph.leaves(x), graph.leaves(y)
    return len(xs) == len(ys) and all(torch.equal(a, b) for a, b in zip(xs, ys))


CLASSES = dict(pg=(T.MetaDriveEnv, PG), mixed=(T.MixedTrafficEnv, MIXED),
               marl=(T.MultiAgentRoundaboutEnv, MARL))


@pytest.mark.parametrize("path", ["eager", "replayed"])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_tracing_changes_no_output(name, path, request):
    if path == "replayed":
        request.getfixturevalue("replays")
    cls, cfg = CLASSES[name]
    off, none = _run(cls, cfg, False)
    trace.clear()
    on, recs = _run(cls, cfg, True)
    assert _equal(off, on)
    assert none["spans"] == [] and recs["spans"]


def _listed_chain(name):
    """The listed ancestors of span ``name``, nearest first."""
    chain, up = [], SPANS[name]
    while up is not None:
        chain.append(up)
        up = SPANS[up]
    return chain


def _check_nesting(recs):
    spans = recs["spans"]
    assert recs["lost"] == 0
    for s in spans:
        assert s["name"] in SPANS and s["end_ns"] is not None and s["start_ns"] <= s["end_ns"]
        if s["parent"] is None:
            continue
        p = spans[s["parent"]]
        assert p["clock"] == s["clock"] and p["device"] == s["device"]
        assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"], (s, p)
        assert s["call"] == p["call"]
        assert p["name"] in _listed_chain(s["name"]), (s["name"], p["name"])
    return spans


def test_replayed_spans_nest_as_listed(replays):
    """Through the runner: every span lies inside its listed parent and
    carries its call id; a rollout's replays share the rollout's call, each
    step's spans their step's."""
    cls, cfg = CLASSES["mixed"]
    env = cls(cfg, device="cpu")
    env.reset(seed=5)
    trace.enable()
    env.rollout(3, actions=_full(env))       # the capture (EagerGraph runs it once)
    env.step(_full(env))
    trace.clear()
    env.rollout(4, actions=_full(env))
    env.step(_full(env))
    env.step(_full(env))
    spans = _check_nesting(trace.records())
    names = [s["name"] for s in spans]
    for name in trace.DEVICE_SPANS:
        # the camera's stages run only with image_observation (their test:
        # test_a_traced_image_rollout_holds_the_camera_stages)
        assert (name in names) != name.startswith("camera"), name
    for name in ("env.step", "step.actions", "step.load", "step.replay", "step.clone",
                 "step.frame_obs", "step.outputs", "env.rollout", "rollout.load",
                 "rollout.replay", "rollout.collect"):
        assert name in names, name
    replays_ = [s for s in spans if s["name"] == "replay"]
    assert len(replays_) == 6
    in_rollout = [s for s in replays_ if s["parent"] is not None]
    assert len(in_rollout) == 4 and len({s["call"] for s in in_rollout}) == 1
    assert len({s["call"] for s in replays_}) == 3
    host_calls = {s["call"] for s in spans if s["clock"] == "host"}
    assert len(host_calls) == 3 and [names.count(n) for n in ("rollout.replay", "step.replay")] \
        == [4, 2]
    # a replay is advance, observe and the write-back, in that order
    for r in replays_:
        i = spans.index(r)
        kids = [s["name"] for s in spans if s["parent"] == i]
        assert kids == ["advance", "observe", "graph.writeback"]


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_eager_spans_nest_as_listed(name):
    _, recs = _run(*CLASSES[name], True)
    spans = _check_nesting(recs)
    assert sum(s["name"] == "advance" for s in spans) == 14 + 3
    assert sum(s["name"] == "rollout" for s in spans) == 1


def test_counters_equal_hand_counts():
    """reset.rows against the done rows the steps return, expert.live
    against the active expert slots of the state each step starts from;
    the computed counts are every row and every slot of every step."""
    cls, cfg = CLASSES["mixed"]
    env = cls(cfg, device="cpu")
    env.reset(seed=5)
    trace.enable()
    done = live = 0
    steps = 30
    for _ in range(steps):
        st = env._state
        live += int((env.scene.npc_expert[st.sidx.long()] & st.npc.active).sum())
        outs, _ = env.rollout(1, actions=_full(env), collect=("terminated", "truncated"))
        done += int((outs["terminated"] | outs["truncated"]).sum())
    counters = trace.records()["counters"]
    E, N = env._state.npc.active.shape
    assert done > 0 and live > 0
    assert counters == {"reset.rows": done, "reset.computed": E * steps,
                        "expert.live": live, "expert.computed": E * N * steps,
                        "camera.pixels": 0, "camera.boxes_live": 0, "camera.boxes_computed": 0}


def test_marl_counts_respawns_and_resets():
    """The roundabout's spawns: its respawn and its auto-reset each compute
    every row a step; the rows kept are at most those computed."""
    cls, cfg = CLASSES["marl"]
    env = cls(cfg, device="cpu")
    env.reset(seed=5)
    trace.enable()
    env.rollout(25, actions=_full(env))
    counters = trace.records()["counters"]
    assert counters["reset.computed"] == 2 * env.num_envs * 25
    assert 0 < counters["reset.rows"] <= counters["reset.computed"]
    assert counters["expert.computed"] == 0


def test_nothing_is_recorded_with_tracing_off(replays):
    for cls, cfg in (*CLASSES.values(), (T.MetaDriveEnv, IMAGE)):
        env = cls(cfg, device="cpu")
        env.reset(seed=5)
        env.rollout(3, actions=_full(env))
        env.step(_full(env))
    assert env._graphs._frame.key[-1] is False and env._graphs._rollout.key[4] is False
    recs = trace.records()
    assert recs["spans"] == [] and set(recs["counters"].values()) == {0}
    assert not trace._devices or all(not d.stamps for d in trace._devices.values())


def test_host_spans_reach_a_profiler_with_tracing_off():
    """Under torch.profiler a host span enters record_function, so the
    profiler's host events carry the program's step spans; the tracer
    records nothing."""
    from torch.profiler import ProfilerActivity, profile
    env = T.MetaDriveEnv(PG, device="cpu")
    env.reset(seed=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        env.step(_full(env))
        env.rollout(2, actions=_full(env))
    names = {e.name for e in prof.events()}
    assert {"env.step", "step.actions", "step.frame_obs", "step.outputs",
            "env.rollout"} <= names
    assert trace.records()["spans"] == []


def test_the_benchmark_readers_find_their_numbers(replays):
    """benchmarks/program_trace.py through the env alone: in a rollout cell
    the replay metrics, the useful shares and the gap; in a step cell the
    host ms of a step; nothing from an env without a tracer."""
    from benchmarks import program_trace as pt
    from benchmarks import yardstick
    cls, cfg = CLASSES["mixed"]
    env = cls(cfg, device="cpu")
    env.reset(seed=5)
    tr = yardstick.Trace(20, [], [], 0.0, 1.0, actions=_full(env))
    for name in ("advance", "observe", "advance.reset", "advance.traffic.expert"):
        assert pt.replay_ms(tr, env, name) > 0, name
    assert 0 <= pt.useful_pct(tr, env, "reset.rows", "reset.computed") <= 100
    assert 0 < pt.useful_pct(tr, env, "expert.live", "expert.computed") < 100
    assert 0 <= pt.replay_gap_pct(tr, env) < 100
    assert pt.host_ms(tr, env, "env.step") is None and not trace.enabled
    env = T.MetaDriveEnv(PG, device="cpu")
    env.reset(seed=5)
    tr = yardstick.Trace(20, [], [(yardstick.ENV_STEP, 0.0, 1.0)], 0.0, 1.0, actions=_full(env))
    assert pt.host_ms(tr, env, "env.step") > 0
    assert pt.replay_gap_pct(tr, env) is None
    assert pt.records(tr, object()) is None


def test_spans_need_no_profiler_flag(monkeypatch):
    """A step and a rollout, tracing off and on, where torch has no
    `_is_profiler_enabled` flag: the spans only stop entering
    record_function."""
    import torch.autograd.profiler as profiler
    monkeypatch.delattr(profiler, "_is_profiler_enabled")
    env = T.MetaDriveEnv(PG, device="cpu")
    env.reset(seed=5)
    env.step(_full(env))
    trace.enable()
    env.rollout(2, actions=_full(env))
    env.step(_full(env))
    trace.disable()
    assert sum(s["name"] == "env.step" for s in trace.records()["spans"]) == 1


def test_read_keeps_the_read_calls_alone():
    """`read`: the warm calls go on until ``settled`` holds (or ``wait_s``
    is spent), their records are dropped, the read calls' kept; tracing is
    off and nothing recorded after."""
    env = T.MetaDriveEnv(PG, device="cpu")
    env.reset(seed=5)
    calls = []

    def call():
        calls.append(len(calls))
        env.rollout(2, actions=_full(env))

    def settled(recs):
        assert sum(s["name"] == "rollout" for s in recs["spans"]) == 1
        return len(calls) == 3
    recs = trace.read(call, n=2, settled=settled, wait_s=60.0)
    assert len(calls) == 5 and not trace.enabled and trace.records()["spans"] == []
    assert sum(s["name"] == "rollout" for s in recs["spans"]) == 2
    assert recs["counters"]["reset.computed"] == 2 * 2 * env.num_envs
    calls.clear()
    trace.read(call, settled=lambda recs: False, wait_s=0.0)
    assert len(calls) == 2


def test_the_gap_is_read_at_the_cells_chunk(replays, monkeypatch):
    """Run as benchmarks/run.py runs a cell, the helper's read rollout is
    the cell's chunk, collecting the cell's fields."""
    from benchmarks import harness, program_trace as pt
    from benchmarks import yardstick
    monkeypatch.setattr(pt.sys, "argv", ["run.py", "--workload", "pg.rollout", "--seed", "1"])
    traffic = harness.Cell("pg.rollout").traffic
    monkeypatch.setitem(traffic, "chunk", 6)
    monkeypatch.setattr(harness, "Cell", lambda name: type("C", (), dict(traffic=traffic)))
    env = T.MetaDriveEnv(PG, device="cpu")
    env.reset(seed=5)
    tr = yardstick.Trace(20, [], [], 0.0, 1.0, actions=_full(env))
    assert 0 <= pt.replay_gap_pct(tr, env) < 100
    spans = pt.records(tr, env)["spans"]
    assert sum(s["name"] == "replay" for s in spans) == 6
    assert env._graphs._rollout.key[1] == tuple(traffic["collect"])


def test_a_traced_image_rollout_holds_the_camera_stages(replays):
    """A replayed rollout of an image env: each replay holds one `camera`
    span after `observe`, and each `camera` its row chunks' `camera.ground`
    and `camera.boxes`; a `step`'s frame graph holds a `camera` span of its
    own inside the step's host call. The counters: every pixel of every
    frame, and the live box pairs at most those computed."""
    env = T.MetaDriveEnv(IMAGE, device="cpu")
    env.reset(seed=5)
    trace.enable()
    env.rollout(2, actions=_full(env), collect=("obs", "image"))   # the captures
    env.step(_full(env))
    trace.clear()
    env.rollout(4, actions=_full(env), collect=("obs", "image"))
    env.step(_full(env))
    recs = trace.records()
    spans = _check_nesting(recs)
    replays_ = [i for i, s in enumerate(spans) if s["name"] == "replay"]
    assert len(replays_) == 5
    for i in replays_[:4]:
        kids = [s["name"] for s in spans if s["parent"] == i]
        assert kids == ["advance", "observe", "camera", "graph.writeback"]
    cams = [i for i, s in enumerate(spans) if s["name"] == "camera"]
    assert len(cams) == 5
    for i in cams:
        kids = [s["name"] for s in spans if s["parent"] == i]
        assert kids and kids == ["camera.ground", "camera.boxes"] * (len(kids) // 2)
    framed = [spans[i] for i in cams if spans[i]["parent"] is None]
    step = [s for s in spans if s["name"] == "env.step"]
    assert len(framed) == len(step) == 1
    assert step[0]["start_ns"] <= framed[0]["start_ns"] <= framed[0]["end_ns"] <= step[0]["end_ns"]
    c = recs["counters"]
    T_ = env._lidar_targets(env._state)[0][0].shape[1]
    frames, P = 4 + 1, 16 * 12
    assert c["camera.pixels"] == env.num_envs * P * frames
    assert c["camera.boxes_computed"] == env.num_envs * T_ * P * frames
    assert 0 < c["camera.boxes_live"] <= c["camera.boxes_computed"]


def test_the_camera_readers_find_their_numbers(replays, monkeypatch):
    """The camera cell's per-layer readers (benchmarks/metrics/camera_*.py)
    on an image env, reading rollouts of 6 steps: the span's ms, the live
    share of the box pairs, and the frame's share of its bound, between 0
    and 100."""
    from benchmarks import camera_work, harness, yardstick
    from benchmarks import program_trace as pt
    monkeypatch.setattr(pt, "STEPS", 6)
    env = T.MetaDriveEnv(IMAGE, device="cpu")
    env.reset(seed=5)
    tr = yardstick.Trace(20, [], [], 0.0, 1.0, actions=_full(env))
    ms = harness.metric_reader("camera_replay_ms")(tr, env)
    assert ms > 0
    assert 0 < harness.metric_reader("camera_useful_pct")(tr, env) <= 100
    share = harness.metric_reader("camera_roofline_pct")(tr, env)
    assert share == pytest.approx(100.0 * camera_work.frame_bound(env)[0] / ms)
    assert 0 < share < 100
    plain = T.MetaDriveEnv(PG, device="cpu")
    plain.reset(seed=5)
    tr = yardstick.Trace(20, [], [], 0.0, 1.0, actions=_full(plain))
    for name in ("camera_replay_ms", "camera_useful_pct", "camera_roofline_pct"):
        assert harness.metric_reader(name)(tr, plain) is None, name
