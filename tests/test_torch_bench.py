"""The port's root programs against the JAX system's, on the CPU at small
widths: bench_torch.py against bench.py (every family's config equal and
its compiled pack or scene bit-equal; the scenario_replay family stepped
against JAX within tests/_torch_parity.py's tolerances; bench.py's last
line), the port's scaling table (metadrive_ped_torch/examples/
scaling_table.py: one row per device count) and
tools/expert_attribution_torch.py (the cause split against a numpy
transcription of tools/expert_attribution.py:60-73, the block names
against the JAX package's map generator)."""
import copy
import importlib.util
import json
import os
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from _torch_parity import assert_trees_close, np_tree, obs_gap, to_np

from metadrive_ped_torch.examples import scaling_table
from metadrive_ped_torch.scenario import recorder
from metadrive_ped_tpu import MetaDriveEnv as JaxPG
from metadrive_ped_tpu.mapgen.big import generate_map as jax_generate_map
from metadrive_ped_tpu.scenario import recorder as jax_recorder
from metadrive_ped_tpu.scenario.description import ScenarioDescription as JaxSD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
SCENARIOS = 2
WIDTH = dict(pg=4, safe=4, marl=2, marl_40=2, scenario=4, scenario_replay=4, scenario_recorded=4)
REPLAY_STEPS = 5
# the keys of bench.py's last line (bench.py:364-372)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench = _load("bench", "bench.py")
bench_torch = _load("bench_torch", "bench_torch.py")
attribution = _load("expert_attribution_torch", os.path.join("tools",
                                                             "expert_attribution_torch.py"))


def _assert_same(a, b, path="config"):
    """Two trees of dicts, lists and values equal, arrays with their dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


def _recorded_pair(monkeypatch):
    """The scenario_recorded family of both programs from one dataset. Each
    exports 100 steps of its own PG env; the exporters agree within 1e-4
    (tests/test_torch_scenario.py::test_export_matches_jax), so bench.py's
    exporter is handed the port's episodes and both ScenarioEnvs read the
    same scenarios. The two source envs must be built alike."""
    seen = {}

    def port_export(env, n_steps, **kw):
        out = real(env, n_steps, **kw)
        seen.update(env=env, n_steps=n_steps, sds=[copy.deepcopy(dict(sd)) for sd in out.values()])
        return out

    def jax_export(env, n_steps, **kw):
        assert not kw and n_steps == seen["n_steps"] == 100
        _assert_same(dict(env.config), dict(seen["env"].config), "source config")
        _assert_same(env._pack, seen["env"]._pack, "source pack")
        return {i: JaxSD(copy.deepcopy(sd)) for i, sd in enumerate(seen["sds"])}

    real = recorder.export_scenarios
    monkeypatch.setattr(recorder, "export_scenarios", port_export)
    te = bench_torch.make_env("scenario_recorded", WIDTH["scenario_recorded"], SCENARIOS, "cpu")
    monkeypatch.setattr(jax_recorder, "export_scenarios", jax_export)
    # the JAX source env's reset would only feed its exporter, replaced above
    monkeypatch.setattr(JaxPG, "reset", lambda self, seed=0: None)
    je = bench._make_env("scenario_recorded", WIDTH["scenario_recorded"], SCENARIOS)
    return je, te


def _step_replay(je, te):
    """REPLAY_STEPS full-throttle steps of both envs from seed 0: obs (the
    yaw-rate and lateral-offset features as `obs_gap` compares them) and
    reward within ATOL, flags equal."""
    side = te.config["vehicle_config"]["side_detector"]["num_lasers"]
    yaw, lat = side + 5, (side + 6, side + 7 + 18)
    (oj, _), (ot, _) = je.reset(seed=0), te.reset(seed=0)
    assert obs_gap(oj, ot, yaw, lat) <= ATOL
    act = np.tile(np.array([0.0, 1.0], np.float32), (te.num_envs, 1))
    for _ in range(REPLAY_STEPS):
        (oj, rj, tj, trj, _), (ot, rt, tt, trt, _) = je.step(act), te.step(act)
        assert obs_gap(oj, ot, yaw, lat) <= ATOL
        np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(to_np(tt), np.asarray(tj))
        np.testing.assert_array_equal(to_np(trt), np.asarray(trj))


@pytest.mark.parametrize("family", bench_torch.FAMILIES)
def test_make_env_matches_bench(family, monkeypatch):
    if family == "scenario_recorded":
        je, te = _recorded_pair(monkeypatch)
    else:
        je = bench._make_env(family, WIDTH[family], SCENARIOS)
        te = bench_torch.make_env(family, WIDTH[family], SCENARIOS, "cpu")
    jcfg, tcfg = dict(je.config), dict(te.config)
    if family == "scenario_recorded":
        # each program's own temporary dataset directory
        jcfg.pop("data_directory"), tcfg.pop("data_directory")
    _assert_same(jcfg, tcfg)
    assert te.num_envs == je.num_envs and te.device.type == "cpu"
    if family.startswith("scenario"):
        assert_trees_close(np_tree(je.scene), np_tree(te.scene), atol=0)
    else:
        _assert_same(je._pack, te._pack, "pack")
    if family == "scenario_replay":
        _step_replay(je, te)


def test_main_prints_bench_line(capsys):
    out = bench_torch.main(["--device", "cpu", "--config", "pg", "--num-envs", "4", "--steps", "3",
                            "--scenarios", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    last, family = json.loads(lines[-1]), json.loads(lines[-2])
    assert last == out and set(last) == BENCH_KEYS
    assert last["metric"] == "env_steps_per_s_1chip" and last["unit"] == "env-steps/s"
    assert last["value"] == round(family["rate"], 1) > 0
    assert last["vs_baseline"] == round(last["value"] / bench.REFERENCE_FPS, 2)
    assert lines[0] == "cpu"
    assert (family["family"], family["rows"], family["steps"], family["scenarios"]) == ("pg", 4, 3, 2)
    # on the CPU the wrapper takes the plain version: no kernel launch
    assert family["ray_segment_launches"] == 0 and family["device"] == "cpu"
    assert family["rate"] == pytest.approx(4 * 3 / family["seconds"])


def test_defaults_are_bench_defaults():
    args = bench_torch.parse_args([])
    assert (args.config, args.device, args.density) == ("all", "cuda", 0.05)
    assert bench_torch.DEFAULT_RUN == ("pg", "safe", "marl", "marl_40", "scenario",
                                       "scenario_replay")
    assert bench_torch.DEFAULT_ENVS == dict(pg=8192, safe=4096, marl=512, marl_40=256,
                                            scenario=4096, scenario_replay=4096,
                                            scenario_recorded=1024)
    assert bench_torch.REFERENCE_FPS == bench.REFERENCE_FPS


@pytest.mark.parametrize("entry", ["bench_torch", "scaling_table", "expert_attribution"])
def test_entry_points_need_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = dict(bench_torch=bench_torch.main, scaling_table=scaling_table.main,
                expert_attribution=attribution.main)[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--steps", "1"])


def test_scaling_table_rows(capsys):
    rows = scaling_table.main(["--device", "cpu", "--devices", "1", "2",
                               "--envs-per-device", "4", "--steps", "3"])
    assert [(n, total) for n, total, *_ in rows] == [(1, 4), (2, 8)]
    assert all(b > 0 and s > 0 for *_, b, s in rows)
    assert rows[0][2] == rows[0][3]  # one device: the unsharded run is the row
    out = capsys.readouterr().out.splitlines()
    runs = [json.loads(line) for line in out if line.startswith("{")]
    assert [(r["devices"], r["num_envs"], r["device"]) for r in runs] == [
        (1, 4, "cpu"), (1, 8, "cpu"), (2, 8, "cpu")]
    table = out[out.index("| devices | total envs | unsharded steps/s | sharded steps/s "
                          "| overhead |"):]
    assert len(table) == 2 + len(rows) and table[2].startswith("| 1 | 4 |")


def _tool_split(outs):
    """tools/expert_attribution.py:60-73, transcribed in numpy."""
    term = np.asarray(outs["terminated"]) | np.asarray(outs["truncated"])
    cause = np.where(
        np.asarray(outs["arrive_dest"]), 0,
        np.where(np.asarray(outs["crash_vehicle"]), 1,
                 np.where(np.asarray(outs["out_of_road"]), 2, 3)),
    )
    names = ["success", "crash_vehicle", "out_of_road", "timeout"]
    tot = Counter()
    per_seed = defaultdict(Counter)
    seeds = np.asarray(outs["env_seed"])
    for t, e in zip(*np.nonzero(term)):
        c = names[cause[t, e]]
        tot[c] += 1
        per_seed[int(seeds[t, e])][c] += 1
    return tot, per_seed


def test_attribution_split_matches_the_tool():
    rng = np.random.RandomState(0)
    steps, envs = 60, 24
    outs = {k: rng.rand(steps, envs) < p for k, p in (
        ("terminated", 0.08), ("truncated", 0.03), ("arrive_dest", 0.03), ("crash_vehicle", 0.04),
        ("out_of_road", 0.04))}
    outs["env_seed"] = rng.randint(0, 7, (steps, envs)).astype(np.int32)
    tot, per_seed = attribution.attribute(*(outs[k] for k in attribution.COLLECT))
    ref_tot, ref_seed = _tool_split(outs)
    assert tot == ref_tot and sum(tot.values()) > 20 and len(tot) == 4
    assert list(per_seed) == list(ref_seed) and per_seed == ref_seed
    lines = attribution.report(0.05, tot, per_seed, {s: "X" for s in per_seed})
    assert lines[0] == f"\n== density 0.05: {sum(tot.values())} episodes =="
    assert len(lines) == 2 + 4 + min(8, len(per_seed))


def test_attribution_block_names_match_jax():
    seeds = [0, 3, 11]
    names = attribution.block_names(seeds, 3)
    for s in seeds:
        _, blks = jax_generate_map(s, dict(config=3, lane_width=3.5, lane_num=3, exit_length=50.0))
        assert names[s] == "".join(b.ID for b in blks[1:]) and len(names[s]) == 3


def test_attribution_runs_on_cpu(capsys):
    results = attribution.main(["--device", "cpu", "--seeds", "2", "--envs", "2", "--steps", "5",
                                "--density", "0.0"])
    assert list(results) == [0.0]
    out = capsys.readouterr().out
    assert "== density 0.0:" in out and "worst seeds" in out
