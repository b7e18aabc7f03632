"""The harness on the CPU at tiny sizes: its files load by name, a new
metric is found with no edit, the last line has the contract's keys, the
import check compares whole top-level names, and the copied detector bound
agrees with its source."""
import importlib
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from benchmarks import guard, harness, run, yardstick

TINY = {"pg": dict(num_envs=4, num_scenarios=2), "marl_roundabout": dict(num_envs=1, num_agents=8)}
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def cells():
    return [w["name"] for w in harness.benchmark_spec()["workloads"]]


def tiny(name):
    spec = harness.benchmark_spec()
    return TINY[{w["name"]: w["config"] for w in spec["workloads"]}[name]]


@pytest.mark.parametrize("name", cells())
def test_cell_files_load_by_name(name):
    cell = harness.Cell(name)
    assert cell.config["env_class"] and cell.traffic["loop"] in harness.LOOPS
    floats = {f"{k}_gap" for k in cell.traffic.get("collect", ["obs", "reward"])
              if k not in ("terminated", "truncated")}
    assert set(cell.limits) == {"reset_gap", "done_mismatch"} | floats
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2, "set-up and one more metric"
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    for package in (harness.PROGRAM, harness.REFERENCE):
        cls = cell.traffic.get("env_class", cell.config["env_class"])
        assert hasattr(importlib.import_module(package), cls)


def test_a_new_metric_is_found_with_no_edit(tmp_path, monkeypatch):
    spec = harness.benchmark_spec()
    spec["per_layer"].append(dict(name="probe_metric", unit="calls/step", better="lower",
                                  source="device_trace", layer="Env API",
                                  moves="agent_steps_per_s", workloads=["pg.rollout"]))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "probe_metric.py").write_text(
        "def read(trace, env):\n    return trace.steps * 2.0\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    cell_dirs = ("configs", "traffic", "limits")
    for d in cell_dirs:
        (tmp_path / d).symlink_to(harness.CHECKOUT / "benchmarks" / d)
    cell = harness.Cell("pg.rollout", spec)
    assert "probe_metric" in [m["name"] for m in cell.per_layer]
    assert "probe_metric" not in [m["name"] for m in harness.Cell("pg.step", spec).per_layer]
    assert harness.metric_reader("probe_metric")(yardstick.Trace(20, [], [], 0.0, 1.0), None) == 40


def test_the_last_line_has_the_contract_keys(monkeypatch):
    real = harness.run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu stand-in")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: real(
        *a, **dict(k, device="cpu", overrides=TINY["pg"])))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "pg.rollout", "--seed", str(2 ** 31 + 5),
                       "--seconds", "0", "--trace", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == LINE_KEYS
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 128
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {m["name"] for m in harness.Cell("pg.rollout").end_to_end}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for v in line["check"].values():
        assert set(v) == {"value", "limit"}


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "pg.rollout", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


def test_the_import_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "metadrive_ped_tpu",
             "metadrive_ped_tpu.envs.base", "bench", "metadrive_ped_torch",
             "metadrive_ped_torch.ops.raycast", "benchmarks", "benchmarks.run", "benchmark",
             "jaxtyping", "flaxen", "bench_torch"]
    assert guard.blocked_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "metadrive_ped_tpu",
         "metadrive_ped_tpu.envs.base", "bench"])


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {})
    monkeypatch.setitem(sys.modules, "metadrive_ped_tpu", type(sys)("metadrive_ped_tpu"))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "pg.rollout", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "for n in ('metadrive_ped_torch', 'jax', 'flax', 'metadrive_ped_tpu', 'bench'):\n"
            "    sys.modules[n] = None\n"
            "import torch\n"
            "from benchmarks.reference import MetaDriveEnv\n"
            "env = MetaDriveEnv(dict(num_envs=2, map='SC', num_scenarios=1), device='cpu')\n"
            "env.reset(seed=0)\n"
            "env.rollout(2, actions=torch.tensor([[0.0, 1.0]] * 2))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("case", ["ragged_E_S_Bl", "n_cont_0_n_any_1", "Rs_0", "Rl_40",
                                  "adversarial"])
def test_the_copied_detector_bound_matches_its_source(case):
    chip_smoke = pytest.importorskip("chip_smoke")
    args = chip_smoke.to_device(chip_smoke.line_cases()[case](), "cpu")
    origin, sidx, side, lane, _, _, table, counts = args
    ours = yardstick.detector_bound(origin.shape[0], side[0].shape[1], lane[0].shape[1], sidx,
                                    table.numel(), counts)
    assert ours == chip_smoke.detector_bound(args)


def test_the_idle_share_reads_the_measured_window_alone():
    read = harness.metric_reader("device_idle_pct")
    trace = yardstick.Trace(20, [], [], 0.0, 1.0)
    assert read(trace, None) is None, "nothing where no step call was timed"
    trace.measured = dict(window_device_s=10.0, step_device_s=9.0)
    assert read(trace, None) == pytest.approx(10.0)
