"""The harness on the CPU at tiny sizes: its files load by name, a new
metric and a new configuration with its own reference class are found with
no edit, the last line has the contract's keys, the import check compares
whole top-level names, and the copied detector bound agrees with its
source."""
import hashlib
import importlib
import importlib.util
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

import metadrive_ped_torch
from benchmarks import control, guard, harness, run, yardstick
from benchmarks import reference as reference_package

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def cells():
    return [w["name"] for w in harness.benchmark_spec()["workloads"]]


def reference_cells():
    """The first cell of each reference class that the cells resolve to."""
    first = {}
    for name in cells():
        first.setdefault(harness.Cell(name).reference_class(), name)
    return sorted(first.values())


@pytest.mark.parametrize("name", cells())
def test_cell_files_load_by_name(name):
    cell = harness.Cell(name)
    assert cell.config["env_class"] and cell.traffic["loop"] in harness.LOOPS
    assert {"tiny", "small"} <= set(cell.config), "the test sizes of the configuration"
    floats = {f"{k}_gap" for k in cell.traffic.get("collect", ["obs", "reward"])
              if k not in ("terminated", "truncated")}
    assert set(cell.limits) == {"reset_gap", "done_mismatch"} | floats
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2, "set-up and one more metric"
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert hasattr(importlib.import_module(harness.PROGRAM), cell.env_class)
    assert isinstance(cell.reference_class(), type)
    if not any("reference_class" in f for f in (cell.config, cell.traffic)):
        assert cell.reference_class() is getattr(reference_package, cell.env_class)


def test_a_new_metric_is_found_with_no_edit(new_files):
    _, spec = new_files
    spec["per_layer"].append(dict(name="probe_metric", unit="calls/step", better="lower",
                                  source="device_trace", layer="Env API",
                                  moves="agent_steps_per_s", workloads=["pg.rollout"]))
    (new_files[0] / "metrics" / "probe_metric.py").write_text(
        "def read(trace, env):\n    return trace.steps * 2.0\n")
    cell = harness.Cell("pg.rollout", spec)
    assert "probe_metric" in [m["name"] for m in cell.per_layer]
    assert "probe_metric" not in [m["name"] for m in harness.Cell("pg.step", spec).per_layer]
    assert harness.metric_reader("probe_metric")(yardstick.Trace(20, [], [], 0.0, 1.0), None) == 40


PROBE_FIELD = "ego_speed_kmh"
PROBE_REFERENCE = f'''"""A configuration's own reference env: the reference's MetaDriveEnv
that also collects the ego's speed in km/h."""
from benchmarks.reference.envs.metadrive_env import MetaDriveEnv


class ProbeEnv(MetaDriveEnv):
    def _rollout_fields(self, state):
        return dict(super()._rollout_fields(state), {PROBE_FIELD}=state.ego.speed * 3.6)
'''


class ProbeProgramEnv(metadrive_ped_torch.MetaDriveEnv):
    """The program's side of the probe configuration."""

    def _rollout_fields(self, state):
        return dict(super()._rollout_fields(state), **{PROBE_FIELD: state.ego.speed * 3.6})


def _benchmark_files():
    """The digest of every file of the checkout's benchmark and of
    BENCHMARK.json."""
    files = [harness.CHECKOUT / "BENCHMARK.json"] + sorted(
        f for f in (harness.CHECKOUT / "benchmarks").rglob("*")
        if f.is_file() and "__pycache__" not in f.parts)
    return {f: hashlib.sha256(f.read_bytes()).hexdigest() for f in files}


def test_a_new_configuration_with_its_own_reference_runs_with_no_edit(new_files, monkeypatch):
    """A configuration, traffic mix, limits and reference class added as new
    files alone run `correct` through `run_cell` and `control.readings`."""
    root, spec = new_files
    before = _benchmark_files()
    module = "benchmarks.reference.probe_env"
    (root / "probe_env.py").write_text(PROBE_REFERENCE)
    loader = importlib.util.spec_from_file_location(module, root / "probe_env.py")
    monkeypatch.setitem(sys.modules, module, importlib.util.module_from_spec(loader))
    loader.loader.exec_module(sys.modules[module])
    monkeypatch.setattr(metadrive_ped_torch, "ProbeEnv", ProbeProgramEnv, raising=False)
    config = json.loads((root / "configs" / "pg.json").read_text())
    config.update(env_class="ProbeEnv", reference_class="probe_env:ProbeEnv")
    traffic = json.loads((root / "traffic" / "rollout.json").read_text())
    traffic["collect"].append(PROBE_FIELD)
    limits = dict(json.loads((root / "limits" / "pg.rollout.json").read_text()),
                  **{f"{PROBE_FIELD}_gap": 1e-4})
    for path, data in (("configs/probe.json", config), ("traffic/probe.json", traffic),
                       ("limits/probe.rollout.json", limits)):
        (root / path).write_text(json.dumps(data))
    spec["configs"].append(dict(name="probe", source="https://example.org/probe",
                                file="benchmarks/configs/probe.json", reduced=[],
                                why="a probe"))
    spec["workloads"].append(dict(name="probe.rollout", config="probe", traffic="probe",
                                  chips=1, why="a probe"))

    cell = harness.Cell("probe.rollout")
    assert cell.reference_class() is sys.modules[module].ProbeEnv
    res = harness.run_cell("probe.rollout", 2 ** 31 + 9, 0.0, False, device="cpu",
                           overrides=cell.config["tiny"], log=lambda *a: None)
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    assert f"{PROBE_FIELD}_gap" in res["check"]
    _, program, controls = control.readings("probe.rollout", [4], [4], ["bf16"], device="cpu",
                                            overrides=cell.config["tiny"])
    assert all(r[k] <= cell.limits[k] for r in program for k in cell.limits), program
    assert any(not controls[0][k] <= cell.limits[k] for k in cell.limits), controls
    assert _benchmark_files() == before, "no file that exists was edited"


def test_the_last_line_has_the_contract_keys(monkeypatch):
    real = harness.run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu stand-in")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: real(
        *a, **dict(k, device="cpu", overrides=harness.Cell("pg.rollout").config["tiny"])))
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


@pytest.mark.parametrize("name", reference_cells())
def test_the_reference_imports_nothing_of_the_program(name):
    """The reference class that cell ``name`` resolves to runs two steps at
    the configuration's tiny size in a process that cannot import the
    program or JAX."""
    code = ("import sys\n"
            "for n in ('metadrive_ped_torch', 'jax', 'flax', 'metadrive_ped_tpu', 'bench'):\n"
            "    sys.modules[n] = None\n"
            "import torch\n"
            "from benchmarks import harness\n"
            f"cell = harness.Cell({name!r})\n"
            "env = cell.build(harness.REFERENCE, 'cpu', cell.config['tiny'])\n"
            "env.reset(seed=0)\n"
            "env.rollout(2, actions=torch.tensor([[0.0, 1.0]]).expand(env.num_envs, 2))\n")
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
