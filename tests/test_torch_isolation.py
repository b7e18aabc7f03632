"""metadrive_ped_torch (its examples included) and chip_smoke.py stand
alone: they import neither jax, flax, metadrive_ped_tpu nor bench.py and
read no file of the JAX package (its rasterizer source and library
included), every env class (PG, safe, varying dynamics, scenario,
multi-agent, top-down, the mixed Waymo/PG env and the gym wrapper) needs an
explicit device="cpu" without a GPU, and chip_smoke.py refuses to run
without one. The blocked run drives the data-parallel layer (parallel/)
too."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import metadrive_ped_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "metadrive_ped_tpu", "bench")

_BLOCKED_RUN = f"""
import sys


def no_jax_package_files(event, args):
    # the port keeps its own copy of every file it reads (the expert
    # checkpoint among them)
    if event == "open" and "metadrive_ped_tpu" in str(args[0]):
        raise RuntimeError("read of a file of the JAX package: " + str(args[0]))


sys.addaudithook(no_jax_package_files)
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import numpy as np
from metadrive_ped_torch import MetaDriveEnv
env = MetaDriveEnv(dict(num_envs=4, map="SC", num_scenarios=2, traffic_density=0.1,
                        vehicle_config=dict(side_detector=dict(num_lasers=4),
                                            lane_line_detector=dict(num_lasers=3))),
                   device="cpu")
obs, _ = env.reset(seed=0)
for _ in range(5):
    obs, *_ = env.step(np.tile([0.0, 1.0], (4, 1)))
from metadrive_ped_torch import ScenarioEnv
from metadrive_ped_torch.scenario import export_scenarios
from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
env.reset(seed=0)
sources = dict(synthetic=[synthetic_waymo_sd(s, T=20, n_tracks=8, lane_pts=30) for s in range(2)],
               exported=list(export_scenarios(env, 12, actions=np.tile([0.0, 1.0], (4, 1))).values()))
for name, sds in sources.items():
    senv = ScenarioEnv(dict(num_envs=3, scenario_data=sds, reactive_traffic=True,
                            vehicle_config=dict(side_detector=dict(num_lasers=16))), device="cpu")
    sobs, _ = senv.reset(seed=0)
    for _ in range(25):
        sobs, *_ = senv.step(np.tile([0.0, 0.8], (3, 1)))
    assert bool(np.isfinite(sobs.numpy()).all())
    print("scenario", name, tuple(sobs.shape))
from metadrive_ped_torch import MultiAgentRoundaboutEnv, MultiAgentTollgateEnv
for cls in (MultiAgentRoundaboutEnv, MultiAgentTollgateEnv):
    menv = cls(dict(num_envs=2, num_agents=4), device="cpu")
    mobs, _ = menv.reset(seed=0)
    for _ in range(5):
        mobs, *_, minfo = menv.step(np.tile([0.0, 1.0], (2, 4, 1)))
    assert bool(np.isfinite(mobs.numpy()).all()) and tuple(minfo["__all__"].shape) == (2,)
    print("marl", cls.__name__, tuple(mobs.shape))
from metadrive_ped_torch.parallel import ShardedEnv, init_distributed, make_mesh
penv = ShardedEnv(MetaDriveEnv(dict(num_envs=4, map="S", num_scenarios=1, traffic_density=0.1),
                               device="cpu"), make_mesh(["cpu", "cpu"]))
pobs, _ = penv.reset(seed=0)
pobs, *_ = penv.step(np.tile([0.0, 1.0], (4, 1)))
assert init_distributed() == (0, 1)
print("sharded", tuple(pobs.shape), len(penv.shards))
from metadrive_ped_torch import MixedTrafficEnv
xenv = MixedTrafficEnv(dict(num_envs=2, map="S", traffic_density=0.3, rl_agent_ratio=0.5,
                            use_AI_protector=True, vehicle_config=dict(lidar=dict(num_others=4))),
                       device="cpu")
xobs, _ = xenv.reset(seed=0)
for _ in range(3):
    xobs, *_ = xenv.step(np.tile([0.0, 1.0], (2, 1)))
assert bool(np.isfinite(xobs.numpy()).all())
print("mixed", tuple(xobs.shape))
from metadrive_ped_torch import MixWaymoPGEnv, createGymWrapper
from metadrive_ped_torch.mapgen.opendrive import TWO_ROAD_XODR
from metadrive_ped_torch.policies.expert_torch import torch_expert_action
from metadrive_ped_torch.scenario.utils import draw_map
import importlib, os, tempfile
with tempfile.TemporaryDirectory() as d:
    xodr = os.path.join(d, "two_road.xodr")
    with open(xodr, "w") as f:
        f.write(TWO_ROAD_XODR)
    genv = createGymWrapper(MetaDriveEnv)(dict(num_envs=2, num_scenarios=1, traffic_density=0.1,
                                               map_config=dict(xodr_file=xodr)), device="cpu")
    gobs = genv.reset(seed=0)
    assert len(genv.step(np.tile([0.0, 1.0], (2, 1)))) == 4
    print("gym", genv.observation_space.shape, genv.action_space.shape)
    snap = genv.snapshot()
    rec = genv.record_episode(3)
    genv.replay_frame(rec, 1)
    genv.restore(snap)
    genv.set_break_down([0])
    genv.dump_all_maps(os.path.join(d, "maps.pkl"))
    draw_map(genv.get_map_features(0), save_path=os.path.join(d, "map.png"))
    print("expert", torch_expert_action(np.zeros((2, 275), np.float32), device="cpu").shape)
    for name in ("train_ppo", "procedural_generation", "verify_headless_installation"):
        importlib.import_module("metadrive_ped_torch.examples." + name)
    from metadrive_ped_torch.examples import train_ppo
    train_ppo.main(["--cpu", "--num-envs", "2", "--rollout", "4", "--iters", "1",
                    "--num-scenarios", "1", "--minibatches", "2"])
sds = [synthetic_waymo_sd(s, T=20, n_tracks=8, lane_pts=30) for s in range(2)]
mix = MixWaymoPGEnv(dict(num_envs=2, scenario_data=sds, map="S"), device="cpu")
for i in range(3):
    mix.reset(seed=i)
    mix.step(np.tile([0.0, 1.0], (2, 1)))
print("mix", mix.is_current_real_data)
from metadrive_ped_torch import TopDownMetaDrive
tenv = TopDownMetaDrive(dict(num_envs=2, map="S", num_scenarios=1), device="cpu")
tobs, _ = tenv.reset(seed=0)
tobs, *_ = tenv.step(np.tile([0.0, 1.0], (2, 1)))
print("top_down", tuple(tobs.shape))
cenv = MetaDriveEnv(dict(num_envs=2, map="S", num_scenarios=1, image_observation=True,
                         sensors=dict(main_camera=("rgb", 32, 24))), device="cpu")
cobs, _ = cenv.reset(seed=0)
cobs, *_ = cenv.step(np.tile([0.0, 1.0], (2, 1)))
frames = [cenv.render(m) for m in ("topdown", "rgb_array", "dashboard")]
print("camera", tuple(cobs["image"].shape), [f.shape for f in frames])
import chip_smoke
loaded = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not loaded, loaded
print("stepped", tuple(obs.shape))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT if cwd == ROOT else "")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_runs_with_jax_blocked():
    out = _run(["-c", _BLOCKED_RUN], ROOT)
    assert out.returncode == 0, out.stderr
    assert "stepped (4, 263)" in out.stdout
    for name in ("synthetic", "exported"):
        assert f"scenario {name} (3, 165)" in out.stdout
    assert "marl MultiAgentRoundaboutEnv (2, 4, 91)" in out.stdout
    assert "marl MultiAgentTollgateEnv (2, 4, 156)" in out.stdout
    assert "sharded (4, 259) 2" in out.stdout
    assert "mixed (2, 275)" in out.stdout
    assert "gym (259,) (2,)" in out.stdout and "expert (2, 2)" in out.stdout
    assert "mix " in out.stdout
    assert "top_down (2, 84, 84, 5)" in out.stdout
    assert "camera (2, 24, 32, 3, 3) [(512, 512, 3), (144, 256, 3), (80, 320, 3)]" in out.stdout


def _port_sources():
    pkg = os.path.join(ROOT, "metadrive_ped_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tools", "profile_torch_step.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            yield node.args[0].value


def test_no_source_imports_jax_or_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 20
    for path in sources:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in BLOCKED, (path, mod)


def _code_strings(path):
    """The string constants of a source file that are not docstrings."""
    tree = ast.parse(open(path).read(), path)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.value


def test_no_source_names_a_jax_package_path():
    """No code string of the package points into the JAX package (its
    assets included); chip_smoke.py names the TPU kernel each kernel
    replaces, as its output line must."""
    for path in _port_sources():
        if os.sep + "metadrive_ped_torch" + os.sep not in path:
            continue
        for value in _code_strings(path):
            assert "metadrive_ped_tpu" not in value, (path, value)


def test_default_device_needs_cuda(monkeypatch):
    from metadrive_ped_torch import MetaDriveEnv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MetaDriveEnv(dict(num_envs=2, map="S", traffic_density=0.0))
    with pytest.raises(RuntimeError):
        MetaDriveEnv(dict(num_envs=2, map="S", traffic_density=0.0), device="cuda")


def test_scenario_env_default_device_needs_cuda(monkeypatch):
    from metadrive_ped_torch import ScenarioEnv
    from metadrive_ped_torch.scenario.synthetic import synthetic_waymo_sd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sds = [synthetic_waymo_sd(0, T=10, n_tracks=4, lane_pts=20)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScenarioEnv(dict(num_envs=2, scenario_data=sds))
    with pytest.raises(RuntimeError):
        ScenarioEnv(dict(num_envs=2, scenario_data=sds), device="cuda")


@pytest.mark.parametrize("name", sorted(set(metadrive_ped_torch.__all__)
                                        - {"MetaDriveEnv", "ScenarioEnv", "CurriculumWrapper",
                                           "VERSION", "__version__"}))
def test_new_env_classes_default_device_needs_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(num_envs=1, num_scenarios=1, traffic_density=0.0)
    if name.startswith("MultiAgent"):
        cfg["num_agents"] = 2
    cls = getattr(metadrive_ped_torch, name)
    if name == "createGymWrapper":
        cls = cls(metadrive_ped_torch.MetaDriveEnv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(cfg)


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = _run(["chip_smoke.py"], ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # and alone, without the rest of the repository
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
