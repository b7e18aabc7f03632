"""The port's top-down slice against the JAX package: the host rasterizer,
the baked map textures, `observe_top_down` / `observe_mini_map`, the three
top-down envs, and the examples that draw top-down frames.

Small sizes: 2 envs on map "CS" (a circular lane and a straight one), 2
scenarios. The JAX side runs on the port's own states (handed over through
`core/convert.py`), op by op (`eager`): under jit, XLA on the CPU contracts
the pixel grid's world coordinates (pos + fwd * hv + side * rv) into fused
multiply-adds, a different rounding from the op-by-op order that both
packages write and the port runs. Tolerances (`obs/pixel_check.py`):
textures and origins bit-equal (the same C++ source built with the same g++
flags); the sampled layers (road, route) within 1e-5, except pixels whose
float32 texture coordinate rounds apart (cos and sin of the heading may
differ by an ulp between the packages) and where the difference is within
8 ulps of the coordinate times the texel step there; the stamped layers
(other vehicles, ego box, past positions) equal except pixels within 1e-5 m
of a box edge in float64. Each excepted pixel is counted and checked.
"""
import importlib
import os

import jax
import numpy as np
import pytest
import torch
from _torch_parity import jax_tree, to_np

from metadrive_ped_torch import TopDownMetaDrive as TorchTopDown
from metadrive_ped_torch import TopDownMetaDriveEnvV2 as TorchTopDownV2
from metadrive_ped_torch import TopDownSingleFrameMetaDriveEnv as TorchSingle
from metadrive_ped_torch.core import cuda_build
from metadrive_ped_torch.core.convert import state_to_numpy
from metadrive_ped_torch.native import rasterize_polylines as torch_raster
from metadrive_ped_torch.obs import top_down as ttd
from metadrive_ped_torch.obs.pixel_check import check_frame, grid
from metadrive_ped_tpu.core.structs import SimState as JaxSimState
from metadrive_ped_tpu.envs.top_down_env import TopDownMetaDrive as JaxTopDown
from metadrive_ped_tpu.envs.top_down_env import TopDownMetaDriveEnvV2 as JaxTopDownV2
from metadrive_ped_tpu.envs.top_down_env import TopDownSingleFrameMetaDriveEnv as JaxSingle
from metadrive_ped_tpu.native import rasterize_polylines as jax_raster
from metadrive_ped_tpu.obs import top_down as jtd


def eager(fn):
    """fn run op by op, its result as numpy."""
    def run(*args):
        with jax.disable_jit():
            return np.asarray(fn(*args))
    return run


CFG = dict(num_envs=2, map="CS", num_scenarios=2, traffic_density=0.4, traffic_mode="respawn")
def capsule_cases():
    """(grid shape, origin, res, polylines, widths) from a seeded rng, and
    the JAX test's single horizontal capsule."""
    rng = np.random.default_rng(7)
    cases = [((100, 100), (0.0, 0.0), 1.0, [np.array([[10, 50], [90, 50]], np.float32)], [10.0])]
    for _ in range(4):
        polys = [rng.uniform(-5, 65, size=(int(rng.integers(2, 6)), 2)).astype(np.float32)
                 for _ in range(int(rng.integers(1, 5)))]
        widths = rng.uniform(0.2, 7.0, size=len(polys)).tolist()
        cases.append(((80, 120), tuple(rng.uniform(-3, 3, 2)), 0.5, polys, widths))
    return cases


@pytest.mark.parametrize("case", range(5))
def test_rasterizer_matches_jax(case):
    shape, origin, res, polys, widths = capsule_cases()[case]
    a, b = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    jax_raster(a, origin, res, polys, widths)
    torch_raster(b, origin, res, polys, widths, value=1.0)
    np.testing.assert_array_equal(a, b)
    assert b.sum() > 0
    if case == 0:
        assert 800 <= int((b > 0).sum()) <= 1100  # 80 x 10 core + end caps


def test_rasterizer_raises_without_a_compiler(monkeypatch, tmp_path):
    """No numpy fallback: a missing g++ or a failed build raises."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_libs", {})
    grid = np.zeros((10, 10), np.float32)
    poly = [np.array([[1, 1], [8, 8]], np.float32)]
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        torch_raster(grid, (0, 0), 1.0, poly, [2.0])
    monkeypatch.undo()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_libs", {})
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "td_raster.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "NATIVE", tmp_path / "native")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        torch_raster(grid, (0, 0), 1.0, poly, [2.0])
    assert not (grid > 0).any()


@pytest.fixture(scope="module")
def pair():
    """A JAX env (never stepped: its scene and pack only), the port's env of
    the same config, the port stepped 8 times, and the JAX state of it."""
    jenv, tenv = JaxSingle(CFG), TorchSingle(CFG, device="cpu")
    tenv.reset(seed=0)
    for _ in range(8):
        tenv.step(np.tile([0.1, 1.0], (2, 1)))
    return jenv, tenv, jax_tree(JaxSimState, state_to_numpy(tenv._state))


def test_textures_bit_equal(pair):
    jenv, tenv, _ = pair
    jt, jo = jtd.bake_map_textures(jenv._pack, 2)
    tt, to = tenv._map_textures()
    assert tt.device.type == "cpu" and tuple(tt.shape[:2]) == (2, 3)
    np.testing.assert_array_equal(np.asarray(jt), to_np(tt))
    np.testing.assert_array_equal(np.asarray(jo), to_np(to))
    assert (to_np(tt)[:, 0] > 0).mean() > 0.05, "drivable area baked"


@pytest.mark.parametrize("which", ["top_down", "mini_map"])
def test_observation_matches_jax(pair, which):
    jenv, tenv, js = pair
    ts, tree = tenv._state, state_to_numpy(tenv._state)
    jt, jo = jtd.bake_map_textures(jenv._pack, 2)
    tt, to = tenv._map_textures()
    if which == "top_down":
        a = eager(lambda st: jtd.observe_top_down(jt, jo, st.sidx, st.ego, st.npc,
                                                  st.ego.past_pos))(js)
        b = to_np(ttd.observe_top_down(tt, to, ts.sidx, ts.ego, ts.npc, ts.ego.past_pos))
        fwd, side = grid(84, 84, 50.0)
    else:
        a = eager(lambda st: jtd.observe_mini_map(jt, jo, st.sidx, st.ego, st.npc))(js)
        b = to_np(ttd.observe_mini_map(tt, to, ts.sidx, ts.ego, ts.npc))
        fwd, side = grid(84, 168, 50.0, look_ahead=20.0)
    counted = check_frame(a, b, which, tree, to_np(tt), to_np(to), fwd, side)
    assert counted <= 8, counted
    assert b[..., 0].max() > 0.5, "road in view"
    assert b[..., 3 if which == "top_down" else 1].sum() > 0, "ego stamped"


def test_stamps_are_chunked_over_rows(pair, monkeypatch):
    """A chunk smaller than one row's [H, W, N] stamps row by row, with the
    same result."""
    _, tenv, _ = pair
    ts = tenv._state
    tt, to = tenv._map_textures()
    whole = ttd.observe_top_down(tt, to, ts.sidx, ts.ego, ts.npc, ts.ego.past_pos)
    monkeypatch.setattr(ttd, "STAMP_CHUNK_ELEMENTS", 1)
    rows = ttd.observe_top_down(tt, to, ts.sidx, ts.ego, ts.npc, ts.ego.past_pos)
    torch.testing.assert_close(rows, whole, rtol=0, atol=0)


ENV_PAIRS = {"single_frame": (JaxSingle, TorchSingle), "stacked": (JaxTopDown, TorchTopDown),
             "v2": (JaxTopDownV2, TorchTopDownV2)}


@pytest.mark.parametrize("name", sorted(ENV_PAIRS))
def test_top_down_env_matches_jax(name):
    """10 steps of the port's env (horizon 6: every row finishes at step 6
    and auto-resets). Each step's frame (the single-frame observation the
    step computed) is held against the JAX package's `observe_top_down` on
    the same state (`check_frame`); the stacked envs' observation must equal
    bit for bit what the JAX env's own `_assemble` (its host ring, cleared
    on reset, rolled, refilled where a row is done, newest first) makes of
    the port's frames."""
    jcls, tcls = ENV_PAIRS[name]
    cfg = dict(CFG, horizon=6)
    jenv, tenv = jcls(cfg), tcls(cfg, device="cpu")
    assert tenv.observation_dim == jenv.observation_dim
    assert tenv.observation_space == jenv.observation_space
    assert (tenv.config["vehicle_config"]["lidar"]["num_lasers"]
            == jenv.config["vehicle_config"]["lidar"]["num_lasers"])
    jt, jo = jtd.bake_map_textures(jenv._pack, 2)
    tt, to = to_np(tenv._map_textures()[0]), to_np(tenv._map_textures()[1])
    res, dist = jenv.config["resolution"], jenv.config["max_distance"]
    frame = eager(lambda st: jtd.observe_top_down(jt, jo, st.sidx, st.ego, st.npc,
                                                  st.ego.past_pos, resolution=res,
                                                  max_distance=dist))
    fwd, side = grid(res, res, dist)
    stacked = hasattr(jenv, "_assemble")
    obs, _ = tenv.reset(seed=0)
    jenv._tf_stack = None
    done, dones, counted = None, 0, 0
    for step in range(11):
        if step:
            obs, _, te, tr, _ = tenv.step(np.tile([0.05, 1.0], (2, 1)))
            done = to_np(te | tr)
            dones += int(done.sum())
        tree = state_to_numpy(tenv._state)
        mine = to_np(tenv._last_obs)
        counted += check_frame(frame(jax_tree(JaxSimState, tree)), mine, "top_down", tree, tt, to,
                               fwd, side)
        got = to_np(obs)
        assert got.shape == (2,) + tuple(jenv.observation_dim) and got.dtype == np.float32
        want = jenv._assemble(mine, done) if stacked else mine
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
    assert dones >= 2, "the horizon ended every row's episode"
    assert counted <= 20, counted


EXAMPLES = {
    "draw_maps": lambda d: ["--quick", "--out", os.path.join(d, "maps.png")],
    "top_down_metadrive": lambda d: ["--quick"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_top_down_example_runs_on_the_cpu(name, tmp_path, capsys):
    module = importlib.import_module(f"metadrive_ped_torch.examples.{name}")
    assert module.main(EXAMPLES[name](str(tmp_path)) + ["--cpu"]) is not None
    assert capsys.readouterr().out.strip()
    if name == "draw_maps":
        assert any(p.name.startswith("maps.png") for p in tmp_path.iterdir())


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_top_down_example_needs_a_gpu_without_cpu_flag(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"metadrive_ped_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(EXAMPLES[name](str(tmp_path)))
