"""The port's camera slice against the JAX package: `ops/camera.render` in
every modality, the nearest-box rule, the image-observation env (camera and
mini map, norm_pixel True and False, the frame stack), its observation
space, `env.render` in its three modes, and the examples that render.

Small sizes, as tests/test_camera.py: 2 envs on map "SSS", 32x24 images
(and one 84x84 frame). The JAX side runs jitted on the port's own states
(handed over through `core/convert.py`). Tolerances: depth within 1e-5,
rgb within 1e-5, semantic equal, instance within 1e-6 (the same colour:
the jitted JAX palette i / 255 rounds an ulp away from the division that
the port and the op-by-op order compute); a pixel may break them only
where a deciding distance (ground against box t, a box's silhouette, a
segment's distance against its half width, a lane's edge, the 1e-6
first-box rule) lies within 1e-5 m of its threshold in float64
(`obs/pixel_check.py::camera_margins`), and each such pixel is counted and
checked.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from _torch_parity import jax_tree, to_np

from metadrive_ped_torch import MetaDriveEnv as TorchEnv
from metadrive_ped_torch.core.convert import state_to_numpy
from metadrive_ped_torch.obs import render as trender
from metadrive_ped_torch.obs.pixel_check import (
    camera_margins, camera_mismatches, check_frame, grid,
)
from metadrive_ped_torch.ops import camera as tcam
from metadrive_ped_tpu import MetaDriveEnv as JaxEnv
from metadrive_ped_tpu.core.structs import SimState as JaxSimState
from metadrive_ped_tpu.ops import camera as jcam

BASE = dict(num_envs=2, map="SSS", num_scenarios=1, traffic_density=0.5)
TOL = dict(depth=1e-5, rgb=1e-5, semantic=0.0, instance=1e-6)
FULL = np.tile([0.0, 1.0], (2, 1)).astype(np.float32)


def image_cfg(modality="rgb", w=32, h=24, **over):
    return dict(BASE, image_observation=True, sensors=dict(main_camera=(modality, w, h)), **over)


@pytest.fixture(scope="module")
def scene():
    """The port's camera env stepped 5 times at full throttle (traffic
    ahead), and the JAX env of the same config (never stepped)."""
    tenv = TorchEnv(image_cfg(), device="cpu")
    tenv.reset(seed=0)
    for _ in range(5):
        tenv.step(FULL)
    return JaxEnv(image_cfg()), tenv


def _jax_render(jenv, js, w, h):
    cam = jenv.config["camera"]
    run = jax.jit(lambda st: jcam.render(
        jenv.scene, st.sidx, st.ego, *jenv._lidar_targets(st), jenv.scene.obj_kind[st.sidx],
        width=w, height=h, fov_deg=cam["fov"], pitch_deg=cam["pitch"],
        cam_height=cam["height"], max_dist=cam["max_dist"]))
    return {k: np.asarray(v) for k, v in run(js).items()}


@pytest.fixture(scope="module")
def frames(scene):
    """Both packages' frames of the same state at 32x24 and 84x84."""
    jenv, tenv = scene
    st = tenv._state
    js = jax_tree(JaxSimState, state_to_numpy(st))
    targets, _ = tenv._lidar_targets(st)
    out = {}
    for w, h in ((32, 24), (84, 84)):
        mine = tcam.render(tenv.scene, st.sidx, st.ego, targets, tenv._target_slices,
                           tenv.scene.obj_kind[st.sidx.long()], width=w, height=h)
        out[w, h] = (_jax_render(jenv, js, w, h), {k: to_np(v) for k, v in mine.items()},
                     camera_margins(tenv, st, w, h))
    return out


@pytest.mark.parametrize("size", [(32, 24), (84, 84)], ids=["32x24", "84x84"])
@pytest.mark.parametrize("modality", ["depth", "rgb", "semantic", "instance"])
def test_render_matches_jax(frames, modality, size):
    want, got, margins = frames[size]
    a, b = want[modality], got[modality]
    assert a.shape == b.shape == (2, size[1], size[0], 1 if modality == "depth" else 3)
    assert b.dtype == np.float32 and b.min() >= 0 and b.max() <= 1
    counted = camera_mismatches(a, b, margins, TOL[modality])
    assert counted <= 4, counted


def test_render_sees_the_scene(frames):
    """Sky above the horizon, road below, and traffic ahead as CAR pixels
    with their instance colours."""
    _, got, _ = frames[84, 84]
    sem = got["semantic"][0]
    is_cls = lambda c: (np.abs(sem - tcam.SEMANTIC_PALETTE[c]) < 1e-6).all(-1)
    assert is_cls(tcam.SEM_SKY)[:20].all()
    assert is_cls(tcam.SEM_ROAD)[50:].sum() > 500
    assert is_cls(tcam.SEM_CAR).any()
    assert (got["instance"][0][is_cls(tcam.SEM_CAR)] > 0).any(-1).all()
    np.testing.assert_array_equal(tcam.SEMANTIC_PALETTE, jcam.SEMANTIC_PALETTE)


def _box_case():
    """One camera, three rays; four boxes ahead on the first ray: box 1's
    near face 5e-7 m behind box 3's (the same within the 1e-6 rule), box 0
    inactive, box 2 far to the side."""
    d = np.array([[1.0, 0.0, -0.05], [1.0, 0.02, -0.05], [1.0, -0.3, 0.2]], np.float32)
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True))[None]
    origin = np.zeros((1, 2), np.float32)
    t_pos = np.array([[[1.5, 0.0], [1.5000005, 0.0], [1.5, 9.0], [1.5, 0.0]]], np.float32)
    t_heading = np.zeros((1, 4), np.float32)
    t_len = np.ones((1, 4), np.float32)
    t_wid = np.ones((1, 4), np.float32)
    t_hgt = np.full((1, 4), 1.5, np.float32)
    active = np.array([[False, True, True, True]])
    return origin, 1.4, dirs, t_pos, t_heading, t_len, t_wid, t_hgt, active


def test_box_hits_first_index_rule():
    """Two boxes within 1e-6: the lower index wins, as in JAX, where an
    argmin over t would pick box 3."""
    case = _box_case()
    jt, jidx = (np.asarray(x) for x in jcam._box_hits(*case))
    tt, tidx = tcam._box_hits(*(torch.as_tensor(x) if isinstance(x, np.ndarray) else x
                                for x in case))
    np.testing.assert_array_equal(to_np(tidx), jidx)
    np.testing.assert_allclose(to_np(tt), jt, rtol=0, atol=1e-6)
    assert jidx[0, 0] == 1 and to_np(tt)[0, 0] > 0.99
    tval = np.array([float(jcam._box_hits(*case[:3], *(x[:, [k]] for x in case[3:]))[0][0, 0])
                     for k in (1, 3)])
    assert 0 < tval[0] - tval[1] < 1e-6, "box 1 is the farther of the two"


SENSORS = {
    "rgb": image_cfg(stack_size=3),
    "rgb_uint8": image_cfg(stack_size=3, norm_pixel=False),
    "mini_map": dict(BASE, image_observation=True, stack_size=3, image_source="mini_map",
                     sensors=dict(mini_map=("mini_map", 64, 32))),
}


@pytest.mark.parametrize("name", sorted(SENSORS))
def test_image_observation_matches_jax(name):
    """5 steps with stack_size 3. Each step's frame is held against the JAX
    package's `_render_frame` on the same state, and the observation must
    equal bit for bit what the JAX env's own `_image_obs` (its uint8
    conversion and host frame stack, cleared on reset, newest last) makes
    of the port's frames; the state half is the port's state observation."""
    cfg = SENSORS[name]
    jenv, tenv = JaxEnv(cfg), TorchEnv(cfg, device="cpu")
    assert tenv.observation_space == jenv.observation_space
    modality, w, h = tenv._sensor_spec()
    frame_jit = jax.jit(jenv._render_frame)
    if modality == "mini_map":
        tex, origins = (to_np(x) for x in tenv._map_textures())
        fwd, side = grid(h, w, 50.0, look_ahead=20.0)
    obs, _ = tenv.reset(seed=0)
    assert (to_np(obs["image"])[..., :-1] == 0).all(), "reset fills the newest slot only"
    jenv._img_stack = None
    counted = 0
    for step in range(6):
        if step:
            obs, *_ = tenv.step(FULL)
        st = tenv._state
        mine = to_np(tenv._render_frame(st))
        js = jax_tree(JaxSimState, state_to_numpy(st))
        want_frame = np.asarray(frame_jit(js))
        if modality == "mini_map":
            counted += check_frame(want_frame, mine, "mini_map", state_to_numpy(st), tex,
                                   origins, fwd, side)
        else:
            counted += camera_mismatches(want_frame, mine, camera_margins(tenv, st, w, h),
                                         TOL[modality])
        jenv._state = js
        jenv._render_jit = lambda state, frame=mine: frame
        want = jenv._image_obs(np.asarray(to_np(obs["state"])))
        assert set(obs) == {"image", "state"}
        assert obs["state"] is tenv._last_obs
        got = to_np(obs["image"])
        assert got.dtype == want["image"].dtype and got.shape == want["image"].shape
        np.testing.assert_array_equal(got, want["image"], err_msg=f"step {step}")
        assert tenv.observation_space["image"].contains(got[0])
    assert counted <= 8, counted
    assert got[..., -1].std() > 0


@pytest.mark.parametrize("modality", ["depth", "semantic", "instance"])
def test_camera_modalities_step(modality):
    """The other camera modalities through the env, with their spaces."""
    cfg = image_cfg(modality)
    tenv = TorchEnv(cfg, device="cpu")
    assert tenv.observation_space == JaxEnv(cfg).observation_space
    obs, _ = tenv.reset(seed=0)
    for _ in range(2):
        obs, *_ = tenv.step(FULL)
    img = to_np(obs["image"])
    assert img.shape == (2, 24, 32, 1 if modality == "depth" else 3, 3)
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1


@pytest.fixture(scope="module")
def rendered(scene):
    """env.render of both packages on the port's state."""
    jenv, tenv = scene
    jenv._state = jax_tree(JaxSimState, state_to_numpy(tenv._state))
    out = {}
    for mode, kw in (("topdown", dict(size=256)), ("rgb_array", dict(width=64, height=36)),
                     ("dashboard", dict())):
        out[mode] = (np.asarray(jenv.render(mode, env_index=1, **kw)),
                     tenv.render(mode, env_index=1, **kw))
    return out


@pytest.mark.parametrize("mode", ["topdown", "rgb_array", "dashboard"])
def test_env_render_matches_jax(rendered, scene, mode):
    want, got = rendered[mode]
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if mode == "topdown":
        assert (got[128, 128] == trender.COLOR_EGO).all(), "the ego at the centre"


def test_env_render_errors():
    tenv = TorchEnv(dict(BASE, map="S"), device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        tenv.render()
    tenv.reset(seed=0)
    with pytest.raises(ValueError, match="unknown render mode"):
        tenv.render("hologram")
    for mode in ("top_down", "bev", "top_down_plt", "camera"):
        assert tenv.render(mode).dtype == np.uint8


def test_rollout_stays_state_only():
    tenv = TorchEnv(image_cfg(), device="cpu")
    tenv.reset(seed=0)
    outs, _ = tenv.rollout(2, actions=FULL, collect=("obs",))
    assert tuple(outs["obs"].shape) == (2, 2, tenv.observation_dim)


EXAMPLES = {
    "verify_image_observation": lambda d: ["--quick"],
    "generate_video_for_bev_and_interface": lambda d: ["--quick", "--out", d],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_camera_example_runs_on_the_cpu(name, tmp_path, capsys):
    module = importlib.import_module(f"metadrive_ped_torch.examples.{name}")
    assert module.main(EXAMPLES[name](str(tmp_path)) + ["--cpu"]) is not None
    assert capsys.readouterr().out.strip()
    if name.startswith("generate_video"):
        names = sorted(p.name for p in tmp_path.iterdir())
        assert [n.split(".")[0] for n in names] == ["0_bev", "0_interface"], names


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_camera_example_needs_a_gpu_without_cpu_flag(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"metadrive_ped_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(EXAMPLES[name](str(tmp_path)))

