"""The camera cell pg_rgb84.rollout on the CPU at its configuration's tiny
size: a run is `correct` with the image compared (gap 0.0), a run with the
frame broken underneath is not, the control (the reference in bfloat16)
fails the limits, and the frame's bound (camera_work.py) agrees with its
source, chip_smoke.py's `camera_bound`."""
import pytest
import torch

from benchmarks import camera_work, control, harness

CELL = "pg_rgb84.rollout"


def _tiny():
    return harness.Cell(CELL).config["tiny"]


def test_a_run_of_the_camera_cell_is_correct():
    res = harness.run_cell(CELL, 2 ** 31 + 77, 0.0, False, device="cpu", overrides=_tiny(),
                           log=lambda *a: None)
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    assert res["attempted"] >= 16
    limit = harness.Cell(CELL).limits["image_gap"]
    assert res["check"]["image_gap"] == dict(value=0.0, limit=limit)


def _dark_frames(env):
    """Every rendered frame a little darker, where the env makes it."""
    frame = env._frame
    env._frame = lambda state: frame(state) * 0.999


def test_a_broken_frame_is_not_correct():
    res = harness.run_cell(CELL, 3, 0.0, False, device="cpu", overrides=_tiny(),
                           fault=_dark_frames, log=lambda *a: None)
    assert res["correct"] is False and res["check"]["image_gap"]["value"] > 0, res["check"]
    for k in ("reset_gap", "obs_gap", "reward_gap"):
        assert res["check"][k]["value"] == 0.0, k


def test_the_control_fails_the_image_limit():
    c = harness.Cell(CELL)
    _, program, controls = control.readings(CELL, [4, 5], [4, 5], ["bf16"], device="cpu",
                                            overrides=_tiny())
    for r in program:
        assert all(r[k] <= c.limits[k] for k in c.limits), r
        assert r["image_gap"] == 0.0
    for r in controls:
        assert r["image_gap"] >= 4 * c.limits["image_gap"], r


@pytest.mark.parametrize("shape", [(1024, 84 * 84, 36, 470, 30), (64, 84 * 84, 36, 470, 30),
                                   (2, 32 * 24, 36, 148, 12), (7, 100, 1, 1, 0),
                                   (1, 4, 0, 0, 0)])
def test_the_copied_camera_bound_matches_its_source(shape):
    chip_smoke = pytest.importorskip("chip_smoke")
    assert camera_work.camera_bound(*shape) == chip_smoke.camera_bound(*shape)


def test_the_frame_bound_counts_the_pairs_that_can_count():
    """On the tiny env: the ground pixels are the lower half of a camera
    at pitch 0, and the counted pairs are at most the padded ones."""
    cell = harness.Cell(CELL)
    env = cell.build(harness.PROGRAM, "cpu", _tiny())
    env.reset(seed=3)
    _, w, h = cell.env_config(_tiny())["sensors"]["main_camera"]
    assert camera_work.ground_pixels(w, h, 66.0, 0.0, 1.4) == w * h // 2
    pixels, lanes, segments, boxes = camera_work.frame_pairs(env)
    E, P = env.num_envs, w * h
    L, B = env.scene.lane_kind.shape[1], env.scene.seg_type.shape[1]
    T = env._lidar_targets(env._state)[0][0].shape[1]
    assert pixels == E * P
    assert 0 < lanes < E * P * L and 0 < segments < E * P * B and 0 <= boxes <= E * P * T
    assert camera_work.frame_bound(env)[0] < camera_work.camera_bound(E, P, L, B, T)[0]
    assert torch.is_tensor(env._img_stack)
