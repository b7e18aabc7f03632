"""A run with the timed path broken underneath comes out not correct, a
step with a value that is not finite in a collected field counts as failed,
and the control (the reference in bfloat16) fails the cell's
limits, while the program's and the reference's own readings pass them. On
the CPU at tiny sizes; the run's look for a card is skipped
(`harness.run_cell`)."""
import pytest
import torch

from benchmarks import control, harness
from metadrive_ped_torch.core.structs import tree_map


def _wrap_advance(env, change):
    advance = env._advance

    def broken(state, actions, prev_obs=None):
        return change(state, advance(state, actions, prev_obs))
    env._advance = broken


def unchanged_state(env):
    """Each step returns the state it was given."""
    _wrap_advance(env, lambda old, out: (old, *out[1:]))


def half_batch(env):
    """The second half of the rows is left out of each step."""
    h = env.num_envs // 2

    def keep(new, old):
        if torch.is_tensor(new) and new.dim() and new.shape[0] == env.num_envs:
            return torch.cat([new[:h], old[h:]])
        return new
    _wrap_advance(env, lambda old, out: (tree_map(keep, out[0], old), *out[1:]))


def altered_answer(env):
    """One row's reward is altered where the step produces it."""
    def alter(old, out):
        reward = out[2].clone()
        reward[0] += 1.0
        return (*out[:2], reward, *out[3:])
    _wrap_advance(env, alter)


def nan_reward_once(env, call=5):
    """One row's reward is NaN in the ``call``-th step (the warm-up's step is
    the first, so the 5th is the measured window's 4th)."""
    calls = [0]

    def alter(old, out):
        calls[0] += 1
        if calls[0] != call:
            return out
        reward = out[2].clone()
        reward[0] = float("nan")
        return (*out[:2], reward, *out[3:])
    _wrap_advance(env, alter)


@pytest.mark.parametrize("cell,fault", [
    ("pg.rollout", unchanged_state), ("pg.rollout", half_batch),
    ("pg.rollout", altered_answer), ("pg.step", unchanged_state),
    ("marl_roundabout.rollout", altered_answer)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = harness.run_cell(cell, 3, 0.0, False, device="cpu",
                           overrides=harness.Cell(cell).config["tiny"], fault=fault,
                           log=lambda *a: None)
    assert res["correct"] is False, res["check"]


def test_a_step_with_a_nan_in_a_collected_field_counts_as_failed():
    """A NaN reward, not in ``obs``, in one step of the window: one failed
    step."""
    res = harness.run_cell("pg.rollout", 3, 0.0, False, device="cpu",
                           overrides=harness.Cell("pg.rollout").config["tiny"],
                           fault=nan_reward_once, log=lambda *a: None)
    assert res["attempted"] >= 128 and res["failed"] == 1


@pytest.mark.parametrize("cell", ["pg.rollout", "marl_roundabout.rollout"])
def test_the_control_fails_the_limits(cell):
    c = harness.Cell(cell)
    _, program, controls = control.readings(cell, [4, 5], [4, 5], ["bf16"], device="cpu",
                                            overrides=c.config["tiny"])
    for r in program:
        assert all(r[k] <= c.limits[k] for k in c.limits), r
    for r in controls:
        assert any(not r[k] <= c.limits[k] for k in c.limits), r
