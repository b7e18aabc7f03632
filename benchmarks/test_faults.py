"""A run with the timed path broken underneath comes out not correct, and
the control (the reference in bfloat16) fails the cell's limits, while
the program's and the reference's own readings pass them. On the CPU at
tiny sizes; the run's look for a card is skipped (`harness.run_cell`)."""
import pytest
import torch

from benchmarks import control, harness
from metadrive_ped_torch.core.structs import tree_map

TINY = {"pg": dict(num_envs=4, num_scenarios=2), "marl_roundabout": dict(num_envs=1, num_agents=8)}


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


@pytest.mark.parametrize("cell,fault", [
    ("pg.rollout", unchanged_state), ("pg.rollout", half_batch),
    ("pg.rollout", altered_answer), ("pg.step", unchanged_state),
    ("marl_roundabout.rollout", altered_answer)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    cfg = harness.Cell(cell).config
    overrides = TINY["marl_roundabout" if cfg["env_class"].startswith("MultiAgent") else "pg"]
    res = harness.run_cell(cell, 3, 0.0, False, device="cpu", overrides=overrides, fault=fault,
                           log=lambda *a: None)
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", ["pg.rollout", "marl_roundabout.rollout"])
def test_the_control_fails_the_limits(cell):
    c = harness.Cell(cell)
    overrides = TINY["marl_roundabout" if c.config["env_class"].startswith("MultiAgent") else "pg"]
    _, program, controls = control.readings(cell, [4, 5], [4, 5], ["bf16"], device="cpu",
                                            overrides=overrides)
    for r in program:
        assert all(r[k] <= c.limits[k] for k in c.limits), r
    for r in controls:
        assert any(not r[k] <= c.limits[k] for k in c.limits), r
