"""A traced run of each cell at a small size on the card: every per-layer
metric of the cell reads a number, the device was busy, and the run is
correct."""
import pytest
import torch

from benchmarks import harness

SMALL = {"pg": dict(num_envs=64), "marl_roundabout": dict(num_envs=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pg.rollout", "marl_roundabout.rollout", "pg.step",
                                  "pg.expert_traffic"])
def test_a_traced_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.Cell(name)
    small = SMALL["marl_roundabout" if cell.config["env_class"].startswith("MultiAgent")
                  else "pg"]
    res = harness.run_cell(name, 11, 0.5, True, device="cuda", overrides=small,
                           log=lambda *a: None)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
