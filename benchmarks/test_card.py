"""A traced run of each cell at a small size on the card: every per-layer
metric of the cell reads a number, the device was busy, and the run is
correct."""
import pytest
import torch

from benchmarks import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_a_traced_run_on_the_card(name):
    """Cell ``name`` at its configuration's ``small`` size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.Cell(name)
    res = harness.run_cell(name, 11, 0.5, True, device="cuda", overrides=cell.config["small"],
                           log=lambda *a: None)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
