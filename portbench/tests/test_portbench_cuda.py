"""A small run of each cell on the card, judged as a full run is."""
import pytest

from portbench import harness
from portbench.judge import judge

MAN = harness.Manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN.data["workloads"]])
def test_small_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = harness.execute(MAN, cell, 31, 1.0, True, "cuda",
                          config_overrides={"points": 20000},
                          log=lambda s: None)
    assert run.summary.busy_s > 0
    v = judge(run, MAN.limits(cell))
    assert v.correct, v.checks
