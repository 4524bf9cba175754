"""``correct`` on small runs of each cell on the CPU (the harness's look
for a card skipped): true for the port as it is, false with the timed
path broken underneath, and false for the control, the reference computed
in TF32 in the program's place. The limits are the cells' own."""
import pytest
import torch

from portbench import calibrate, harness
from portbench.judge import judge

MAN = harness.Manifest()
CELLS = [w["name"] for w in MAN.data["workloads"]]
SMALL = {"points": 3000}


def _verdict(cell, seed=20240613):
    run = harness.execute(MAN, cell, seed, 0.2, False, "cpu",
                          config_overrides=SMALL, log=lambda s: None)
    return judge(run, MAN.limits(cell), workers=1)


def _half_of_the_batch(monkeypatch):
    """Every masked sum over half of its valid rows, scaled up to all of
    them: half the points left out, the mean taken over the rest."""
    from open_pcc_metric_tpu_torch.ops import fused

    original = fused._masked_sum

    def half(x, mask):
        keep = mask & (torch.cumsum(mask.long(), 0) <= (mask.sum() + 1) // 2)
        return original(x, keep) * (mask.sum() / keep.sum()).to(x.dtype)

    monkeypatch.setattr(fused, "_masked_sum", half)


def _answer_altered(monkeypatch):
    """One entry of each table off by a part in a thousand where the
    table is made."""
    from open_pcc_metric_tpu_torch.ops import fused

    original = fused.finalize_stats

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        out["geo_mse_left"] = out["geo_mse_left"] * 1.001
        return out

    monkeypatch.setattr(fused, "finalize_stats", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    v = _verdict(cell)
    assert v.correct, v.checks


@pytest.mark.parametrize("fault", [_half_of_the_batch, _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    v = _verdict(cell)
    assert not v.correct, v.checks
    assert v.checks["failed"]["value"] > 0


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_is_not_correct(cell, seed):
    row = calibrate.control_reading(MAN, cell, seed, SMALL, workers=1)
    limits = MAN.limits(cell)
    assert any(row[k] > limits[k] for k in ("d1_db", "d2_db", "color_db")), \
        row
