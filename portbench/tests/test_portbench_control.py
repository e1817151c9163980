"""The control comes out not correct: the reference put in the program's
place and computed with TF32 matrix products (the precision below the
configurations' float32 with TF32 off), on three seeds, at a size a test
run can hold. Needs the card (TF32 exists only there):

    python -m pytest portbench/tests -m gpu -o addopts="" -q

The same readings at each cell's own size come from
``python3 -m portbench.core.calibrate --control`` (PERF.md)."""

import pytest
import torch

from portbench.core import runner
from portbench.reference import control

SEEDS = (1_500_000_001, 1_500_007_920, 1_500_015_839)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pf10k.stream", "rgf6.stream",
                                  "pf10k.live30hz"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(card, cell, seed, monkeypatch):
    monkeypatch.setattr(runner, "CHECKS", 4)
    overrides = {"traffic": {"warmup_frames": 30}}
    if cell.startswith("pf"):
        overrides["settings"] = {"evaluation_count": 4096}
    out = runner.run_cell(
        cell, seed, 1.0, False, device=card, overrides=overrides,
        tracker_factory=control.factory(control.obj_text_from_settings),
        log=lambda m: None)
    assert out["info"]["checked_frames"] >= 2
    assert out["correct"] is False, out["checks"]
