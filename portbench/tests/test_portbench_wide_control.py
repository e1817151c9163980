"""The control comes out not correct at the grasp-range configuration
(``pf_rbcpf_10k_wide``, cell ``pf10k_wide.near_stream``): the reference
put in the program's place and computed with TF32 matrix products, on
three seeds, at a size a test run can hold. Needs the card (TF32 exists
only there):

    python -m pytest portbench/tests -m gpu -o addopts="" -q

The same readings at the cell's own size come from ``python3 -m
portbench.core.calibrate --workload pf10k_wide.near_stream --control``
(PERF.md)."""

import pytest
import torch

from portbench.core import runner
from portbench.reference import control

SEEDS = (1_600_000_003, 1_600_007_922, 1_600_015_841)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct_at_grasp_range(card, seed,
                                                    monkeypatch):
    monkeypatch.setattr(runner, "CHECKS", 4)
    out = runner.run_cell(
        "pf10k_wide.near_stream", seed, 1.0, False, device=card,
        overrides={"traffic": {"warmup_frames": 30},
                   "settings": {"evaluation_count": 4096}},
        tracker_factory=control.factory(control.obj_texts_from_settings),
        log=lambda m: None)
    assert out["info"]["checked_frames"] >= 2
    assert out["correct"] is False, out["checks"]
