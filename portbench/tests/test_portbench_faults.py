"""The check fails a run whose timed path is broken underneath: a run of
the harness on the CPU (its look for a card skipped) at a size a test
can hold, with a fault planted in the program's tracker, must come out
not correct. The faults a cell of this benchmark can have: a step that
returns its state unchanged, half of the particles left out of the mean,
and an answer altered where it is produced. (One chip: no exchange
between chips to leave out.)

The command itself refuses to run without a card and prints no result.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.core import runner

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"traffic": {"period_frames": 60, "warmup_frames": 8}}
# the CPU runs the window's frames slowly (tens of ms a particle frame at
# 512 particles, hundreds a Gaussian one): a smaller step and a window
# long enough for the sampled frames to be reached under a loaded CPU
SETTINGS = {"particle": {"evaluation_count": 512},
            "gaussian": {"pixel_stride": 4}}
SECONDS = {"particle": 3.0, "gaussian": 5.0}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread: the suite's workers share the CPU, and a
    Gaussian step whose small linear algebra fights another worker for
    every core runs too few frames to reach the sampled ones. Four
    checked frames, as few as a slow window reaches."""
    monkeypatch.setattr(runner, "CHECKS", 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(cell, factory, seed=31_000_000_007, seconds=None):
    kind = "particle" if cell.startswith("pf") else "gaussian"
    overrides = {"traffic": dict(SMALL["traffic"]),
                 "settings": SETTINGS[kind]}
    return runner.run_cell(cell, seed, seconds or SECONDS[kind], False,
                           device="cpu", overrides=overrides,
                           tracker_factory=factory, log=lambda m: None)


def _particle_fault(fault):
    from dbot_ros_tpu_torch.filters import rbcpf
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
    from dbot_ros_tpu_torch.utils import se3

    class Faulty(ParticleTracker):
        def _step(self, belief, z, dt, generator):
            if fault == "unchanged":
                old = belief.clone()
                _, info = super()._step(belief, z, dt, generator)
                return old, dataclasses.replace(
                    info, mean_state=rbcpf.summarize(
                        old, torch.zeros_like(old.log_weights),
                        info.resampled, info.kl).mean_state)
            new, info = super()._step(belief, z, dt, generator)
            if fault == "half":
                h = new.states.shape[0] // 2
                w = torch.softmax(new.log_weights[:h], dim=0)
                ms = se3.states_mean(new.states[:h], w)
            else:                                    # "altered"
                ms = info.mean_state.clone()
                ms[:, 0] += 0.002
            return new, dataclasses.replace(info, mean_state=ms)

    def make(kind, settings, device):
        from dbot_ros_tpu_torch import config as cfg
        return Faulty(cfg.particle_config_from_dict(settings),
                      device=device)
    return make


def _gaussian_fault(fault):
    from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker

    class Faulty(GaussianTracker):
        def _step(self, belief, z, dt, learn_world=True):
            new, info = super()._step(belief, z, dt, learn_world)
            if fault == "unchanged":
                return belief, info
            mean = new.mean.clone()
            mean[0] += 0.002
            return dataclasses.replace(new, mean=mean), info

    def make(kind, settings, device):
        from dbot_ros_tpu_torch import config as cfg
        return Faulty(cfg.gaussian_config_from_dict(settings),
                      device=device)
    return make


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_particle_step_is_not_correct(fault):
    out = _run("pf10k.stream", _particle_fault(fault))
    assert out["info"]["checked_frames"] >= 2
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_gaussian_step_is_not_correct(fault):
    out = _run("rgf6.stream", _gaussian_fault(fault))
    assert out["info"]["checked_frames"] >= 2
    assert out["correct"] is False, out["checks"]


def test_a_sound_particle_run_is_correct():
    out = _run("pf10k.stream", None)
    assert out["correct"] is True, out["checks"]


def test_a_sound_gaussian_run_is_correct():
    out = _run("rgf6.stream", None)
    assert out["correct"] is True, out["checks"]


def test_the_command_needs_a_card():
    """Without CUDA the command exits non-zero and prints no result;
    nothing measured on the CPU is written under a device metric."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pf10k.stream",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_cpu_run_names_its_platform():
    out = _run("pf10k.stream", None, seconds=0.3)
    assert out["device"]["platform"] == "cpu"
    assert "busy_s" not in out["device"]
