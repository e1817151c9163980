"""The grasp-range configuration (``pf_rbcpf_10k_wide``, cell
``pf10k_wide.near_stream``) on the CPU at a size a test can hold: the
24 cm object at 0.55 m puts the fused sensor on its wide ladder level
(2,432 rows, 1,056 triangle slots at 80×60) on most frames, a sound run
is correct, and a fault that only the wide level shows is not. The
check's limits are the configuration's own (PERF.md §2)."""

import types

import pytest
import torch

from portbench.core import runner, spec

CELL = "pf10k_wide.near_stream"
SEED = 3_100_000_019
# a test-sized run: 512 particles, a shorter period and warm-up
SMALL = {"traffic": {"period_frames": 120, "warmup_frames": 8},
         "settings": {"evaluation_count": 512}}
# the tight level's packed triangle slots at 1,408 padded triangles
TIGHT_SLOTS = 288


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Four checked frames and one intra-op thread, as the other CPU runs
    of the harness take them."""
    monkeypatch.setattr(runner, "CHECKS", 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(factory=None, traced=False):
    return runner.run_cell(CELL, SEED, 6.0, traced, device="cpu",
                           overrides=SMALL, tracker_factory=factory,
                           log=lambda m: None)


def _tables_cut_to_the_tight_level(kind, settings, device):
    """The program with the packed triangle table cut to the tight level's
    slots: the slots past them hold zero constants, which miss. At the
    tight level nothing changes; at the wide level the object loses the
    triangles past them."""
    from dbot_ros_tpu_torch import config as cfg
    from dbot_ros_tpu_torch.ops.fused_sensor import FusedSensor
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    tracker = ParticleTracker(cfg.particle_config_from_dict(settings),
                              device=device)
    sensor = tracker.sensor

    def pack_selected(states, p_pad, uniq):
        gt = FusedSensor.pack_selected(sensor, states, p_pad, uniq)
        gt[TIGHT_SLOTS:] = 0.0
        return gt

    sensor.pack_selected = pack_selected
    return tracker


def test_a_sound_run_takes_the_wide_level_and_is_correct():
    """Traced, so that the per-layer metrics read the window: the wide
    level on most frames, each of them marked by the program's span; the
    row budgets the metrics count are the program's ladder."""
    made = []

    def program(kind, settings, device):
        made.append(runner.build_tracker(kind, settings, device))
        return made[-1]

    out = _run(program, traced=True)
    pixels = 80 * 60
    ours = spec.work_count("pixel_rows").pixel_caps(types.SimpleNamespace(
        settings=spec.config("pf_rbcpf_10k_wide")["settings"],
        num_pixels=pixels))
    assert ours == [p for p, _ in made[0].sensor.caps(pixels)] + [pixels]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True, out["checks"]
    assert out["info"]["checked_frames"] >= 2
    assert m["sensor.wide_level_share"] >= 0.7, m
    assert m["sensor.wide_calls_per_frame"] >= 0.7, m
    assert 0.0 < m["sensor.level_fill"] < 1.0, m


def test_a_table_cut_to_the_tight_level_is_not_correct():
    out = _run(_tables_cut_to_the_tight_level)
    assert out["info"]["checked_frames"] >= 2
    assert out["correct"] is False, out["checks"]
