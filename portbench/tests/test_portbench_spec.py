"""``BENCHMARK.json`` keeps to its contract, every file it names loads by
name, and a cell, a configuration, a mix and a per-layer metric can be
added as new files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.core import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    b = spec.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word
    n = len(b["workloads"])
    assert 1 <= n <= 24 and 1 <= len(b["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, n // 4)


def test_names_units_and_keys():
    b = spec.bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_enough():
    for w in spec.bench()["workloads"]:
        e2e = [m["name"] for m in spec.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = spec.per_layer(w["name"])
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_file_loads_by_name():
    b = spec.bench()
    for c in b["configs"]:
        conf = spec.config(c["name"])
        assert conf["tracker"] in ("particle", "gaussian")
        assert set(conf) >= {"settings", "assumed", "limits"}
    for w in b["workloads"]:
        params = spec.traffic(w["traffic"])
        assert params["loop"] in ("closed", "open")
        # configuration and mix agree on the tracked objects
        assert spec.objects(spec.config(w["config"]), params) >= 1
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    for kernel in ("fused_loglik", "lineage_gather"):
        mod = spec.work_count(kernel)
        assert mod.NAMES and callable(mod.work)


@pytest.fixture
def checkout_copy(tmp_path):
    """A checkout of the benchmark and the program (by link)."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    os.symlink(ROOT / "dbot_ros_tpu_torch", tmp_path / "dbot_ros_tpu_torch")
    return tmp_path


def test_a_cell_of_new_files_only(checkout_copy):
    """A throwaway configuration, mix and per-layer metric, added as new
    files and entries, run without touching a file that was there."""
    root = checkout_copy
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    conf = json.loads((root / "portbench/configs/pf_rbcpf_10k.json")
                      .read_text())
    conf["settings"]["evaluation_count"] = 128
    (root / "portbench/configs/pf_tiny.json").write_text(json.dumps(conf))
    mix = json.loads((root / "portbench/traffic/stream.json").read_text())
    mix.update(period_frames=40, warmup_frames=6)
    (root / "portbench/traffic/tiny_stream.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.window_frames))\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "pf_tiny", "source": "a test",
                         "file": "portbench/configs/pf_tiny.json",
                         "reduced": ["evaluation_count"], "why": "a test"})
    b["workloads"].append({"name": "tiny.stream", "config": "pf_tiny",
                           "traffic": "tiny_stream", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "frames_seen", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "trackers", "moves": "frames_per_s",
                           "workloads": ["tiny.stream"]})
    for m in b["end_to_end"]:
        if m["name"] in ("frames_per_s", "frame_ms_p95"):
            m["workloads"].append("tiny.stream")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from portbench.core import runner\n"
        "out = runner.run_cell('tiny.stream', 12345678901, 0.5, True,\n"
        "                      device='cpu')\n"
        "print(json.dumps(out['metrics']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["frames_seen"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
