"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; a
configuration's ``file`` is its JSON under ``portbench/configs/``; a mix
is ``portbench/traffic/<traffic>.json``; a per-layer metric's reader is
``portbench/metrics/<name>.py``; a kernel's work count is
``portbench/roofline/<kernel>.py``. Adding any of these is adding files
and entries: nothing here names one.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"


@functools.lru_cache(maxsize=1)
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in bench()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(name: str) -> dict:
    for c in bench()["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """The configuration's file: ``tracker`` (its kind), ``settings``
    (the tracker's configuration as its YAML sets it) and ``assumed``
    (what the benchmark sets itself: the mesh, the precision)."""
    return json.loads((ROOT / config_entry(name)["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def _applies(metric: dict, cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def end_to_end(cell: str) -> list:
    """The cell's end-to-end metrics, in ``BENCHMARK.json``'s order."""
    return [m for m in bench()["end_to_end"] if _applies(m, cell)]


def per_layer(cell: str) -> list:
    """The cell's per-layer metrics: those that list it, and those
    without a list that move an end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(cell)}
    return [m for m in bench()["per_layer"] if _applies(m, cell, reported)]


def _load(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def reader(metric: str):
    """The module whose ``read(run)`` gives ``metric`` (None: nothing to
    read in this run)."""
    return _load(PKG / "metrics" / f"{metric}.py",
                 "portbench_metric_" + metric.replace(".", "_"))


@functools.lru_cache(maxsize=None)
def work_count(kernel: str):
    """The module that counts ``kernel``'s work: ``NAMES`` (substrings of
    its device operations' names in the trace) and ``work(run, frame)``
    → (operations, bytes) the problem needs for the frame's calls."""
    return _load(PKG / "roofline" / f"{kernel}.py",
                 "portbench_roofline_" + kernel)
