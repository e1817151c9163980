"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; a
configuration's ``file`` is its JSON under ``portbench/configs/``; a mix
is ``portbench/traffic/<traffic>.json``; a per-layer metric's reader is
``portbench/metrics/<name>.py``; a kernel's work count is
``portbench/roofline/<kernel>.py``. Adding any of these is adding files
and entries: nothing here names one.

A scene holds K >= 1 tracked objects. A configuration's ``assumed`` gives
either ``mesh`` (one object) or ``meshes`` (a list, one spec per object,
in the tracker's object order); a spec's ``kind`` is ``ellipsoid`` (the
default: an icosphere of ``subdivisions`` stretched to ``semi_axes_m``)
or ``box`` (side lengths ``size_m``). A mix gives either ``motion`` (one
object) or ``motions`` (one per object, in the same order); a motion may
carry ``offset_m`` (x, y, z), added to its sway. A cell whose
configuration and mix count different objects is refused
(:func:`objects`), and so is one of K > 1 objects with a Gaussian
configuration or a ``native`` (live camera) mix: neither is supported.
Nor is K > 2: the check's recovery of the program's resampling parents
(``reference/pf.py``) is written and read for one block before the last.
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


def _one_or_list(d: dict, one: str, many: str, what: str) -> list:
    if (one in d) == (many in d):
        raise ValueError(f"{what} must give exactly one of {one!r} and "
                         f"{many!r}")
    if one in d:
        return [d[one]]
    if not isinstance(d[many], list) or not d[many]:
        raise ValueError(f"{what}: {many!r} must be a non-empty list")
    return list(d[many])


def meshes(conf: dict) -> list:
    """The mesh specs of a configuration, one per tracked object."""
    return _one_or_list(conf["assumed"], "mesh", "meshes",
                        "a configuration's 'assumed'")


def motions(params: dict) -> list:
    """The motions of a mix, one per tracked object."""
    return _one_or_list(params, "motion", "motions", "a traffic mix")


def objects(conf: dict, params: dict) -> int:
    """K, the number of tracked objects of a cell, once its configuration
    and its mix agree on it and the cell's path supports it."""
    k, m = len(meshes(conf)), len(motions(params))
    if k != m:
        raise ValueError(
            f"the configuration tracks {k} object(s) but the mix moves "
            f"{m}: give 'assumed.meshes' and the mix's 'motions' one entry "
            "per object")
    if k > 1 and conf["tracker"] != "particle":
        raise ValueError(f"{k} objects with a {conf['tracker']!r} tracker: "
                         "only the particle tracker takes several objects")
    if k > 2:
        raise ValueError(f"{k} objects: the check recovers the resampling "
                         "parents of one block before the last, so a scene "
                         "holds at most 2")
    if k > 1 and params.get("resolution") == "native":
        raise ValueError(f"{k} objects with a 'native' (live camera) mix: "
                         "the live path takes one object")
    return k


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
