"""The benchmark never loads JAX or the JAX package, and its reference
loads nothing of the program.

Each check imports the modules in a fresh interpreter and reads
``sys.modules``, comparing whole top-level names (``dbot_ros_tpu_torch``
begins with ``dbot_ros_tpu``)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ["jax", "jaxlib", "flax", "dbot_ros_tpu"]


def _loaded_after(code: str):
    script = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"{code}\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                              "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    code = (
        "import importlib, pathlib\n"
        "import portbench.run\n"
        "from portbench.core import (calibrate, checks, peaks, readers,\n"
        "    report, runner, spec, trace, traffic)\n"
        "from portbench.reference import control\n"
        "for m in spec.bench()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "for p in sorted((spec.PKG / 'roofline').glob('*.py')):\n"
        "    spec.work_count(p.stem)\n"
        "import dbot_ros_tpu_torch.runtime.node\n"
        "import dbot_ros_tpu_torch.runtime.sources\n"
        "import dbot_ros_tpu_torch.trackers.particle\n"
        "import dbot_ros_tpu_torch.trackers.gaussian\n")
    loaded = _loaded_after(code)
    assert "portbench" in loaded and "dbot_ros_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = ("import pkgutil, importlib, portbench.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, r.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n")
    loaded = _loaded_after(code)
    assert "portbench" in loaded
    assert not loaded & set(FORBIDDEN + ["dbot_ros_tpu_torch"])
