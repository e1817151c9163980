"""Build and load the native host runtime (host_runtime.cpp) with g++.

The library is built at first use into ``build/native/`` at the
repository root (listed in ``.gitignore``), named after a hash of the
source, the compiler flags and the host CPU: ``-march=native`` code runs
only on the kind of CPU that built it, and a checkout copied to another
machine must not load a library built elsewhere. An unchanged source on
the same machine reuses the library. A failed build raises with g++'s
stderr; nothing falls back.

Run ``python -m dbot_ros_tpu_torch.native.build`` to build ahead of use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "host_runtime.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-Wall")

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # name: (restype, argtypes)
    "dbot_parse_obj": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_VP),
                                      ctypes.POINTER(_LL),
                                      ctypes.POINTER(_VP),
                                      ctypes.POINTER(_LL)]),
    "dbot_free": (None, [_VP]),
    "dbot_preprocess_depth": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_uint16), _LL, _LL, _LL, _LL, ctypes.c_float,
        _FP]),
    "dbot_ring_create": (_VP, [_LL, _LL]),
    "dbot_ring_destroy": (None, [_VP]),
    "dbot_ring_push": (ctypes.c_int, [_VP, _FP, ctypes.c_double]),
    "dbot_ring_pop_latest": (_LL, [_VP, _FP,
                                   ctypes.POINTER(ctypes.c_double)]),
    "dbot_ring_size": (_LL, [_VP]),
}


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the source."""


def _cpu_signature() -> str:
    """What ``-march=native`` depends on: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [ln for ln in fh
                     if ln.startswith(("model name", "flags"))][:2]
        return "".join(lines)
    except OSError:
        return platform.machine() + platform.processor()


def compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise NativeBuildError("g++ not found (set CXX)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_signature().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdbot_host_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the source unless the library for its hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    if verbose:
        print(" ".join(cmd))
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with every entry typed.
    Calls through ``ctypes.CDLL`` release the interpreter lock."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


if __name__ == "__main__":
    print(build(verbose=True))
