"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

The sources have a plain C interface, so one ``nvcc`` call builds them
into a shared library in seconds, without PyTorch's headers. The library
goes to ``build/kernels/`` at the repository root (listed in
``.gitignore``), named after a hash of the sources and flags, so an edit
to a source rebuilds it and an unchanged tree reuses it. A failed build
raises with nvcc's stderr.

Run ``python -m dbot_ros_tpu_torch.ops.build`` to build ahead of use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "fused_loglik.cu", "pixel_rows.cu", "lineage_gather.cu"))
BUILD_DIR = _PKG.parent / "build" / "kernels"
# No --use_fast_math (NaN tests and exact division must survive);
# -fmad=false rounds op by op like the plain PyTorch versions.
# --threads 0 compiles the sources side by side.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "--threads", "0", "-shared",
              "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "dbot_fused_loglik_groups": [_I, _I, _I],
    "dbot_fused_loglik_bf16": [_VP] * 11 + [_I] * 4 + [_VP],
    "dbot_fused_loglik_f32": [_VP] * 11 + [_I] * 4 + [_VP],
    "dbot_gather_pixel_rows": [_VP, _VP, _VP, _I, _I, _LL, _I, _I, _I, _I,
                               _VP],
    "dbot_scatter_pixel_rows": [_VP, _VP, _VP, _I, _LL, _VP],
    "dbot_age_pixel_rows": [_VP] * 4 + [_LL, _LL, _I, _VP],
    "dbot_lineage_gather_b16": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "dbot_lineage_gather_b32": [_VP, _VP, _VP, _I, _I, _I, _VP],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (set CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdbot_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with every entry typed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    print(build(verbose=True))
