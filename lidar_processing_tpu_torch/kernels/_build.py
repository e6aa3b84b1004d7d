"""Build the hand-written CUDA kernels at first use and load them by ctypes.

Every ``csrc/*.cu`` file compiles with nvcc into ONE shared library with a
plain C interface (no PyTorch headers, so the build takes seconds, not
minutes). The library lands in ``lidar_processing_tpu_torch/build/`` under
a name carrying a hash of the sources and flags, so a stale library is
never loaded. Nothing here runs at import time: the CPU tests import every
module on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (name, argtypes); each returns cudaGetLastError()
_ENTRIES = (
    ("min_d2_planar_launch", [_P] * 7 + [_I, _I, _I, _P]),
    ("union_find_launch", [_P] * 4 + [_I, _I, _P]),
)


class BuildInfo(NamedTuple):
    """Where the library came from: path, nvcc's log, build seconds
    (0.0 when an up-to-date library was already on disk)."""

    path: Path
    log: str
    seconds: float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build() -> BuildInfo:
    """Compile csrc/*.cu into build/ unless the hashed library exists."""
    out = BUILD_DIR / f"liblidar_kernels_{_digest()}.so"
    if out.exists():
        return BuildInfo(out, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return BuildInfo(out, proc.stdout + proc.stderr,
                     time.perf_counter() - t0)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
