"""Build the host C++ module at first use and load it by ctypes.

``lidar_native.cpp`` (a copy of the JAX package's native module) compiles
with g++ and the JAX Makefile's flags, plus ``-pthread`` for the thread
pool of ``chi_hulls_batch``, into ONE shared library with a plain C
interface. The library lands in ``lidar_processing_tpu_torch/build/`` under
a name carrying a hash of the source, the flags and the host CPU as g++'s
``-march=native`` resolves it, so a library built for another CPU (the
build directory may travel with a copy of the checkout) or from an older
source is never loaded. Nothing here runs at import time.

There is no fallback: a failed build raises with g++'s log, and a library
that lacks an entry point raises naming it.
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

from ..kernels._build import BuildInfo

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "lidar_native.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-pthread")

_F = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_i32, _i64, _u32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32
_f32, _f64 = ctypes.c_float, ctypes.c_double
# C entry points: (name, restype, argtypes)
_ENTRIES = (
    ("convex_hull", _i32, [_F, _i32, _I32P, _i32]),
    ("chan_convex_hull", _i32, [_F, _i32, _I32P, _i32]),
    ("chi_concave_hull", _i32, [_F, _i32, _f64, _I32P, _i32]),
    ("chi_hulls_batch", None, [_F, _I64P, _i32, _f64, _I32P, _I32P, _i32]),
    ("union_find_cc", None, [_I32P, _I32P, _i64, _i32, _I32P]),
    ("radius_cc", _i32, [_F, _i32, _f32, _I32P]),
    ("fec_cluster", _i32, [_F, _i32, _f64, _f64, _u32, _u32, _I32P]),
)


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host C++ module "
                           "(native/lidar_native.cpp) needs a C++ compiler")
    return found


def host_target(cxx: str) -> str:
    """What ``-march=native`` means on this host for this compiler: the
    compiler's version and the target options it resolves to."""
    out = []
    for args in (["-dumpfullversion"],
                 ["-march=native", "-Q", "--help=target"]):
        proc = subprocess.run([cxx, *args], capture_output=True, text=True,
                              check=False)
        out.append(proc.stdout)
    return "".join(out)


def _digest(cxx: str) -> str:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(host_target(cxx).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build() -> BuildInfo:
    """Compile lidar_native.cpp into build/ unless the hashed library
    exists; raise with g++'s log if the compiler fails."""
    cxx = _cxx()
    out = BUILD_DIR / f"liblidar_native_{_digest(cxx)}.so"
    if out.exists():
        return BuildInfo(out, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return BuildInfo(out, proc.stdout + proc.stderr,
                     time.perf_counter() - t0)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded host module, built first if needed."""
    path = build().path
    lib = ctypes.CDLL(str(path))
    for name, restype, argtypes in _ENTRIES:
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise RuntimeError(f"{path.name} has no entry point {name}: "
                               f"delete it and build again") from None
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
