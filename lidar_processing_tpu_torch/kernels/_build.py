"""Build the hand-written CUDA kernels at first use and load them by ctypes.

Every ``csrc/*.cu`` file compiles with its own nvcc process, all started
together, and the objects link into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds, not minutes).
The library lands in ``lidar_processing_tpu_torch/build/`` under
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (name, argtypes); each returns cudaGetLastError()
_ENTRIES = (
    ("min_d2_planar_launch", [_P] * 7 + [_I, _I, _I, _P]),
    ("union_find_launch", [_P] * 4 + [_I, _I, _I, _P]),
    ("tier_min_d2_launch", [_P, _I, _P, _P, _I] + [_P] * 4 + [_I, _I, _P]),
    ("uf_probe_launch", [_P] * 4 + [_I, _I, _P]),
    ("uf_serial_launch", [_P] * 4 + [_I, _I, _P]),
    ("uf_packed_launch", [_P] * 3 + [_I, _I, _P]),
    ("uf_packed_noskip_launch", [_P] * 3 + [_I, _I, _P]),
    ("pair_min_d2_v48_launch", [_P, _I, _I] + [_P] * 5 + [_I, _P]),
    ("pair_min_d2_v96_launch", [_P, _I, _I] + [_P] * 5 + [_I, _P]),
    ("gather_sum_launch", [_P, _P, _I, _I, _P, _I, _P]),
    ("slice_sum_launch", [_P, _P, _I, _I, _I, _I, _P, _P, _P]),
    ("tile_scale_launch", [_P, _P, _I, _P]),
    ("globaltimer_stamp_launch", [_P, _I, _I, _P]),
)
# each entry point's ctypes function, bound once by library()
_BOUND: dict = {}


class BuildInfo(NamedTuple):
    """Where a library came from: path, the compiler's log, build seconds
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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(procs):
    """Wait for every (cmd, Popen); raise on the first that failed."""
    log = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{stdout}{stderr}")
        log.append(stdout + stderr)
    return "".join(log)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


@functools.lru_cache(maxsize=1)
def build() -> BuildInfo:
    """Compile csrc/*.cu into build/ unless the hashed library exists."""
    out = BUILD_DIR / f"liblidar_kernels_{_digest()}.so"
    if out.exists():
        return BuildInfo(out, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{src.stem}.o") for src in _sources()]
        log = _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)])
                    for src, obj in zip(_sources(), objs)])
        tmp = os.path.join(work, "lib.so")
        log += _run([_start([nvcc, *LINK_FLAGS, "-o", tmp, *objs])])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return BuildInfo(out, log, time.perf_counter() - t0)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; binds every entry
    point's ctypes function (argtypes, restype) once, for launch(), through
    a PyDLL handle of the same library: its calls keep the GIL, as a call
    that only enqueues a kernel and returns need not release it."""
    path = str(build().path)
    lib = ctypes.CDLL(path)
    for handle, bound in ((lib, None), (ctypes.PyDLL(path), _BOUND)):
        for name, argtypes in _ENTRIES:
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            if bound is not None:
                bound[name] = fn
    return lib


def checked(name: str, *specs) -> torch.device:
    """Check (what, tensor, dtype, dim) specs — all on the first one's
    device, contiguous, of that dtype and rank — and return the device.
    Each tensor's attributes are read once."""
    dev = None
    for what, t, dtype, dim in specs:
        t_dtype, t_dev, t_dim = t.dtype, t.device, t.dim()
        if dev is None:
            dev = t_dev
        if t_dtype != dtype or t_dev != dev or t_dim != dim:
            raise ValueError(f"{name}: {what} must be {dim}-D {dtype} on "
                             f"{dev}, got {t_dim}-D {t_dtype} on {t_dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return dev


def launch(fn, entry: str, device, *args, stream=None) -> None:
    """Call C entry point `entry` with `args` (ints: pointers from
    data_ptr() and sizes) and `stream` (a raw stream as an int; by default
    the device's current stream); raise on a nonzero cudaError_t, else
    count the launch on the wrapper `fn`.

    The host's share of a call, cut to: a dict lookup of the bound ctypes
    function, the current device and the device's raw stream as ints (no
    Stream object; what PyTorch's own Triton launcher reads; CUDA builds
    of torch only), a device guard only when the tensor's device is not
    the current one, and the ctypes call (GIL kept)."""
    if not _BOUND:
        library()
    c_fn = _BOUND[entry]
    index = device.index
    if stream is None:
        stream = torch._C._cuda_getCurrentRawStream(index)
    if torch._C._cuda_getDevice() == index:
        rc = c_fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = c_fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc} at launch")
    fn.launches += 1
