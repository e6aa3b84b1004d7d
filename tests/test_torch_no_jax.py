"""PyTorch port: runs where jax is absent.

A subprocess blocks jax (``sys.modules["jax"] = None`` makes any
``import jax`` raise), imports every module of the port and runs the slice
on a small CPU frame — as on the GPU machine, which has no jax.
"""

import pathlib
import subprocess
import sys

import lidar_processing_tpu_torch

_PKG = pathlib.Path(lidar_processing_tpu_torch.__file__).resolve().parent
_REPO = _PKG.parent

_SCRIPT = r"""
import dataclasses, importlib, pkgutil, sys
sys.modules["jax"] = None
import numpy as np, torch
import lidar_processing_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.runtime.pipeline import (
    device_frame_step_packed, host_outputs_packed)
pcfg = dataclasses.replace(
    DEFAULT_CONFIG.pipeline, max_points=4096, max_obstacle_points=4096,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192)
cfg = DEFAULT_CONFIG.replace(pipeline=pcfg)
xyz, inten = street_scene(0, "small")
x, m = pad_frame(xyz, 4096)
pay = device_frame_step_packed(torch.from_numpy(x), torch.from_numpy(m), cfg)
out = host_outputs_packed(pay, cfg, xyz.shape[0], intensity=inten)
assert out.overflow == 0 and len(out.outlines) == out.num_clusters > 0
assert sys.modules["jax"] is None
assert not any(k.startswith(("jax.", "jaxlib", "lidar_processing_tpu."))
               for k in sys.modules)
print("MODULES", len(names), "CLUSTERS", out.num_clusters)
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=_REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    modules = int(proc.stdout.split("MODULES")[1].split()[0])
    assert modules >= 20, proc.stdout


def test_no_port_source_imports_jax():
    for path in _PKG.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
