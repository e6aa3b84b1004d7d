"""PyTorch port: runs where jax is absent.

A subprocess blocks jax (``sys.modules["jax"] = None`` makes any
``import jax`` raise), imports every module of the port and runs the slice
on a small CPU frame, on both clustering backends, and the frame's
obstacles through ``cluster_spatial`` on 2 x-band shards — as on the GPU
machine, which has no jax.
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
cell = cfg.replace(pipeline=dataclasses.replace(
    pcfg, clustering_backend="cellgraph", max_ambiguous_pairs=8192))
pay = device_frame_step_packed(torch.from_numpy(x), torch.from_numpy(m), cell)
cell_out = host_outputs_packed(pay, cell, xyz.shape[0], with_outlines=False)
assert cell_out.overflow == 0 and cell_out.num_clusters == out.num_clusters
assert np.array_equal(cell_out.cluster_labels, out.cluster_labels)
from lidar_processing_tpu_torch.config import SpatialConfig
from lidar_processing_tpu_torch.ops.stixel import cluster
from lidar_processing_tpu_torch.parallel.mesh import make_mesh
from lidar_processing_tpu_torch.parallel.spatial import cluster_spatial
obst = torch.zeros(4096, dtype=torch.bool)
obst[:xyz.shape[0]] = torch.from_numpy(out.seg_labels == 2)
scfg = SpatialConfig(block_points=4096, block_clusters=1024, halo_points=512,
                     block_cells=2048, block_columns=1024,
                     block_supernodes=2048, block_column_pairs=8192,
                     block_sn_pairs=8192)
sp = cluster_spatial(make_mesh(2, "space", device="cpu"), torch.from_numpy(x),
                     obst, cfg.clustering, pcfg, scfg)
one = cluster(torch.from_numpy(x), obst, cfg.clustering, pcfg)
assert torch.equal(sp.labels, one.labels) and int(sp.overflow) == 0
assert int(sp.num_clusters) == int(one.num_clusters) > 0
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
