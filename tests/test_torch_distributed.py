"""PyTorch port: the parallel entry points over 4 gloo ranks on the CPU.

ONE launch of 4 rank processes for the module (a module-scoped fixture,
``parallel/launch.py::spawn``: spawn start method, a file rendezvous under
pytest's tmp dir, a timeout that fails the test instead of hanging the
suite) runs every call of ``_calls()`` on every rank:

  * ``cluster_spatial`` on 8 shards as 4 ranks x 2;
  * ``cluster_spatial_2d`` on the 2 x 4 mesh as 2 data x 2 space ranks x
    2 shards;
  * ``sharded_batch_step`` of 4 frames over 4 ranks;
  * ``device_frame_step_spatial`` on 8 shards as 4 ranks x 2
    (segmentation included: the moment partials of every band are summed
    in band order, so the layout does not change a bit).

Every rank's result must equal the in-process 1 rank x 8 shards result of
the same call bit for bit (the module imports no jax: the ranks import
only the port).
"""

import dataclasses

import numpy as np
import pytest

from lidar_processing_tpu_torch.config import DEFAULT_CONFIG, SpatialConfig
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.parallel import launch
from lidar_processing_tpu_torch.parallel.frame_spatial import \
    device_frame_step_spatial
from lidar_processing_tpu_torch.parallel.sharded import sharded_batch_step
from lidar_processing_tpu_torch.parallel.spatial import (cluster_spatial,
                                                         cluster_spatial_2d)

RANKS = 4
SCFG = SpatialConfig(block_points=2048, block_clusters=512, halo_points=512,
                     block_cells=2048, block_columns=1024,
                     block_supernodes=1536, block_column_pairs=4096,
                     block_sn_pairs=4096, block_live_edges=1024)
CFG = DEFAULT_CONFIG.replace(spatial=SCFG, pipeline=dataclasses.replace(
    DEFAULT_CONFIG.pipeline, max_points=4096, max_obstacle_points=4096,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192))


def _blobs(rng):
    rail = rng.uniform([-30, 0, 0], [30, 0.1, 0.1], (1000, 3))
    centers = rng.uniform([-25, -25, -1], [25, 25, 1], (250, 3))
    blobs = rng.normal(0, 0.15, (1000, 3)) + np.repeat(centers, 4, axis=0)
    return pad_frame(np.concatenate([rail, blobs]).astype(np.float32), 4096)


def _calls():
    rng = np.random.default_rng(5)
    bx, bm = (np.stack(a) for a in zip(*(_blobs(rng) for _ in range(2))))
    sx, sm = (np.stack(a) for a in zip(*(
        pad_frame(street_scene(s, "small")[0], 4096) for s in range(4))))
    cl = (CFG.clustering, CFG.pipeline, SCFG)
    return {
        "cluster_spatial 4x2": (cluster_spatial, {"space": 8},
                                (bx[0], bm[0], *cl)),
        "cluster_spatial_2d 2x2x2": (cluster_spatial_2d,
                                     {"data": 2, "space": 4}, (bx, bm, *cl)),
        "sharded_batch_step 4x1": (sharded_batch_step, {"data": 4},
                                   (sx, sm, CFG)),
        "device_frame_step_spatial 4x2": (device_frame_step_spatial,
                                          {"space": 8}, (sx[0], sm[0], CFG)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(in-process results, each rank's results), by call name."""
    calls = _calls()
    names, specs = list(calls), list(calls.values())
    ranks = launch.spawn(launch.run_entry_points, RANKS, "cpu", specs,
                         rdzv_dir=tmp_path_factory.mktemp("rdzv"),
                         timeout_s=240)
    here = launch.run_entry_points("cpu", specs)
    return {name: (here[i], [r[i] for r in ranks])
            for i, name in enumerate(names)}


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("name", ["cluster_spatial 4x2",
                                  "cluster_spatial_2d 2x2x2",
                                  "sharded_batch_step 4x1",
                                  "device_frame_step_spatial 4x2"])
def test_every_rank_equals_one_rank_bit_for_bit(runs, name):
    want, per_rank = runs[name]
    for rank, got in enumerate(per_rank):
        g, w = _leaves(got), _leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, (rank, name)
            assert a.tobytes() == b.tobytes(), (rank, name)
    # ClusteringResult: (labels, num_clusters, overflow); FrameResult:
    # (seg, clustering, ..., hull_overflow)
    overflows = [want[2]] if name.startswith("cluster") else [want[1][2],
                                                              want[-1]]
    assert not any(np.any(o) for o in overflows), (name, overflows)
