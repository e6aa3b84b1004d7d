"""PyTorch port: stixel clustering against the JAX package, bit for bit.

Both packages get the same obstacle mask (or the same sorted segmented
inputs), so segmentation wobble cannot leak in: labels, cluster counts,
overflow counters and the sorted hand-over arrays must be identical. The
port runs its kernels' plain twins here (CPU tensors); the JAX package
runs its XLA twins.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.config import DEFAULT_CONFIG
from lidar_processing_tpu.ops import segmentation as jseg
from lidar_processing_tpu.ops import stixel as jsx
from lidar_processing_tpu.types import SEG_OBSTACLE
from lidar_processing_tpu_torch.interop import config_from_jax, to_torch
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.ops import stixel as tsx

CAP = 4096


def _cfg(**caps):
    small = dict(max_points=CAP, max_obstacle_points=CAP, max_cells=2048,
                 max_columns=1024, max_supernodes=2048,
                 max_column_pairs=8192, max_sn_pairs=8192)
    pcfg = dataclasses.replace(DEFAULT_CONFIG.pipeline, **{**small, **caps})
    return DEFAULT_CONFIG.replace(pipeline=pcfg)


CFG = _cfg()
# caps small enough that cells, supernodes, columns and pairs overflow
TINY = _cfg(max_cells=40, max_columns=20, max_supernodes=24,
            max_column_pairs=64, max_sn_pairs=128, max_edges=32)


def _boxes_scene(seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform([-20, -20, -1.8], [20, 20, -1.65], (3000, 3))
    centers = rng.uniform([-15, -15, 0], [15, 15, 0], (8, 3))
    b = (rng.uniform([-0.8, -0.8, -1.5], [0.8, 0.8, 0.3], (8, 60, 3))
         + centers[:, None, :])
    return np.concatenate([g, b.reshape(-1, 3)]).astype(np.float32)


def _scene(name):
    return (_boxes_scene(3) if name == "boxes"
            else street_scene(int(name[-1]), "small")[0])


def _sorted_inputs(name, cfg):
    """JAX segmentation in sorted space: the shared input of both ports."""
    x, m = pad_frame(_scene(name), CAP)
    ss = jseg.gpf_segment_sorted(jnp.asarray(x), jnp.asarray(m),
                                 cfg.segmentation)
    obst = ss.valid & (ss.labels == SEG_OBSTACLE)
    return (x, m), tuple(np.asarray(a) for a in
                         (ss.xyz, obst, ss.valid, ss.orig, ss.labels))


def _assert_tree_equal(got, want):
    got = got._asdict() if hasattr(got, "_asdict") else got
    want = want._asdict() if hasattr(want, "_asdict") else want
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if hasattr(w, "_asdict"):
            _assert_tree_equal(g, w)
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", ["street0", "street1", "boxes"])
def test_sort_points_full_matches(name):
    cfg = CFG
    _, args = _sorted_inputs(name, cfg)
    h = math.sqrt(cfg.clustering.distance_squared / 3.0)
    want = jsx._sort_points_full(*map(jnp.asarray, args), cfg.pipeline, h)
    got = tsx._sort_points_full(*to_torch(args),
                                config_from_jax(cfg).pipeline, h)
    _assert_tree_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cfg_name", ["caps", "tiny"])
@pytest.mark.parametrize("name", ["street0", "street1", "boxes"])
def test_cluster_matches_jax_on_same_obstacles(name, cfg_name):
    """The unfused entry (with _sort_points): same obstacle mask in the
    original order -> identical labels, counts and overflow; the tiny caps
    make every table overflow, and the counters must still agree."""
    cfg = CFG if cfg_name == "caps" else TINY
    (x, m), _ = _sorted_inputs(name, CFG)
    seg = jseg.gpf_segment(jnp.asarray(x), jnp.asarray(m), cfg.segmentation)
    obst = np.asarray(m & (np.asarray(seg.labels) == SEG_OBSTACLE))
    want = jsx.cluster(jnp.asarray(x), jnp.asarray(obst), cfg.clustering,
                       cfg.pipeline)
    tcfg = config_from_jax(cfg)
    got = tsx.cluster(torch.from_numpy(x), torch.from_numpy(obst),
                      tcfg.clustering, tcfg.pipeline)
    _assert_tree_equal(got, want)
    if cfg_name == "caps":
        assert int(got.overflow) == 0 and int(got.num_clusters) > 3
    else:
        assert int(got.overflow) > 0


@pytest.mark.parametrize("name", ["street0", "street1", "boxes"])
def test_cluster_fused_matches_jax(name):
    _, args = _sorted_inputs(name, CFG)
    want = jsx.cluster_fused(*map(jnp.asarray, args), CFG.clustering,
                             CFG.pipeline)
    tcfg = config_from_jax(CFG)
    got = tsx.cluster_fused(*to_torch(args), tcfg.clustering, tcfg.pipeline)
    _assert_tree_equal(got, want)


def test_tier_tables_are_the_jax_packages():
    for attr in ("_TIERS_INTRA", "_TIERS_SNP", "_CHUNK", "_CHUNK_GRID",
                 "_CHUNK_PAIRS_INTRA", "_CHUNK_PAIRS_SNP", "_XY_OFFSETS",
                 "_GX", "_GY", "_GZ"):
        assert getattr(tsx, attr) == getattr(jsx, attr), attr
    assert tsx._F_BIG == float(jsx._F_BIG)
