"""PyTorch port: the jax-free copies of the host oracles
(oracle/reference.py, oracle/diff.py) against their originals on seeded
inputs, function for function."""

import dataclasses

import numpy as np
import pytest

from lidar_processing_tpu import config as jconfig
from lidar_processing_tpu.oracle import diff as jdiff
from lidar_processing_tpu.oracle import reference as jref
from lidar_processing_tpu_torch.interop import config_from_jax
from lidar_processing_tpu_torch.io.synthetic import street_scene
from lidar_processing_tpu_torch.oracle import diff as tdiff
from lidar_processing_tpu_torch.oracle import reference as tref

JCFG = jconfig.DEFAULT_CONFIG
TCFG = config_from_jax(JCFG)


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _labelings(seed, n=3000):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 40, n).astype(np.int32)
    b = np.where(rng.uniform(size=n) < 0.9, a, rng.integers(-1, 40, n))
    b = (b * 7 + 3) % 45 - 1                      # relabelled ids
    b[rng.uniform(size=n) < 0.05] = np.iinfo(np.int32).min
    return a, b.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diff_copy_matches(seed):
    a, b = _labelings(seed)
    seg_a, seg_b = np.abs(a) % 3, np.abs(b) % 3
    assert (tdiff.ground_mask_iou(seg_a, seg_b)
            == jdiff.ground_mask_iou(seg_a, seg_b))
    assert (tdiff.segmentation_accuracy(seg_a, seg_b)
            == jdiff.segmentation_accuracy(seg_a, seg_b))
    assert tdiff.cluster_f1(a, b) == jdiff.cluster_f1(a, b)
    assert tdiff.cluster_f1(a[:0], b[:0]) == jdiff.cluster_f1(a[:0], b[:0])
    rng = np.random.default_rng(seed)
    polys = [rng.normal(c, 1.0, (int(k), 2)).astype(np.float32)
             for c, k in zip(rng.uniform(-20, 20, 12), rng.integers(3, 30, 12))]
    other = [p + rng.normal(0, 0.05, p.shape).astype(np.float32)
             for p in polys[::-1][:10]]
    assert (tdiff.polygon_chamfer(polys[0], other[0])
            == jdiff.polygon_chamfer(polys[0], other[0]))
    assert (tdiff.match_outlines(polys, other)
            == jdiff.match_outlines(polys, other))
    assert tdiff.match_outlines([], other) == jdiff.match_outlines([], other)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_copy_matches(seed):
    """Segmentation, both clusterings (FEC on the Python path and through
    the port's native module), hulls and the whole oracle pipeline."""
    xyz, _ = street_scene(seed, "small")
    jseg = jref.gpf_segment(xyz, JCFG.segmentation)
    tseg = tref.gpf_segment(xyz, TCFG.segmentation)
    _eq(tseg.labels, jseg.labels)
    assert len(tseg.planes) == len(jseg.planes)
    for tp, jp in zip(tseg.planes, jseg.planes):
        assert (tp is None) == (jp is None)
        if tp is not None:
            _eq(tp[0], jp[0])
            assert tp[1] == jp[1]
    obst = xyz[tseg.labels == 2]
    want_fec = jref.fec_cluster(obst, JCFG.clustering, allow_native=False)
    _eq(tref.fec_cluster(obst, TCFG.clustering, allow_native=False), want_fec)
    _eq(tref.fec_cluster(obst, TCFG.clustering), want_fec)      # native
    want_cc = jref.radius_cc_cluster(obst, JCFG.clustering)
    _eq(tref.radius_cc_cluster(obst, TCFG.clustering), want_cc)   # native
    _eq(tref.radius_cc_cluster(obst[:0], TCFG.clustering),
        jref.radius_cc_cluster(obst[:0], JCFG.clustering))
    _eq(tref.fec_cluster(obst[:0], TCFG.clustering),
        jref.fec_cluster(obst[:0], JCFG.clustering, allow_native=False))
    for mode in ("cc", "fec"):
        got = tref.run_pipeline(xyz, TCFG, clustering_mode=mode)
        want = jref.run_pipeline(xyz, JCFG, clustering_mode=mode)
        for g, w in zip(got[:3], want[:3]):
            _eq(g, w)
        for field in ("clusters", "outlines"):
            g, w = getattr(got, field), getattr(want, field)
            assert len(g) == len(w) > 3
            for a, b in zip(g, w):
                _eq(a, b)
    with pytest.raises(ValueError):
        tref.run_pipeline(xyz, TCFG, clustering_mode="kmeans")


@pytest.mark.parametrize("n", [0, 1, 2, 3, 40, 500])
def test_hull_oracles_match(n):
    pts = np.random.default_rng(n).normal(0, 3, (n, 2)).astype(np.float32)
    _eq(tref.convex_hull_indices(pts), jref.convex_hull_indices(pts))
    _eq(tref.chi_concave_hull_indices(pts, 0.2),
        jref.chi_concave_hull_indices(pts, 0.2))
    clusters = [np.random.default_rng(n + k).normal(0, 2, (m, 3)).astype(
        np.float32) for k, m in enumerate((0, 4, 30, 120))]
    poly = dataclasses.replace(TCFG.polygonization, small_cluster_size=25)
    jpoly = dataclasses.replace(JCFG.polygonization, small_cluster_size=25)
    got = tref.cluster_outlines(clusters, poly)
    want = jref.cluster_outlines(clusters, jpoly)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _eq(g, w)
