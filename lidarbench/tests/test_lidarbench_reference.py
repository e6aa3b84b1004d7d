"""The plain reference: components on hand-built clouds, GPF against
the port's oracle, the outline geometry, the chi-shape and the bfloat16
rounding."""

import dataclasses

import numpy as np
import pytest

from lidarbench import check
from lidarbench.reference import chi_shape, geometry, gpf, radius_cc

R2 = float(np.float32(0.18))
R = float(np.sqrt(R2))


def _labels(xyz, min_size=1):
    return radius_cc.cluster_labels(np.asarray(xyz, np.float32), R2,
                                    min_size, 2 ** 32 - 1)


def test_chain_just_under_the_radius_is_one_component():
    xyz = np.zeros((40, 3), np.float32)
    xyz[:, 0] = np.arange(40) * np.float32(0.42)      # 0.1764 < R²
    assert set(_labels(xyz)) == {0}


def test_gap_just_over_the_radius_splits():
    xyz = np.zeros((20, 3), np.float32)
    xyz[:10, 0] = np.arange(10) * np.float32(0.1)
    xyz[10:, 0] = xyz[9, 0] + np.float32(0.43) + np.arange(10) * np.float32(0.1)
    lab = _labels(xyz)
    assert (lab[:10] == 0).all() and (lab[10:] == 1).all()


def test_pair_at_exactly_r2_is_joined_and_one_ulp_over_is_not():
    # d² of (x, 0, 0) is x² exactly in float64 for x = 0.375: a float32
    # threshold at x² joins, the next float32 below it splits
    x = np.float32(0.375)
    r2 = float(x) ** 2
    pair = np.array([[0, 0, 0], [x, 0, 0]], np.float32)
    assert len(set(radius_cc.cluster_labels(pair, r2, 1, 10))) == 1
    below = float(np.nextafter(np.float32(r2), np.float32(0)))
    assert len(set(radius_cc.cluster_labels(pair, below, 1, 10))) == 2


def test_diagonal_neighbour_cells_and_min_size():
    # a 3-D diagonal step crosses into a corner cell
    step = np.float32(R / np.sqrt(3.0) * 0.99)
    xyz = np.stack([np.arange(6) * step] * 3, 1).astype(np.float32)
    far = xyz[-1] + 5.0
    xyz = np.vstack([xyz, far[None], far[None] + [0.1, 0, 0]]).astype(np.float32)
    lab = _labels(xyz, min_size=3)
    assert (lab[:6] == 0).all() and (lab[6:] == -1).all()


def test_components_match_brute_force_on_random_clouds():
    rng = np.random.default_rng(7)
    for _ in range(5):
        xyz = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
        got = radius_cc.components(xyz, R2, block_pairs=97)
        d = xyz[:, None, :].astype(np.float64) - xyz[None].astype(np.float64)
        adj = (d * d).sum(-1) <= R2
        roots = np.arange(300)
        for _ in range(300):
            roots = np.where(adj, roots[None, :], 300).min(1)
        np.testing.assert_array_equal(got, roots)


def test_gpf_is_the_port_oracle_gpf(spec):
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    from lidar_processing_tpu_torch.oracle import reference as orc
    from lidarbench.tests.small import small_config
    from lidarbench import scenes
    for seed in (1, 2):
        xyz, _ = scenes.street_sweep(seed, small_config())
        got = gpf.segment(xyz, dataclasses.asdict(DEFAULT_CONFIG.segmentation))
        want = orc.gpf_segment(xyz, DEFAULT_CONFIG.segmentation).labels
        np.testing.assert_array_equal(got, want)


def test_gpf_labels_a_plane_with_boxes():
    # a box in each x partition: a partition with no point above the seed
    # threshold gets no seeds and turns all obstacle (the reference's quirk)
    rng = np.random.default_rng(3)
    ground = np.c_[rng.uniform(-20, 20, (4000, 2)), rng.normal(-1.73, 0.02, 4000)]
    box = np.c_[rng.uniform(5, 6, (300, 2)), rng.uniform(-1.0, 0.0, 300)]
    box[:150, 0] -= 11.0
    xyz = np.vstack([ground, box]).astype(np.float32)
    from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
    lab = gpf.segment(xyz, dataclasses.asdict(DEFAULT_CONFIG.segmentation))
    assert (lab[:4000] == 1).mean() > 0.99 and (lab[4000:] == 2).all()


def test_outline_geometry():
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    pts = np.random.default_rng(0).uniform(0, 1, (100, 2))
    assert geometry.cover_gap(sq, pts) == 0.0
    assert geometry.cover_gap(sq, np.array([[1.5, 0.5]])) == pytest.approx(0.5)
    assert geometry.vertex_gap(sq, np.vstack([pts, sq])) == 0.0
    assert geometry.vertex_gap(sq + 0.01, sq) == pytest.approx(0.01 * np.sqrt(2))
    assert geometry.cover_gap(np.array([[0, 0], [2, 0]]), np.array([[1, 0.3]])) \
        == pytest.approx(0.3)
    hull = geometry.convex_hull(np.vstack([pts, sq]))
    assert sorted(map(tuple, hull)) == sorted(map(tuple, sq))


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 100.3, -3.3], np.float32)
    got = check.to_bfloat16(x)
    import torch
    want = torch.tensor(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_cluster_f1():
    a = np.array([0, 0, 1, 1, -1, -1])
    assert check.cluster_f1(a, a) == 1.0
    assert check.cluster_f1(a, np.array([1, 1, 0, 0, -1, -1])) == 1.0
    assert check.cluster_f1(a, np.array([0, 0, 0, 0, -1, -1])) == pytest.approx(0.5)


def _l_cloud(seed, n=400):
    """Points along an L: 8 m by 6 m arms, 5 cm of scatter."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 1, n)
    pts = np.c_[np.where(t < 0.5, t * 8, 4.0), np.where(t < 0.5, 0, (t - 0.5) * 6)]
    return (pts + rng.normal(0, 0.05, (n, 2))).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chi_shape_is_the_port_oracle_chi_shape(seed):
    from lidar_processing_tpu_torch.oracle.reference import (
        chi_concave_hull_indices)
    pts = _l_cloud(seed)
    sh = chi_shape.shape(pts, 0.2, 20)
    gap, area = chi_shape.area_gap(pts[chi_concave_hull_indices(pts, 0.2)], sh)
    assert gap == 0.0 and 0.0 < area
    # the L's convex hull covers the corner the chi-shape leaves out
    hull_gap, _ = chi_shape.area_gap(geometry.convex_hull(pts), sh)
    assert hull_gap > 2 * area


def test_chi_shape_small_and_degenerate_clusters():
    pts = _l_cloud(4, 12)
    sh = chi_shape.shape(pts, 0.2, 20)          # under small_cluster_size
    assert sh.kept.all()
    assert chi_shape.area_gap(geometry.convex_hull(pts), sh)[0] == \
        pytest.approx(0.0, abs=1e-12)
    line = np.c_[np.arange(6.0), np.zeros(6)]
    assert chi_shape.area_gap(line[[0, 5]], chi_shape.shape(line, 0.2, 4)) \
        == (0.0, 0.0)
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    assert chi_shape.area_gap(sq, chi_shape.shape(sq, 0.2, 4)) == \
        pytest.approx((0.0, 1.0))
    # an outline of the lower half: one of the two triangles is missing
    half = np.array([[0, 0], [1, 0], [1, 0.5], [0, 0.5]])
    assert chi_shape.area_gap(half, chi_shape.shape(sq, 0.2, 4))[0] == \
        pytest.approx(0.5)
