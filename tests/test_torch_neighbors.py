"""PyTorch port: ops/neighbors.py against the JAX package, bit for bit.

The cases of tests/test_neighbors.py (the reference's KD-tree test
scenes: 1000 points, 50 queries, k = 5, radius 2.0; exact ties; a mask;
tiling; unsorted order; capacity overflow; the object API with rebuild),
made with numpy from a seed and given to both packages: indices, counts
and overflow equal, distances bit-equal. A float64 brute force checks
the port on its own as well.
"""

import numpy as np
import pytest
import torch

from lidar_processing_tpu.ops import neighbors as jnb
from lidar_processing_tpu_torch.ops import neighbors as tnb


def _eq(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _cloud(seed, n, lo, hi, q):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.uniform(lo, hi, (q, 3)).astype(np.float32))


def _brute_knn(points, queries, k):
    d2 = ((queries[:, None, :].astype(np.float64)
           - points[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


_KNN_CASES = {
    # (points, queries, k, mask, tile)
    "brute_force": lambda: (*_cloud(0, 1000, -10, 10, 50), 5, None, 8192),
    "ties": lambda: (np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                               [5, 5, 5]], np.float32),
                     np.zeros((1, 3), np.float32), 4, None, 8192),
    "mask": lambda: (_cloud(1, 64, -10, 10, 1)[0],
                     _cloud(1, 64, -10, 10, 1)[0][:1], 12,
                     np.arange(64) < 10, 8192),
    "tiling": lambda: (*_cloud(2, 1000, -10, 10, 7), 5, None, 128),
    "k_past_points": lambda: (*_cloud(3, 20, -1, 1, 3), 32, None, 8),
}


@pytest.mark.parametrize("case", sorted(_KNN_CASES))
def test_k_nearest_matches_jax(case):
    pts, q, k, mask, tile = _KNN_CASES[case]()
    want = jnb.k_nearest(pts, q, k=k, mask=mask, tile=tile)
    got = tnb.k_nearest(*_t(pts, q), k, mask=_t(mask)[0], tile=tile)
    _eq(got, want)
    if case == "brute_force":
        np.testing.assert_array_equal(got.indices.numpy(),
                                      _brute_knn(pts, q, k))
    if case == "ties":
        assert got.indices.tolist() == [[0, 1, 2, 3]]
    if case in ("mask", "k_past_points"):
        valid = 10 if case == "mask" else 20
        assert np.all(got.indices.numpy()[:, valid:] == -1)
        assert np.all(np.isinf(got.distances.numpy()[:, valid:]))


_RADIUS_CASES = {
    # (points, queries, r2, capacity, mask, sort_results, tile)
    "brute_force": lambda: (*_cloud(4, 1000, -15, 15, 50), 4.0, 64, None,
                            True, 8192),
    "unsorted": lambda: (*_cloud(5, 100, -2, 2, 1), 1.0, 100, None, False,
                         8192),
    "unsorted_tiled_masked": lambda: (*_cloud(6, 300, -2, 2, 9), 1.0, 40,
                                      np.arange(300) % 3 != 0, False, 64),
    "capacity_overflow": lambda: (
        np.random.default_rng(7).normal(0, 0.01, (50, 3)).astype(np.float32),
        np.zeros((1, 3), np.float32), 1.0, 8, None, True, 8192),
}


@pytest.mark.parametrize("case", sorted(_RADIUS_CASES))
def test_radius_search_matches_jax(case):
    pts, q, r2, cap, mask, srt, tile = _RADIUS_CASES[case]()
    want = jnb.radius_search(pts, q, r2, capacity=cap, mask=mask,
                             sort_results=srt, tile=tile)
    got = tnb.radius_search(*_t(pts, q), r2, cap, mask=_t(mask)[0],
                            sort_results=srt, tile=tile)
    _eq(got, want)
    idx = got.indices.numpy()
    if not srt:
        for row in idx:
            row = row[row >= 0]
            assert np.all(np.diff(row) > 0)
    if case == "capacity_overflow":
        assert int(got.counts[0]) == 50 and int(got.overflow) == 42
    if case == "brute_force":
        d2 = ((q[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
        for i in range(q.shape[0]):
            assert set(idx[i][idx[i] >= 0]) == set(np.flatnonzero(d2[i] <= r2))


def test_neighbor_index_matches_jax():
    """The object API: queries before rebuild raise; (3,) and (Q, 3)
    queries; rebuild with a mask replaces the buffer."""
    pts, q = _cloud(8, 128, -1, 1, 5)
    with pytest.raises(ValueError):
        tnb.NeighborIndex().k_nearest(torch.zeros(3), 1)
    jidx, tidx = jnb.NeighborIndex(), tnb.NeighborIndex()
    for mask in (None, np.arange(128) % 2 == 0):
        jidx.rebuild(pts, mask)
        tidx.rebuild(torch.from_numpy(pts), mask)   # the mask follows
        for query in (pts[0], q):
            _eq(tidx.k_nearest(query, 3), jidx.k_nearest(query, 3))
            _eq(tidx.radius_search(query, 0.05, capacity=16),
                jidx.radius_search(query, 0.05, capacity=16))
            _eq(tidx.radius_search(query, 0.3, capacity=8,
                                   sort_results=False),
                jidx.radius_search(query, 0.3, capacity=8,
                                   sort_results=False))
    res = tnb.NeighborIndex(torch.from_numpy(pts)).k_nearest(pts[0], 1)
    assert res.indices.tolist() == [[0]] and float(res.distances[0, 0]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):      # arrays go to the card
            tnb.NeighborIndex(pts)
