"""PyTorch port: label runs, run gathers, device convex hulls and the
host outline copies, against the JAX package — all bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.ops import hull as jhull
from lidar_processing_tpu.ops import hull_native as jnative
from lidar_processing_tpu.ops import simplify as jsimplify
from lidar_processing_tpu.oracle import reference as orc
from lidar_processing_tpu_torch.ops import host_hulls as thost
from lidar_processing_tpu_torch.ops import hull as thull
from lidar_processing_tpu_torch.ops import simplify as tsimplify

NUM_SLOTS = 1536


def _labeled_buffer(seed, n=4096, n_clusters=300):
    """A compacted obstacle buffer as cluster_fused hands it over:
    compact ids 0..k-1 (each present), INVALID/UNDEFINED rows, orig ids."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    labels = rng.integers(0, n_clusters, n).astype(np.int32)
    labels[:n_clusters] = np.arange(n_clusters)      # every id present
    labels[rng.uniform(size=n) < 0.1] = -1
    labels[n - 300:] = np.iinfo(np.int32).min
    orig = rng.permutation(2 * n)[:n].astype(np.int32)
    return xyz, labels, orig


def _eq(got, want):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,n_clusters", [(0, 300), (1, 1700), (2, 1)])
def test_label_runs_presorted_matches(seed, n_clusters):
    xyz, labels, orig = _labeled_buffer(seed, n_clusters=n_clusters)
    want = jhull.label_runs_presorted(jnp.asarray(xyz), jnp.asarray(labels),
                                      jnp.asarray(orig), NUM_SLOTS,
                                      orig_bound=8192)
    got = thull.label_runs_presorted(torch.from_numpy(xyz),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(orig), NUM_SLOTS,
                                     orig_bound=8192)
    for g, w in zip(got, want):
        _eq(g, w)


def test_gather_runs_matches():
    xyz, labels, orig = _labeled_buffer(3)
    runs = thull.label_runs_presorted(torch.from_numpy(xyz),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(orig), NUM_SLOTS)
    starts, counts = runs.starts[:400], runs.counts[:400]
    want = jhull.gather_runs(jnp.asarray(runs.sorted_xyz.numpy()),
                             jnp.asarray(starts.numpy()),
                             jnp.asarray(counts.numpy()), 32)
    _eq(thull.gather_runs(runs.sorted_xyz, starts, counts, 32), want)


def _hull_batch(seed, c=300, p=32):
    """Padded small clusters, with collinear runs, duplicates, single
    points and empty slots among them."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-5, 5, (c, p, 2)).astype(np.float32)
    counts = rng.integers(0, p + 1, c).astype(np.int32)
    t = np.linspace(0, 1, p, dtype=np.float32)
    xy[0::7] = np.stack([t * 3 - 1, t * 2 + 4], -1)          # collinear
    xy[1::7, 5:] = xy[1::7, :1]                               # duplicates
    counts[2::11] = 1
    xy[3::13] = np.round(xy[3::13] * 2) / 2                   # lattice ties
    xy[np.arange(p)[None, :] >= counts[:, None]] = 0.0
    return xy, counts


@pytest.mark.parametrize("seed,max_out", [(0, 21), (1, 32), (2, 8)])
def test_convex_hulls_batched_matches(seed, max_out):
    xy, counts = _hull_batch(seed)
    want = jhull.convex_hulls_batched(jnp.asarray(xy), jnp.asarray(counts),
                                      max_out)
    got = thull.convex_hulls_batched(torch.from_numpy(xy),
                                     torch.from_numpy(counts), max_out)
    _eq(got.counts, want.counts)
    _eq(got.vertices, want.vertices)


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 600), (2, 3), (3, 2)])
def test_host_hull_copies_match_originals(seed, n):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 3.0, (n, 2)).astype(np.float32)
    np.testing.assert_array_equal(thost.convex_hull_indices(pts),
                                  orc.convex_hull_indices(pts))
    np.testing.assert_array_equal(thost.chi_concave_hull_indices(pts, 0.2),
                                  orc.chi_concave_hull_indices(pts, 0.2))
    # the JAX package's fallback chain (no native module is built here)
    assert not jnative.native_available()
    np.testing.assert_array_equal(thost.chi_concave_hull(pts, 0.2),
                                  jnative.chi_concave_hull(pts, 0.2))


@pytest.mark.parametrize("n,cap", [(500, 300), (40, 12), (10, 300), (5, 3)])
def test_simplify_ring_copy_matches_original(n, cap):
    ang = np.sort(np.random.default_rng(n).uniform(0, 2 * np.pi, n))
    ring = np.stack([np.cos(ang) * (2 + np.sin(5 * ang)),
                     np.sin(ang) * (2 + np.sin(5 * ang))], 1)
    np.testing.assert_array_equal(tsimplify.simplify_ring(ring, cap),
                                  jsimplify.simplify_ring(ring, cap))
