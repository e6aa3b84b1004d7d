"""PyTorch port: eig3 and GPF segmentation against the JAX package.

The same seeded clouds go through both packages. Exact where the
arithmetic is (sort permutation, validity, coordinates); the f32 moment
reductions run in another order, so planes agree to 1e-5 and at most
max(2, n // 1000) labels of points on the 0.3 m threshold may differ — the
JAX package's own bound for two compilations of this stage
(__graft_entry__.py:106-110).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.config import DEFAULT_CONFIG
from lidar_processing_tpu.ops import eig3 as jeig
from lidar_processing_tpu.ops import segmentation as jseg
from lidar_processing_tpu_torch.interop import config_from_jax
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.ops import eig3 as teig
from lidar_processing_tpu_torch.ops import segmentation as tseg

CAP = 4096
SCFG = DEFAULT_CONFIG.segmentation
TSCFG = config_from_jax(DEFAULT_CONFIG).segmentation


def _covariances(rng, n):
    """Symmetric PSD 3x3 matrices: ground-like (one tiny eigenvalue),
    generic, and isotropic/degenerate ones."""
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    lam = rng.uniform(0.01, 4.0, (n, 3))
    lam[: n // 3, 0] = 1e-6
    a = np.einsum("nij,nj,nkj->nik", q, lam, q)
    a[-2:] = np.eye(3) * 2.0
    return a.astype(np.float32)


def test_eig3_matches_jax():
    a = _covariances(np.random.default_rng(0), 64)
    for name in ("smallest_eigenvalue_3x3", "smallest_eigenvector_3x3"):
        want = np.asarray(getattr(jeig, name)(jnp.asarray(a)))
        got = getattr(teig, name)(torch.from_numpy(a)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


def _both(xyz, mask):
    js = jseg.gpf_segment_sorted(jnp.asarray(xyz), jnp.asarray(mask), SCFG)
    ts = tseg.gpf_segment_sorted(torch.from_numpy(xyz),
                                 torch.from_numpy(mask), TSCFG)
    return js, ts


def _ground_box_scene(seed):
    """tests/test_ops.py's synthetic scene: a ground slab + boxes."""
    rng = np.random.default_rng(seed)
    g = rng.uniform([-20, -20, -1.8], [20, 20, -1.65], (3000, 3))
    centers = rng.uniform([-15, -15, 0], [15, 15, 0], (8, 3))
    b = (rng.uniform([-0.8, -0.8, -1.5], [0.8, 0.8, 0.3], (8, 60, 3))
         + centers[:, None, :])
    return np.concatenate([g, b.reshape(-1, 3)]).astype(np.float32)


@pytest.mark.parametrize("scene", ["street0", "street1", "boxes"])
def test_gpf_segment_sorted_matches_jax(scene):
    xyz = (_ground_box_scene(3) if scene == "boxes"
           else street_scene(int(scene[-1]), "small")[0])
    x, m = pad_frame(xyz, CAP)
    js, ts = _both(x, m)
    n = xyz.shape[0]
    # the sort permutation (stable ties), coordinates and validity: exact
    np.testing.assert_array_equal(ts.orig.numpy(), np.asarray(js.orig))
    np.testing.assert_array_equal(ts.xyz.numpy(), np.asarray(js.xyz))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert ts.labels.dtype == torch.int32 and ts.orig.dtype == torch.int32
    differ = int(np.sum(ts.labels.numpy() != np.asarray(js.labels)))
    assert differ <= max(2, n // 1000), differ
    np.testing.assert_allclose(ts.planes.normal.numpy(),
                               np.asarray(js.planes.normal), atol=1e-5)
    np.testing.assert_allclose(ts.planes.d.numpy(), np.asarray(js.planes.d),
                               atol=1e-5)
    np.testing.assert_array_equal(ts.plane_valid.numpy(),
                                  np.asarray(js.plane_valid))


def test_gpf_segment_original_order_and_quirks():
    """Unsorted labels, the tail-drop quirk (odd n: the last x-ranked point
    stays UNKNOWN) and padding rows UNKNOWN, as in the JAX package."""
    xyz = street_scene(2, "small")[0][:2501]
    x, m = pad_frame(xyz, CAP)
    want = np.asarray(jseg.gpf_segment(jnp.asarray(x), jnp.asarray(m),
                                       SCFG).labels)
    got = tseg.gpf_segment(torch.from_numpy(x), torch.from_numpy(m),
                           TSCFG).labels.numpy()
    assert np.sum(got != want) <= max(2, xyz.shape[0] // 1000)
    assert np.all(got[xyz.shape[0]:] == 0)
    assert np.sum(got[:xyz.shape[0]] == 0) == np.sum(want[:xyz.shape[0]] == 0)


def test_empty_cloud_all_unknown():
    x = np.zeros((256, 3), np.float32)
    m = np.zeros(256, bool)
    res = tseg.gpf_segment(torch.from_numpy(x), torch.from_numpy(m), TSCFG)
    assert np.all(res.labels.numpy() == 0)
    assert not res.plane_valid.any()


def test_eig3_batched_leading_axes():
    """(frames, partitions, 3, 3) as the batched GPF fit calls it: every
    matrix's result equals the flat batch's, bit for bit, and JAX's."""
    a = _covariances(np.random.default_rng(0), 64)
    for name in ("smallest_eigenvalue_3x3", "smallest_eigenvector_3x3"):
        flat = getattr(teig, name)(torch.from_numpy(a))
        got = getattr(teig, name)(torch.from_numpy(a).reshape(4, 16, 3, 3))
        assert got.shape == (4, 16) + flat.shape[1:]
        assert torch.equal(got.reshape(flat.shape), flat)
        np.testing.assert_allclose(
            got.reshape(flat.shape).numpy(),
            np.asarray(getattr(jeig, name)(jnp.asarray(a))), atol=1e-5)


def test_gpf_segment_batched_equals_frames_alone():
    """Three frames of different point counts (one with the odd-count
    tail-drop quirk, one empty) in one batch: every field of each frame
    bit for bit what the frame gives alone, in sorted and original
    order."""
    clouds = [street_scene(0, "small")[0], _ground_box_scene(3),
              street_scene(2, "small")[0][:2501], np.zeros((0, 3))]
    x, m = (np.stack(a) for a in zip(*(pad_frame(c, CAP) for c in clouds)))
    for fn in (tseg.gpf_segment_sorted, tseg.gpf_segment):
        got = fn(torch.from_numpy(x), torch.from_numpy(m), TSCFG)
        for b in range(len(clouds)):
            want = fn(torch.from_numpy(x[b]), torch.from_numpy(m[b]), TSCFG)
            for g, w in zip(torch.utils._pytree.tree_leaves(got),
                            torch.utils._pytree.tree_leaves(want)):
                assert g[b].dtype == w.dtype and torch.equal(g[b], w)


def test_lpr_prefix_sum_is_batch_invariant():
    """The LPR prefix sum (a fixed-order scan of elementwise float64
    adds): a row alone equals the same row inside a B = 3 batch bit for
    bit, and it is a prefix sum (float64 to 1e-12 of numpy's cumsum)."""
    rng = np.random.default_rng(0)
    z = rng.uniform(-2.5, 3.0, (3, 4099)).astype(np.float32)
    batch = tseg._prefix_sum(torch.from_numpy(z).double())
    for b in range(3):
        alone = tseg._prefix_sum(torch.from_numpy(z[b]).double()[None])[0]
        assert torch.equal(batch[b], alone), b
        np.testing.assert_allclose(alone.numpy(),
                                   np.cumsum(z[b].astype(np.float64)),
                                   rtol=0, atol=1e-12)
    seeds, seg = tseg._seed_runs(torch.from_numpy(z), torch.tensor(
        [[2049], [1000], [0]], dtype=torch.int32), 2, TSCFG)
    for b in range(3):
        one = tseg._seed_runs(torch.from_numpy(z[b:b + 1]),
                              torch.tensor([[(2049, 1000, 0)[b]]],
                                           dtype=torch.int32), 2, TSCFG)
        assert torch.equal(seeds[b], one[0][0]) and torch.equal(seg[b],
                                                                one[1][0])
