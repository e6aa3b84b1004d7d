"""PyTorch port: the visualization export copy (io/export.py) writes the
same bytes as the JAX package's, and reads them back."""

import numpy as np
import pytest

from lidar_processing_tpu.io import export as jexport
from lidar_processing_tpu_torch.io import export as texport


def _frame(seed, n=2000):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 10, (n, 3)).astype(np.float32)
    seg = rng.integers(0, 3, n).astype(np.int32)
    cl = np.where(seg == 2, rng.integers(-1, 30, n),
                  np.iinfo(np.int32).min).astype(np.int32)
    outlines = [rng.normal(c, 1, (int(k), 2)).astype(np.float32)
                for c, k in zip(rng.uniform(-20, 20, 30),
                                rng.integers(0, 12, 30))]
    ids = list(range(len(outlines)))
    zext = [(float(a), float(a + 1.5)) for a in rng.uniform(-2, 0, 30)]
    inten = rng.uniform(0, 1, n).astype(np.float32)
    return xyz, seg, cl, outlines, ids, zext, inten


@pytest.mark.parametrize("seed,with_extras", [(0, True), (1, False)])
def test_export_frame_byte_identical(tmp_path, seed, with_extras):
    xyz, seg, cl, outlines, ids, zext, inten = _frame(seed)
    kw = (dict(outline_cluster_ids=ids, outline_z_extents=zext,
               intensity=inten) if with_extras else {})
    got = texport.export_frame(str(tmp_path / "port"), seed, xyz, seg, cl,
                               outlines, **kw)
    want = jexport.export_frame(str(tmp_path / "jax"), seed, xyz, seg, cl,
                                outlines, **kw)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    assert len(got) == 4
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), g
    for p in got[:3]:
        for a, b in zip(texport.read_ply_xyzrgb(p),
                        jexport.read_ply_xyzrgb(p)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    rx, _, ri = texport.read_ply_xyzrgb(got[0])
    np.testing.assert_array_equal(rx, xyz[seg == 1])
    assert (ri is not None) == with_extras


def test_cluster_colors_match():
    labels = np.arange(-1, 5000, dtype=np.int32)
    np.testing.assert_array_equal(texport.cluster_colors(labels),
                                  jexport.cluster_colors(labels))
