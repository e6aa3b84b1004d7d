"""PyTorch port: the whole slice against the JAX package.

Seeded small street scenes go through both packages'
device_frame_step(_packed) + host outputs. The scenes' segmentation labels
agree between the two (asserted), so every payload word and every output
field must be equal, outlines included: the JAX side runs its own native
module (the ``jax_native`` fixture), the port its copy. Also holds the
jax-free copies (config, PCD reader/writer, dataset loader) against their
originals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu import config as jconfig
from lidar_processing_tpu.io import dataset as jdataset
from lidar_processing_tpu.io import pcd as jpcd
from lidar_processing_tpu.runtime import pipeline as jpipe
from lidar_processing_tpu_torch import config as tconfig
from lidar_processing_tpu_torch.interop import config_from_jax, to_numpy
from lidar_processing_tpu_torch.io import dataset as tdataset
from lidar_processing_tpu_torch.io import pcd as tpcd
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.runtime import pipeline as tpipe
from test_torch_native import jax_native, jax_native_lib  # noqa: F401

CAP = 4096
_PCFG = dataclasses.replace(
    jconfig.DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192)
JCFG = jconfig.DEFAULT_CONFIG.replace(pipeline=_PCFG)
TCFG = config_from_jax(JCFG)
SEEDS = (0, 1)   # small scenes whose segmentation agrees label for label


def _frame(seed):
    xyz, inten = street_scene(seed, "small")
    x, m = pad_frame(xyz, CAP)
    return xyz, inten, x, m


def _assert_outputs_equal(got, want):
    for field in ("seg_labels", "cluster_labels", "intensity"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    for field in ("num_clusters", "overflow", "outline_cluster_ids",
                  "outline_z_extents"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.outlines) == len(want.outlines)
    for g, w in zip(got.outlines, want.outlines):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_config_copy_and_interop():
    assert (dataclasses.asdict(tconfig.DEFAULT_CONFIG)
            == dataclasses.asdict(jconfig.DEFAULT_CONFIG))
    assert ([f.name for f in dataclasses.fields(tconfig.EngineConfig)]
            == [f.name for f in dataclasses.fields(jconfig.EngineConfig)])
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    assert isinstance(TCFG, tconfig.EngineConfig)


def test_pcd_and_dataset_copies_match(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        xyz = rng.normal(0, 10, (100 + i, 3)).astype(np.float32)
        inten = rng.uniform(0, 1, 100 + i).astype(np.float32)
        writer = tpcd if i % 2 else jpcd
        writer.write_pcd_xyzi(tmp_path / f"{i:06d}.pcd", xyz, inten)
        assert (tmp_path / f"{i:06d}.pcd").read_bytes() == _bytes_of(
            jpcd, tmp_path / "ref.bin", xyz, inten)
    paths = tdataset.list_frames(str(tmp_path))
    assert paths == jdataset.list_frames(str(tmp_path))
    for p in paths:
        for g, w in zip(tpcd.read_pcd_xyzi(p), jpcd.read_pcd_xyzi(p)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(tdataset.preload_padded(paths, 128),
                    jdataset.preload_padded(paths, 128)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        tdataset.list_frames(str(tmp_path / "absent"))


def _bytes_of(module, path, xyz, inten):
    module.write_pcd_xyzi(path, xyz, inten)
    return path.read_bytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_packed_slice_matches_jax(seed, jax_native):
    xyz, inten, x, m = _frame(seed)
    n = xyz.shape[0]
    want_fr = jpipe.device_frame_step(jnp.asarray(x), jnp.asarray(m), JCFG)
    got_fr = tpipe.device_frame_step(torch.from_numpy(x),
                                     torch.from_numpy(m), TCFG)
    # the chosen scenes segment identically in both packages
    np.testing.assert_array_equal(got_fr.seg.labels.numpy(),
                                  np.asarray(want_fr.seg.labels))
    # every FrameResult leaf (planes to f32 wobble) ...
    got_leaves = _leaves(to_numpy(got_fr))
    want_leaves = _leaves(want_fr)
    assert got_leaves.keys() == want_leaves.keys()
    for k, w in want_leaves.items():
        if k.startswith("seg.planes"):
            np.testing.assert_allclose(got_leaves[k], w, atol=1e-5)
        else:
            assert got_leaves[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got_leaves[k], w, err_msg=k)
    # ... every payload word, and the decoded host outputs
    want_pay = np.asarray(jpipe.pack_host_payload(want_fr, JCFG))
    got_pay = tpipe.pack_host_payload(got_fr, TCFG).numpy()
    assert got_pay.dtype == want_pay.dtype == np.int32
    np.testing.assert_array_equal(got_pay, want_pay)
    np.testing.assert_array_equal(
        tpipe.device_frame_step_packed(torch.from_numpy(x),
                                       torch.from_numpy(m), TCFG).numpy(),
        want_pay)
    want = jpipe.host_outputs_packed(want_pay, JCFG, n, intensity=inten)
    got = tpipe.host_outputs_packed(torch.from_numpy(got_pay), TCFG, n,
                                    intensity=inten)
    _assert_outputs_equal(got, want)
    assert got.overflow == 0 and len(got.outlines) == got.num_clusters > 3
    # the exact float32 readout path as well
    _assert_outputs_equal(tpipe.host_outputs(got_fr, TCFG, n),
                          jpipe.host_outputs(want_fr, JCFG, n))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_outline_cap_and_unported_paths():
    """max_points_in_polygon caps every outline; the cellgraph backend
    (once unported) runs and its payload equals the JAX package's word for
    word, with the same clusters as the stixel backend."""
    xyz, _, x, m = _frame(0)
    poly = dataclasses.replace(TCFG.polygonization, max_points_in_polygon=6)
    cfg = TCFG.replace(polygonization=poly)
    fr = tpipe.device_frame_step(torch.from_numpy(x), torch.from_numpy(m), cfg)
    out = tpipe.host_outputs(fr, cfg, xyz.shape[0])
    assert out.outlines and all(len(o) <= 6 for o in out.outlines)
    jcell = JCFG.replace(pipeline=dataclasses.replace(
        JCFG.pipeline, clustering_backend="cellgraph",
        max_ambiguous_pairs=8192))
    tcell = config_from_jax(jcell)
    got = tpipe.device_frame_step_packed(torch.from_numpy(x),
                                         torch.from_numpy(m), tcell)
    want = jpipe.device_frame_step_packed(jnp.asarray(x), jnp.asarray(m),
                                          jcell)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cell_out = tpipe.host_outputs_packed(got, tcell, xyz.shape[0],
                                         with_outlines=False)
    np.testing.assert_array_equal(cell_out.cluster_labels,
                                  out.cluster_labels)
    assert cell_out.overflow == 0 and cell_out.num_clusters == out.num_clusters


def test_convex_outline_mode_matches_jax(jax_native):
    """polygonizer_concave=False: convex outlines (Chan above
    chan_threshold, monotone below) equal the JAX package's."""
    xyz, inten, x, m = _frame(1)
    poly = dataclasses.replace(TCFG.polygonization, polygonizer_concave=False,
                               chan_threshold=40)
    tcfg = TCFG.replace(polygonization=poly)
    jcfg = JCFG.replace(polygonization=dataclasses.replace(
        JCFG.polygonization, polygonizer_concave=False, chan_threshold=40))
    want = jpipe.host_outputs(
        jpipe.device_frame_step(jnp.asarray(x), jnp.asarray(m), jcfg), jcfg,
        xyz.shape[0])
    got = tpipe.host_outputs(
        tpipe.device_frame_step(torch.from_numpy(x), torch.from_numpy(m),
                                tcfg), tcfg, xyz.shape[0])
    _assert_outputs_equal(got, want)
    assert len(got.outlines) == got.num_clusters > 3
