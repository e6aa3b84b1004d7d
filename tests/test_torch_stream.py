"""PyTorch port: the replay stream and the full-size synthetic scene.

The port's ReplayStream must yield what the JAX package's ReplayStream
yields on the same frame directory (the JAX side on its own native module,
the ``jax_native`` fixture), with and without stage timing; the full-size synthetic street scene
(the port's stand-in for KITTI frames) must be KITTI-like and keep the JAX
package within its static caps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu import config as jconfig
from lidar_processing_tpu.runtime import pipeline as jpipe
from lidar_processing_tpu.runtime.stream import ReplayStream as JReplay
from lidar_processing_tpu_torch.interop import config_from_jax, to_torch
from lidar_processing_tpu_torch.io import pcd as tpcd
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.runtime import pipeline as tpipe
from lidar_processing_tpu_torch.runtime.stream import ReplayStream
from test_torch_native import jax_native, jax_native_lib  # noqa: F401

CAP = 4096
_PCFG = dataclasses.replace(
    jconfig.DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192)
JCFG = jconfig.DEFAULT_CONFIG.replace(pipeline=_PCFG)
TCFG = config_from_jax(JCFG)
SEEDS = (0, 1)   # small scenes whose segmentation agrees label for label


def _assert_outputs_equal(got, want):
    for field in ("seg_labels", "cluster_labels", "intensity",
                  "num_clusters", "overflow", "outline_cluster_ids",
                  "outline_z_extents"):
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            assert g == w, field
    assert len(got.outlines) == len(want.outlines)
    for g, w in zip(got.outlines, want.outlines):
        np.testing.assert_array_equal(g, w)


def test_replay_stream_matches_jax_stream(tmp_path, jax_native):
    """The port's ReplayStream (CPU device here) yields the JAX stream's
    outputs frame for frame, cycling over the directory; a stage-timed
    replay yields the same outputs and sets the three stage times."""
    for seed in SEEDS:
        xyz, inten = street_scene(seed, "small")
        tpcd.write_pcd_xyzi(tmp_path / f"{seed:06d}.pcd", xyz, inten)
    got = list(ReplayStream(TCFG, data_dir=str(tmp_path),
                            device=torch.device("cpu")).run(3))
    want = list(JReplay(JCFG, data_dir=str(tmp_path)).run(3))
    assert [m.frame_id for _, m in got] == [0, 1, 0]
    for (go, gm), (wo, wm) in zip(got, want):
        _assert_outputs_equal(go, wo)
        for f in ("frame_id", "ground_points", "obstacle_points",
                  "num_clusters", "num_outlines", "overflow",
                  "frames_dropped"):
            assert getattr(gm, f) == getattr(wm, f), f
    timed = list(ReplayStream(TCFG, data_dir=str(tmp_path),
                              device=torch.device("cpu")).run(
                                  2, stage_timing=True))
    for (to, tm), (go, gm) in zip(timed, got):
        _assert_outputs_equal(to, go)
        assert tm.frame_id == gm.frame_id and gm.t_seg_ms is None
        for t in (tm.t_seg_ms, tm.t_cluster_ms, tm.t_hull_ms):
            assert t is not None and t >= 0.0
        assert tm.t_seg_ms + tm.t_cluster_ms <= tm.t_dispatch_ms


def test_replay_stream_without_a_device_needs_a_gpu(tmp_path, monkeypatch):
    """device=None means the card: with no GPU the stream raises instead
    of quietly replaying on the CPU."""
    xyz, inten = street_scene(0, "small")
    tpcd.write_pcd_xyzi(tmp_path / "000000.pcd", xyz, inten)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplayStream(TCFG, data_dir=str(tmp_path))
    stream = ReplayStream(TCFG, data_dir=str(tmp_path), device="cpu")
    assert stream.xyz.device.type == "cpu"


def test_full_size_scene_fits_the_jax_caps():
    """The full-size synthetic scene is KITTI-like (98k-124k points, about
    35-45% obstacles, 300-600 clusters) and the JAX package runs it at
    DEFAULT_CONFIG without overflowing any cap; the port packs that frame's
    result into the same payload words."""
    xyz, _ = street_scene(0)
    cfg = jconfig.DEFAULT_CONFIG
    x, m = pad_frame(xyz, cfg.pipeline.max_points)
    fr = jpipe.device_frame_step(jnp.asarray(x), jnp.asarray(m), cfg)
    pay = np.asarray(jpipe.pack_host_payload(fr, cfg))
    n = xyz.shape[0]
    assert 98_000 <= n <= 124_000
    assert int(pay[3]) == 0, "overflow"
    assert 300 <= int(pay[2]) <= 600, int(pay[2])
    obstacle = float(np.mean(np.asarray(fr.seg.labels)[:n] == 2))
    assert 0.35 <= obstacle <= 0.45, obstacle
    # the port packs JAX's full-size FrameResult into the same words
    got = tpipe.pack_host_payload(to_torch(fr), config_from_jax(cfg))
    np.testing.assert_array_equal(got.numpy(), pay)
