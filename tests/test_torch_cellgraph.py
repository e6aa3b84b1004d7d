"""PyTorch port: the cellgraph clustering backend against the JAX package.

The same numpy-made clouds and obstacle masks go through both packages'
``ops/clustering.py::cluster``: labels, num_clusters and overflow must be
identical, on street scenes, on blobs straddling the radius, and under
every forced overflow (too few cell slots, too few ambiguous-pair slots,
capped cells in negative ambiguous pairs, a coordinate out of range).
Then the cellgraph device step (stage by stage: segmentation, cluster,
``label_runs``, hull stage) and its payload, leaf for leaf and word for
word, ``label_runs`` and ``run_frame``. The JAX results are computed once
per module (module-scoped fixtures) to keep the compiles few.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu import config as jconfig
from lidar_processing_tpu.ops import clustering as jcl
from lidar_processing_tpu.ops import hull as jhull
from lidar_processing_tpu.runtime import pipeline as jpipe
from lidar_processing_tpu_torch.interop import config_from_jax, to_numpy
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.ops import clustering as tcl
from lidar_processing_tpu_torch.ops import hull as thull
from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
from lidar_processing_tpu_torch.runtime import pipeline as tpipe
from lidar_processing_tpu_torch.tools import knife_cases as kc
from lidar_processing_tpu_torch.types import frame_of
from test_torch_native import jax_native, jax_native_lib  # noqa: F401
from test_torch_pipeline import _assert_outputs_equal, _leaves

CAP = 4096
_PCFG = dataclasses.replace(
    jconfig.DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192, max_ambiguous_pairs=8192,
    clustering_backend="cellgraph")
JCFG = jconfig.DEFAULT_CONFIG.replace(pipeline=_PCFG)
TCFG = config_from_jax(JCFG)
# forced overflows: (scene, caps), each cap alone too small for its scene;
# the blobs' cells hold more than 4 points
FORCED = {"max_cells": ("street0", dict(max_cells=64)),
          "max_ambiguous_pairs": ("street0", dict(max_ambiguous_pairs=16)),
          "cell_capacity": ("blobs", dict(cell_capacity=4)),
          "coordinate_range": ("far", {})}


def _pcfg(**caps):
    return dataclasses.replace(_PCFG, **caps)


def _blobs(seed=1234):
    """tests/test_ops.py's blob scene: 20 blobs with gaps straddling the
    0.424 m radius."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (20, 3))
    return (rng.normal(0, 0.25, (20, 80, 3)) + centers[:, None, :]
            ).reshape(-1, 3).astype(np.float32)


def _obstacles(name):
    """(xyz (CAP,3), mask (CAP,)) numpy: a street scene's obstacle mask
    from the port's segmentation, or the blobs (all valid); "far" is the
    blobs plus a point 600 m out (a coordinate past the 11-bit x range)."""
    if name.startswith("street"):
        x, m = pad_frame(street_scene(int(name[-1]), "small")[0], CAP)
        seg = gpf_segment(torch.from_numpy(x), torch.from_numpy(m),
                          TCFG.segmentation).labels.numpy()
        return x, m & (seg == 2)
    pts = _blobs()
    if name == "far":
        pts = np.concatenate([pts, [[600.0, 0.0, 0.0]]]).astype(np.float32)
    return pad_frame(pts, CAP)


def _both(x, m, pcfg):
    jcfg = JCFG.replace(pipeline=pcfg)
    want = jcl.cluster(jnp.asarray(x), jnp.asarray(m), jcfg.clustering,
                       jcfg.pipeline)
    tcfg = config_from_jax(jcfg)
    got = tcl.cluster(torch.from_numpy(x), torch.from_numpy(m),
                      tcfg.clustering, tcfg.pipeline)
    return got, want


def _assert_result_equal(got, want):
    for field in ("labels", "num_clusters", "overflow"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype == np.int32, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.fixture(scope="module")
def screen_labels():
    """tools/knife_cases.py's crafted pair per screen through both
    packages' cellgraph ``cluster`` (the caps of test_cluster_matches_jax,
    whose JAX compile this reuses)."""
    xyz, cases = kc.screen_cloud()
    got, want = _both(*pad_frame(xyz, CAP), _PCFG)
    _assert_result_equal(got, want)
    assert int(got.overflow) == 0
    return cases, got.labels.numpy(), np.asarray(want.labels)


@pytest.mark.parametrize("screen", sorted(kc.SCREENS))
def test_knife_screens_match_jax(screen, screen_labels):
    """Each screen's crafted knife pair gets the JAX package's verdict:
    the gap and rep screens and the exact row scan all round as
    fma(z, z, fma(y, y, x·x)) in both packages."""
    cases, got, want = screen_labels
    linked = kc.PORT_LINKED[screen][kc.PATHS.index("cellgraph")]
    assert kc.linked(got, cases[screen]) == linked
    assert kc.linked(want, cases[screen]) == linked


@pytest.mark.parametrize("name", ["street0", "street1", "blobs"])
def test_cluster_matches_jax(name):
    got, want = _both(*_obstacles(name), _PCFG)
    _assert_result_equal(got, want)
    assert int(got.overflow) == 0 and int(got.num_clusters) > 10


@pytest.mark.parametrize("case", sorted(FORCED))
def test_cluster_matches_jax_under_overflow(case):
    """Each forced overflow: labels, num_clusters and the (nonzero)
    overflow count equal. cell_capacity 4 caps the blobs' cells, so the
    negative verdicts on their ambiguous pairs count as maybe-missed."""
    name, caps = FORCED[case]
    got, want = _both(*_obstacles(name), _pcfg(**caps))
    _assert_result_equal(got, want)
    assert int(got.overflow) > 0


def test_cluster_batched_equals_frames_alone():
    """B = 3: a street scene, an empty frame and the frame with a point
    out of range (overflows alone); each row equals its own call."""
    clouds = [_obstacles("street1"),
              (np.zeros((CAP, 3), np.float32), np.zeros(CAP, bool)),
              _obstacles("far")]
    x, m = (torch.from_numpy(np.stack(a)) for a in zip(*clouds))
    got = tcl.cluster(x, m, TCFG.clustering, TCFG.pipeline)
    assert got.overflow.tolist()[:2] == [0, 0] and int(got.overflow[2]) > 0
    assert int(got.num_clusters[1]) == 0
    for b in range(3):
        want = tcl.cluster(x[b], m[b], TCFG.clustering, TCFG.pipeline)
        for g, w in zip(frame_of(got, b), want):
            assert g.dtype == w.dtype and torch.equal(g, w), b


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX cellgraph step of small street scenes 0 and 1, compiled
    once: {seed: (x, m, FrameResult)}."""
    out = {}
    for seed in (0, 1):
        x, m = pad_frame(street_scene(seed, "small")[0], CAP)
        out[seed] = (x, m, jpipe.device_frame_step(jnp.asarray(x),
                                                   jnp.asarray(m), JCFG))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_cellgraph_step_matches_jax(seed, jax_steps):
    """Every FrameResult leaf (planes to f32 wobble, as the stixel step)
    and every payload word, from device_frame_step and from
    device_frame_step_packed."""
    x, m, want_fr = jax_steps[seed]
    got_fr = tpipe.device_frame_step(torch.from_numpy(x),
                                     torch.from_numpy(m), TCFG)
    got, want = _leaves(to_numpy(got_fr)), _leaves(want_fr)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.startswith("seg.planes"):
            np.testing.assert_allclose(got[k], w, atol=1e-5)
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got_fr.runs.sorted_xyz.shape == (CAP, 3)
    assert int(got_fr.clustering.overflow) == 0
    want_pay = np.asarray(jpipe.pack_host_payload(want_fr, JCFG))
    np.testing.assert_array_equal(
        tpipe.pack_host_payload(got_fr, TCFG).numpy(), want_pay)
    np.testing.assert_array_equal(
        tpipe.device_frame_step_packed(torch.from_numpy(x),
                                       torch.from_numpy(m), TCFG).numpy(),
        want_pay)


def test_payload_sizes_large_points_by_rows():
    """On the cellgraph backend the sorted runs have N rows, so the
    large-point cap follows payload_large_points up to N (JAX's
    _payload_dims), not max_obstacle_points."""
    pcfg = _pcfg(max_obstacle_points=1024, payload_large_points=3000)
    jcfg = JCFG.replace(pipeline=pcfg)
    assert (tpipe._payload_dims(config_from_jax(jcfg))
            == jpipe._payload_dims(jcfg))
    assert tpipe._payload_dims(config_from_jax(jcfg))[-1] == 3000
    stixel = jcfg.replace(pipeline=dataclasses.replace(
        pcfg, clustering_backend="stixel"))
    assert tpipe._payload_dims(config_from_jax(stixel))[-1] == 1024


def test_label_runs_matches_jax(jax_steps):
    """label_runs on the cellgraph labels of scene 0 and on crafted
    labels (gaps, ids past num_slots, negatives), per frame and as a
    batch of both."""
    x, _, want_fr = jax_steps[0]
    labels = np.array(want_fr.clustering.labels)
    rng = np.random.default_rng(5)
    crafted = rng.integers(-3, 40, CAP).astype(np.int32)
    for lab in (labels, crafted):
        want = jhull.label_runs(jnp.asarray(x), jnp.asarray(lab), 32)
        got = thull.label_runs(torch.from_numpy(x), torch.from_numpy(lab), 32)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    lb = torch.from_numpy(np.stack([labels, crafted]))
    batch = thull.label_runs(xb, lb, 32)
    for b in range(2):
        for g, w in zip(frame_of(batch, b), thull.label_runs(xb[b], lb[b], 32)):
            assert torch.equal(g, w)


def test_run_frame_matches_jax(jax_steps, jax_native):
    x, m, _ = jax_steps[1]
    n = int(m.sum())
    want = jpipe.run_frame(jnp.asarray(x), jnp.asarray(m), JCFG)
    got = tpipe.run_frame(torch.from_numpy(x), torch.from_numpy(m), TCFG)
    _assert_outputs_equal(got, want)
    assert len(got.outlines) == got.num_clusters > 3
    assert len(got.cluster_labels) == n
