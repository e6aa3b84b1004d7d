"""PyTorch port: the batched step against jax.vmap and against itself.

``device_frame_step_batched`` takes B frames at once (the frame axis
written out through every op and both kernels). On seeded small scenes it
must equal the JAX package's ``jax.vmap(device_frame_step)`` leaf for
leaf (planes to f32 wobble, as tests/test_torch_pipeline.py holds the
per-frame step), and frame b of any batch must equal the per-frame step
of frame b alone bit for bit, with every counter per frame: an empty
frame, a frame that overflows a cap while its neighbours do not, and
frames of different point counts. The kernels' batched twins equal their
per-frame twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu import config as jconfig
from lidar_processing_tpu.runtime import pipeline as jpipe
from lidar_processing_tpu_torch.interop import config_from_jax, to_numpy
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.kernels import tier_min_d2 as ttm
from lidar_processing_tpu_torch.kernels import union_find as tuf
from lidar_processing_tpu_torch.runtime import pipeline as tpipe
from lidar_processing_tpu_torch.tools.kernel_cases import (tier_cases,
                                                           uf_graphs)
from lidar_processing_tpu_torch.types import frame_of

CAP = 4096
_PCFG = dataclasses.replace(
    jconfig.DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192)
JCFG = jconfig.DEFAULT_CONFIG.replace(pipeline=_PCFG)
TCFG = config_from_jax(JCFG)
# small scenes 0, 1 and 3 hold 218-264 supernodes, scene 2 251: at 240,
# scene 2 alone overflows max_supernodes
TIGHT = TCFG.replace(pipeline=dataclasses.replace(TCFG.pipeline,
                                                  max_supernodes=240))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _batch(clouds):
    xs, ms = zip(*(pad_frame(xyz, CAP) for xyz in clouds))
    return np.stack(xs), np.stack(ms)


def test_batched_step_matches_jax_vmap():
    """The port's batched step on seeds (0, 1) against the JAX package's
    jit(vmap(device_frame_step)): every leaf, and every payload word."""
    x, m = _batch([street_scene(seed, "small")[0] for seed in (0, 1)])
    want = jax.jit(jax.vmap(
        lambda a, b: jpipe.device_frame_step(a, b, JCFG)))(
            jnp.asarray(x), jnp.asarray(m))
    got = tpipe.device_frame_step_batched(torch.from_numpy(x),
                                          torch.from_numpy(m), TCFG)
    got_leaves = _leaves(to_numpy(got))
    want_leaves = {k: np.asarray(v) for k, v in _leaves(want).items()}
    assert got_leaves.keys() == want_leaves.keys()
    for k, w in want_leaves.items():
        assert got_leaves[k].shape == w.shape, k
        if k.startswith("seg.planes"):
            np.testing.assert_allclose(got_leaves[k], w, atol=1e-5)
        else:
            assert got_leaves[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got_leaves[k], w, err_msg=k)
    want_pay = np.asarray(jax.vmap(
        lambda fr: jpipe.pack_host_payload(fr, JCFG))(want))
    got_pay = tpipe.pack_host_payload(got, TCFG).numpy()
    assert got_pay.dtype == np.int32 and got_pay.shape == want_pay.shape
    np.testing.assert_array_equal(got_pay, want_pay)
    assert (got.clustering.num_clusters > 3).all()


def _mixed(name):
    small = [street_scene(s, "small")[0] for s in range(4)]
    if name == "empty_and_overflow":
        # frame 1 has no valid point; frame 2 alone overflows the
        # supernode cap
        return TIGHT, [small[0], small[0][:0], small[2]]
    # unequal point counts
    return TCFG, [small[1][:1200], small[3], small[0][:2400]]


@pytest.mark.parametrize("name", ["empty_and_overflow", "unequal_counts"])
def test_batched_step_matches_per_frame(name):
    cfg, clouds = _mixed(name)
    x, m = map(torch.from_numpy, _batch(clouds))
    got = tpipe.device_frame_step_batched(x, m, cfg)
    pay = tpipe.pack_host_payload(got, cfg)
    for key in ("num_clusters", "overflow"):
        assert getattr(got.clustering, key).shape == (3,)
    for leaf in (got.n_small, got.n_large, got.hull_overflow, got.runs.num,
                 got.runs.overflow):
        assert leaf.shape == (3,)
    for b in range(3):
        want = tpipe.device_frame_step(x[b], m[b], cfg)
        mine = _leaves(frame_of(got, b))
        for k, w in _leaves(want).items():
            assert mine[k].dtype == w.dtype and torch.equal(mine[k], w), (b, k)
        assert torch.equal(pay[b], tpipe.pack_host_payload(want, cfg)), b
    ovf = got.clustering.overflow.tolist()
    if name == "empty_and_overflow":
        assert ovf[0] == ovf[1] == 0 and ovf[2] > 0
        assert int(got.clustering.num_clusters[1]) == 0
        assert (got.seg.labels[1] == 0).all()
        assert int(got.clustering.num_clusters[0]) > 3
    else:
        assert ovf == [0, 0, 0]
        assert len(set(got.clustering.num_clusters.tolist())) == 3


def test_union_find_batched_twin_matches_per_frame():
    graphs = uf_graphs(s_cap=2048, ec=4096, seed=3)
    eu, ev, ne = (np.stack(a) for a in zip(*(g[1:] for g in graphs)))
    got = tuf.cc_labels(torch.from_numpy(eu), torch.from_numpy(ev),
                        torch.from_numpy(ne.astype(np.int32)), 2048)
    assert got.shape == (len(graphs), 2048) and got.dtype == torch.int32
    for b, (name, *g) in enumerate(graphs):
        want = tuf.cc_labels_ref(torch.from_numpy(g[0]),
                                 torch.from_numpy(g[1]),
                                 torch.tensor(g[2], dtype=torch.int32), 2048)
        assert torch.equal(got[b], want), name


def test_tier_min_d2_batched_twin_matches_per_frame():
    """Each frame its own points, descriptors, starts and counts (the four
    crafted sets of one tier table); the wrapper on CPU tensors runs the
    twin and launches nothing."""
    tiers = ((8, 32, 40), (8, 96, 16), (32, 96, 24), (96, 96, 12),
             (96, 288, 8), (288, 288, 6))
    # a different cloud for every frame
    cases = [(xyz + np.float32(b), *rest) for b, (_, xyz, *rest)
             in enumerate(tier_cases(tiers, seed=5))]
    batch = [torch.from_numpy(np.stack(a)) for a in zip(*cases)]
    before = ttm.tier_min_d2.launches
    got = ttm.tier_min_d2(*batch, tiers)
    assert ttm.tier_min_d2.launches == before
    assert got.shape == (len(cases), sum(s for *_, s in tiers))
    for b, c in enumerate(cases):
        want = ttm.tier_min_d2_ref(*map(torch.from_numpy, c), tiers)
        assert torch.equal(got[b].view(torch.int32), want.view(torch.int32))
