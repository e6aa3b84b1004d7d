"""PyTorch port: x-band spatial sharding against the JAX package and
against the port's single-device path, on the CPU, one rank holding every
shard.

The configurations are tests/test_spatial.py's (blobs on 8 shards, the
size filter across bands, the 2 x 4 mesh, the full spatial step). The
contract: ``cluster_spatial`` / ``cluster_spatial_2d`` labels,
``num_clusters`` and ``overflow`` bit-identical to the JAX
``cluster_spatial`` on the conftest's 8-device mesh and to the port's
``stixel.cluster``; ``gpf_spatial`` within max(2, n // 1000) labels of the
JAX ``gpf_spatial`` and of ``gpf_segment`` (float32 moment summation
order); ``device_frame_step_spatial``'s clustering bit-identical to the
single-device clustering of its own obstacle mask; ``sharded_batch_step``
equal to ``device_frame_step_batched`` leaf for leaf; dropped points never
silent; a pair on the knife edge d² = R² across a band boundary decided
as the single-device exact test decides it.
tests/test_torch_distributed.py runs the same entry points over 4 gloo
ranks.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from lidar_processing_tpu import config as jconfig
from lidar_processing_tpu.ops import stixel as jsx
from lidar_processing_tpu.parallel import frame_spatial as jfs
from lidar_processing_tpu.parallel import spatial as jsp
from lidar_processing_tpu_torch.config import (DEFAULT_CONFIG,
                                                PORT_PIPELINE_FIELDS,
                                                SpatialConfig)
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.ops import stixel as sx
from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
from lidar_processing_tpu_torch.parallel import mesh as pmesh
from lidar_processing_tpu_torch.parallel.frame_spatial import (
    device_frame_step_spatial, gpf_spatial)
from lidar_processing_tpu_torch.parallel.sharded import (
    make_mesh, make_mesh_2d, sharded_batch_step, sharded_pipeline_2d)
from lidar_processing_tpu_torch.parallel.spatial import (cluster_spatial,
                                                         cluster_spatial_2d)
from lidar_processing_tpu_torch.runtime.pipeline import (
    device_frame_step, device_frame_step_batched)
from lidar_processing_tpu_torch.tools import knife_cases as kc
from lidar_processing_tpu_torch.types import SEG_OBSTACLE, SEG_UNKNOWN

CFG = DEFAULT_CONFIG
R = math.sqrt(CFG.clustering.distance_squared)
# tests/test_spatial.py's per-band caps, by cloud size
SCFG_8K = SpatialConfig(block_points=4096, block_clusters=1024,
                        halo_points=1024, block_cells=4096,
                        block_columns=2048, block_supernodes=3072,
                        block_column_pairs=8192, block_sn_pairs=8192,
                        block_live_edges=2048)
SCFG_4K = SpatialConfig(block_points=2048, block_clusters=512,
                        halo_points=512, block_cells=2048, block_columns=1024,
                        block_supernodes=1536, block_column_pairs=4096,
                        block_sn_pairs=4096, block_live_edges=1024)
SCFG_1K = SpatialConfig(block_points=256, block_clusters=128,
                        halo_points=128, block_cells=256, block_columns=128,
                        block_supernodes=192, block_column_pairs=512,
                        block_sn_pairs=512, block_live_edges=128)


def _jax_mesh(shape=(8,), names=("space",)):
    return JaxMesh(np.asarray(jax.devices()[:8]).reshape(shape), names)


def _jax_cfg(cfg):
    """The JAX package's EngineConfig with the port config's fields (the
    port's own pipeline capacities are module constants there)."""
    tree = dataclasses.asdict(cfg)
    for name in PORT_PIPELINE_FIELDS:
        tree["pipeline"].pop(name)
    return jconfig.EngineConfig(**{
        f.name: type(getattr(jconfig.DEFAULT_CONFIG, f.name))(**tree[f.name])
        for f in dataclasses.fields(jconfig.EngineConfig)})


def _mesh(n, axis="space"):
    return make_mesh(n, axis, device="cpu")


def _blobs(rng, n_rail, n_blob, half):
    """tests/test_spatial.py's cloud: a dense rail along x (crossing
    every band boundary) plus blobs of 4."""
    rail = rng.uniform([-half, 0, 0], [half, 0.1, 0.1], (n_rail, 3))
    centers = rng.uniform([-half + 5, -half + 5, -1], [half - 5, half - 5, 1],
                          (n_blob // 4, 3))
    blobs = rng.normal(0, 0.15, (n_blob, 3)) + np.repeat(centers, 4, axis=0)
    return np.concatenate([rail, blobs]).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_cluster_equal(got, want, overflow=0):
    np.testing.assert_array_equal(np.asarray(got.labels),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(np.asarray(got.num_clusters),
                                  np.asarray(want.num_clusters))
    np.testing.assert_array_equal(np.asarray(got.overflow), overflow)
    np.testing.assert_array_equal(np.asarray(want.overflow), overflow)


def test_blobs_on_8_shards_match_jax_and_single_device():
    x, m = pad_frame(_blobs(np.random.default_rng(1234), 3000, 3000, 40),
                     8192)
    pcfg = dataclasses.replace(CFG.pipeline, max_points=8192)
    tx, tm = _t(x, m)
    got = cluster_spatial(_mesh(8), tx, tm, CFG.clustering, pcfg, SCFG_8K)
    _assert_cluster_equal(got, sx.cluster(tx, tm, CFG.clustering, pcfg))
    jcfg = _jax_cfg(CFG.replace(pipeline=pcfg, spatial=SCFG_8K))
    want = jsp.cluster_spatial(_jax_mesh(), jnp.asarray(x), jnp.asarray(m),
                               jcfg.clustering, jcfg.pipeline, jcfg.spatial)
    _assert_cluster_equal(got, want)
    assert int(got.num_clusters) > 100


def test_size_filter_applies_to_merged_sizes():
    """A chain whose 2-point fragments are each under min_cluster_size
    survives as one cluster; an isolated pair is INVALID everywhere."""
    chain = np.stack([np.arange(16) * 0.4, np.zeros(16), np.zeros(16)], 1)
    pair = np.array([[100.0, 50, 0], [100.3, 50, 0]])
    x, m = pad_frame(np.concatenate([chain, pair]).astype(np.float32), 1024)
    pcfg = dataclasses.replace(
        CFG.pipeline, max_points=1024, max_obstacle_points=1024,
        max_cells=512, max_columns=256, max_supernodes=384,
        max_column_pairs=1024, max_sn_pairs=1024, max_live_edges=256)
    tx, tm = _t(x, m)
    got = cluster_spatial(_mesh(8), tx, tm, CFG.clustering, pcfg, SCFG_1K)
    _assert_cluster_equal(got, sx.cluster(tx, tm, CFG.clustering, pcfg))
    lab = got.labels.numpy()
    assert (lab[:16] == lab[0]).all() and lab[0] >= 0
    assert (lab[16:18] == -1).all()


def test_2d_mesh_matches_jax_and_single_device():
    rng = np.random.default_rng(7)
    frames = [pad_frame(_blobs(rng, 1000, 1000, 30), 4096)
              for _ in range(2)]
    xs, ms = (np.stack(a) for a in zip(*frames))
    pcfg = dataclasses.replace(CFG.pipeline, max_points=4096)
    txs, tms = _t(xs, ms)
    mesh = make_mesh_2d(2, 4, device="cpu")
    got = cluster_spatial_2d(mesh, txs, tms, CFG.clustering, pcfg, SCFG_4K)
    _assert_cluster_equal(got, sx.cluster(txs, tms, CFG.clustering, pcfg),
                          overflow=[0, 0])
    jcfg = _jax_cfg(CFG.replace(pipeline=pcfg, spatial=SCFG_4K))
    want = jsp.cluster_spatial_2d(
        _jax_mesh((2, 4), ("data", "space")), jnp.asarray(xs),
        jnp.asarray(ms), jcfg.clustering, jcfg.pipeline, jcfg.spatial)
    _assert_cluster_equal(got, want, overflow=[0, 0])


@pytest.fixture(scope="module")
def step_frame():
    """tests/test_spatial.py's full-step cloud: ground, rail and blobs."""
    rng = np.random.default_rng(11)
    rail = rng.uniform([-30, 0, 0], [30, 0.1, 0.1], (800, 3))
    centers = rng.uniform([-25, -25, -0.8], [25, 25, 0.5], (200, 3))
    blobs = rng.normal(0, 0.15, (800, 3)) + np.repeat(centers, 4, axis=0)
    ground = rng.uniform([-30, -30, -1.78], [30, 30, -1.70], (1500, 3))
    xyz = np.concatenate([ground, rail, blobs]).astype(np.float32)
    x, m = pad_frame(xyz, 4096)
    cfg = CFG.replace(pipeline=dataclasses.replace(
        CFG.pipeline, max_points=4096, max_obstacle_points=4096),
        spatial=SCFG_4K)
    return x, m, xyz.shape[0], cfg


def test_gpf_spatial_within_tolerance_of_jax_and_single_device(step_frame):
    x, m, n, cfg = step_frame
    tol = max(2, n // 1000)
    seg, ovf = gpf_spatial(_mesh(8), *_t(x, m), cfg.segmentation,
                           cfg.spatial, R)
    assert int(ovf) == 0
    lab = seg.labels.numpy()
    single = gpf_segment(*_t(x, m), cfg.segmentation).labels.numpy()
    assert int(np.sum(lab[:n] != single[:n])) <= tol
    assert (lab[n:] == SEG_UNKNOWN).all()
    jcfg = _jax_cfg(cfg)
    mesh = _jax_mesh()
    with mesh:
        jseg, jovf = jfs.gpf_spatial(mesh, jnp.asarray(x), jnp.asarray(m),
                                     jcfg.segmentation, jcfg.spatial, R)
    assert int(jovf) == 0
    assert int(np.sum(lab[:n] != np.asarray(jseg.labels)[:n])) <= tol


def test_device_frame_step_spatial_contract(step_frame):
    x, m, n, cfg = step_frame
    tx, tm = _t(x, m)
    fr = device_frame_step_spatial(_mesh(8), tx, tm, cfg)
    single = device_frame_step(tx, tm, cfg)
    seg_diff = int((fr.seg.labels[:n] != single.seg.labels[:n]).sum())
    assert seg_diff <= max(2, n // 1000), seg_diff
    obstacle = tm & (fr.seg.labels == SEG_OBSTACLE)
    ref = sx.cluster(tx, obstacle, cfg.clustering, cfg.pipeline)
    _assert_cluster_equal(fr.clustering, ref)
    assert int(fr.hull_overflow) == 0
    assert int(fr.n_small) + int(fr.n_large) == int(fr.clustering.num_clusters)
    assert int(fr.clustering.num_clusters) > 50


def test_sharded_batch_step_equals_batched_step():
    cfg = CFG.replace(pipeline=dataclasses.replace(
        CFG.pipeline, max_points=4096, max_obstacle_points=4096,
        max_cells=2048, max_columns=1024, max_supernodes=2048,
        max_column_pairs=8192, max_sn_pairs=8192))
    frames = [pad_frame(street_scene(s, "small")[0], 4096) for s in (0, 1)]
    xs, ms = _t(*(np.stack(a) for a in zip(*frames)))
    got = sharded_batch_step(_mesh(2, "data"), xs, ms, cfg)
    want = device_frame_step_batched(xs, ms, cfg)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_batch_step(_mesh(2, "data"), xs[:1], ms[:1], cfg)
    with pytest.raises(ValueError, match="must equal"):
        sharded_pipeline_2d(make_mesh_2d(4, 2, device="cpu"), xs, ms, cfg)


def test_dropped_points_are_overflow_and_unknown(step_frame):
    """block_points under a band's population: the dropped points come
    back SEG_UNKNOWN and every entry point counts them as overflow (the
    JAX package's commit 2f03c49)."""
    x, m, n, cfg = step_frame
    cfg = cfg.replace(spatial=dataclasses.replace(cfg.spatial,
                                                  block_points=256))
    tx, tm = _t(x, m)
    seg, ovf = gpf_spatial(_mesh(8), tx, tm, cfg.segmentation, cfg.spatial,
                           R)
    full = gpf_spatial(_mesh(8), tx, tm, cfg.segmentation, SCFG_4K, R)[0]
    unknown = [int((t.labels[:n] == SEG_UNKNOWN).sum()) for t in (seg, full)]
    assert int(ovf) > 0 and unknown[0] == unknown[1] + int(ovf)
    cl = cluster_spatial(_mesh(2), tx, tm, cfg.clustering, cfg.pipeline,
                         cfg.spatial)
    assert int(cl.overflow) > 0


# tools/knife_cases.py's KNIFE rows, (x of A, x of B, z of B): d² of A =
# (xa, y, 0) and B = (xb, y, zb) is, summed unfused (dx², + dy², + dz²) in
# float32, one ULP under R² = 0.18f, equal to it, one ULP over it, and
# equal to it where fma(dz, dz, dx²) rounds one ULP over. The port's
# screens round as the JAX package's (that fma), so both decide row 4
# alike (ROADMAP §3).
KNIFE_LINKED = (True, True, False, False)
KNIFE_LINKED_JAX = (True, True, False, False)


def test_knife_edge_pairs_across_a_band_boundary():
    """Pairs straddling the boundary of 2 bands (x in [-10, 10]: the
    boundary lies at x ~ 1e-5), each end chained to 3 more points on its
    own side so both ends are clusters of 4: a pair whose float32 d² is
    <= R² links them into one cluster of 8, on the band path as on the
    single-device path and in the JAX package's single-device clustering,
    where d² rounds as fma(dz, dz, fma(dy, dy, dx²)) (dy = 0 here)."""
    f32 = np.float32
    for row, (xa, xb, zb) in enumerate(kc.KNIFE):
        d = np.array([xa, 0, 0], f32) - np.array([xb, 0, zb], f32)
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        fused = kc.d2_fma_yx(d)
        assert (d2 <= f32(0.18)) == (row != 2)
        assert (fused <= f32(0.18), fused <= f32(0.18)) == (
            KNIFE_LINKED[row], KNIFE_LINKED_JAX[row])
    # the crafted screens' caps (the shipped ones at 8192 points), so the
    # JAX package's stixel compile serves both tests
    pcfg = kc.PIPELINE
    x, m = pad_frame(kc.knife_rows(), pcfg.max_points)
    tx, tm = _t(x, m)
    got = cluster_spatial(_mesh(2), tx, tm, CFG.clustering, pcfg, SCFG_1K)
    _assert_cluster_equal(got, sx.cluster(tx, tm, CFG.clustering, pcfg))
    jlab = np.asarray(jsx.cluster(jnp.asarray(x), jnp.asarray(m),
                                  _jax_cfg(CFG).clustering,
                                  _jax_cfg(CFG.replace(pipeline=pcfg)
                                           ).pipeline).labels)
    assert kc.knife_linked(got.labels.numpy()) == KNIFE_LINKED
    assert kc.knife_linked(jlab) == KNIFE_LINKED_JAX


@pytest.fixture(scope="module")
def screen_runs():
    """tools/knife_cases.py's crafted pair per screen, through the port's
    and the JAX package's stixel ``cluster`` and ``cluster_spatial`` (8
    bands: the pairs across a boundary straddle the 4th; the caps of
    test_blobs_on_8_shards_match_jax_and_single_device, whose JAX compile
    this reuses; chip_smoke.py runs 2 bands at the shipped SpatialConfig):
    {path: labels}."""
    xyz, cases = kc.screen_cloud()
    x, m = pad_frame(xyz, kc.PIPELINE.max_points)
    cfg = CFG.replace(pipeline=kc.PIPELINE, spatial=SCFG_8K)
    jcfg = _jax_cfg(cfg)
    tx, tm = _t(x, m)
    jx, jm = jnp.asarray(x), jnp.asarray(m)
    runs = {
        "port stixel": sx.cluster(tx, tm, cfg.clustering, cfg.pipeline),
        "port bands": cluster_spatial(_mesh(8), tx, tm, cfg.clustering,
                                      cfg.pipeline, cfg.spatial),
        "jax stixel": jsx.cluster(jx, jm, jcfg.clustering, jcfg.pipeline),
        "jax bands": jsp.cluster_spatial(_jax_mesh(), jx, jm,
                                         jcfg.clustering, jcfg.pipeline,
                                         jcfg.spatial)}
    for name, r in runs.items():
        assert int(np.asarray(r.overflow)) == 0, name
    return cases, {k: np.asarray(r.labels) for k, r in runs.items()}


@pytest.mark.parametrize("screen", sorted(kc.SCREENS))
def test_knife_screens_match_jax(screen, screen_runs):
    """Each screen's crafted knife pair gets the JAX package's verdict on
    the single-device path and on the band path. Two known exceptions,
    both the JAX package's own: its bands' stixel (block_cells 4096 here,
    16384 shipped) rounds the k = 1 cell rep screen unfused, its single
    device (max_cells 20480) fused, and the port fuses both
    (``cell_rep``); and a pair
    across the band boundary goes through the halo test (fused as
    fma(z, z, fma(y, y, x²))) on the bands and through the exact test
    (fma(z, z, fma(x, x, y²))) on one device (``halo_split``), so the
    bands == single-device gate does not hold for it, in either package."""
    cases, labels = screen_runs
    case = cases[screen]
    got = {p: kc.linked(labels[f"port {p}"], case) for p in ("stixel",
                                                              "bands")}
    want = {p: kc.linked(labels[f"jax {p}"], case) for p in ("stixel",
                                                              "bands")}
    jax_table = dict(zip(kc.PATHS, kc.JAX_LINKED[screen]))
    port_table = dict(zip(kc.PATHS, kc.PORT_LINKED[screen]))
    assert want == {p: jax_table[p] for p in want}
    assert got == {p: port_table[p] for p in got}
    if screen == "cell_rep":
        assert (got["bands"], want["bands"]) == (True, False)
        assert got["stixel"] == want["stixel"]
    else:
        assert got == want
    if screen != "halo_split":
        assert got["bands"] == got["stixel"]


def test_shards_must_divide_over_the_ranks(monkeypatch):
    monkeypatch.setattr(pmesh, "_world", lambda: (0, 4))
    with pytest.raises(ValueError, match="do not divide"):
        make_mesh(6, "space", device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        make_mesh_2d(2, 3, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        make_mesh(0, "data", device="cpu")


def test_mesh_needs_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(8, "space")
    assert make_mesh(8, "space", device="cpu").device.type == "cpu"
