"""PyTorch port: stixel clustering against the JAX package, bit for bit.

Both packages get the same obstacle mask (or the same sorted segmented
inputs), so segmentation wobble cannot leak in: labels, cluster counts,
overflow counters and the sorted hand-over arrays must be identical. The
port runs its kernels' plain twins here (CPU tensors); the JAX package
runs its XLA twins.
"""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.config import DEFAULT_CONFIG
from lidar_processing_tpu.ops import segmentation as jseg
from lidar_processing_tpu.ops import stixel as jsx
from lidar_processing_tpu.types import SEG_OBSTACLE
from lidar_processing_tpu_torch.interop import config_from_jax, to_torch
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.ops import stixel as tsx
from lidar_processing_tpu_torch.types import frame_of

CAP = 4096


def _cfg(**caps):
    small = dict(max_points=CAP, max_obstacle_points=CAP, max_cells=2048,
                 max_columns=1024, max_supernodes=2048,
                 max_column_pairs=8192, max_sn_pairs=8192)
    pcfg = dataclasses.replace(DEFAULT_CONFIG.pipeline, **{**small, **caps})
    return DEFAULT_CONFIG.replace(pipeline=pcfg)


CFG = _cfg()
# caps small enough that cells, supernodes, columns and pairs overflow
TINY = _cfg(max_cells=40, max_columns=20, max_supernodes=24,
            max_column_pairs=64, max_sn_pairs=128, max_edges=32)


def _boxes_scene(seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform([-20, -20, -1.8], [20, 20, -1.65], (3000, 3))
    centers = rng.uniform([-15, -15, 0], [15, 15, 0], (8, 3))
    b = (rng.uniform([-0.8, -0.8, -1.5], [0.8, 0.8, 0.3], (8, 60, 3))
         + centers[:, None, :])
    return np.concatenate([g, b.reshape(-1, 3)]).astype(np.float32)


def _scene(name):
    return (_boxes_scene(3) if name == "boxes"
            else street_scene(int(name[-1]), "small")[0])


def _sorted_inputs(name, cfg):
    """JAX segmentation in sorted space: the shared input of both ports."""
    x, m = pad_frame(_scene(name), CAP)
    ss = jseg.gpf_segment_sorted(jnp.asarray(x), jnp.asarray(m),
                                 cfg.segmentation)
    obst = ss.valid & (ss.labels == SEG_OBSTACLE)
    return (x, m), tuple(np.asarray(a) for a in
                         (ss.xyz, obst, ss.valid, ss.orig, ss.labels))


def _assert_tree_equal(got, want):
    got = got._asdict() if hasattr(got, "_asdict") else got
    want = want._asdict() if hasattr(want, "_asdict") else want
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if hasattr(w, "_asdict"):
            _assert_tree_equal(g, w)
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", ["street0", "street1", "boxes"])
def test_sort_points_full_matches(name):
    cfg = CFG
    _, args = _sorted_inputs(name, cfg)
    h = math.sqrt(cfg.clustering.distance_squared / 3.0)
    want = jsx._sort_points_full(*map(jnp.asarray, args), cfg.pipeline, h)
    sp, *rest = tsx._sort_points_full(*(t[None] for t in to_torch(args)),
                                      config_from_jax(cfg).pipeline, h)
    got = frame_of((tsx._frame_scalars(sp), *rest), 0)
    _assert_tree_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cfg_name", ["caps", "tiny"])
@pytest.mark.parametrize("name", ["street0", "street1", "boxes"])
def test_cluster_matches_jax_on_same_obstacles(name, cfg_name):
    """The unfused entry (with _sort_points): same obstacle mask in the
    original order -> identical labels, counts and overflow; the tiny caps
    make every table overflow, and the counters must still agree."""
    cfg = CFG if cfg_name == "caps" else TINY
    (x, m), _ = _sorted_inputs(name, CFG)
    seg = jseg.gpf_segment(jnp.asarray(x), jnp.asarray(m), cfg.segmentation)
    obst = np.asarray(m & (np.asarray(seg.labels) == SEG_OBSTACLE))
    want = jsx.cluster(jnp.asarray(x), jnp.asarray(obst), cfg.clustering,
                       cfg.pipeline)
    tcfg = config_from_jax(cfg)
    got = tsx.cluster(torch.from_numpy(x), torch.from_numpy(obst),
                      tcfg.clustering, tcfg.pipeline)
    _assert_tree_equal(got, want)
    if cfg_name == "caps":
        assert int(got.overflow) == 0 and int(got.num_clusters) > 3
    else:
        assert int(got.overflow) > 0


@pytest.mark.parametrize("name", ["street0", "street1", "boxes"])
def test_cluster_fused_matches_jax(name):
    _, args = _sorted_inputs(name, CFG)
    want = jsx.cluster_fused(*map(jnp.asarray, args), CFG.clustering,
                             CFG.pipeline)
    tcfg = config_from_jax(CFG)
    got = tsx.cluster_fused(*to_torch(args), tcfg.clustering, tcfg.pipeline)
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("cfg_name", ["caps", "tiny"])
def test_cluster_batched_equals_frames_alone(cfg_name):
    """Two frames in one call (the frame axis written out through every
    stage and both kernels' twins): labels, counts and overflow counters
    of each equal the frame's own call, bit for bit; under the tiny caps
    each frame overflows by its own amount."""
    cfg = config_from_jax(CFG if cfg_name == "caps" else TINY)
    frames = []
    for name in ("street0", "boxes"):
        (x, m), args = _sorted_inputs(name, CFG)
        frames.append((x, args[1][np.argsort(args[3])]))  # original order
    x, obst = (torch.from_numpy(np.stack(a)) for a in zip(*frames))
    got = tsx.cluster(x, obst, cfg.clustering, cfg.pipeline)
    assert got.num_clusters.shape == got.overflow.shape == (2,)
    for b in range(2):
        want = tsx.cluster(x[b], obst[b], cfg.clustering, cfg.pipeline)
        for g, w in zip(got, want):
            assert g[b].dtype == w.dtype and torch.equal(g[b], w)
    if cfg_name == "tiny":
        assert (got.overflow > 0).all() and len(set(got.overflow.tolist())) > 1


def test_tier_tables_are_the_jax_packages():
    for attr in ("_TIERS_INTRA", "_TIERS_SNP", "_CHUNK", "_CHUNK_GRID",
                 "_CHUNK_PAIRS_INTRA", "_CHUNK_PAIRS_SNP", "_XY_OFFSETS",
                 "_GX", "_GY", "_GZ"):
        assert getattr(tsx, attr) == getattr(jsx, attr), attr
    assert tsx._F_BIG == float(jsx._F_BIG)


def _assert_debug_equal(got, want, path=""):
    """Integer and bool leaves equal (dtype too), recursing through the
    NamedTuples and tuples of the debug dict; float leaves bit-identical
    except the `snp_windows` checksum (see its test)."""
    if isinstance(want, dict) or hasattr(want, "_asdict"):
        want = want if isinstance(want, dict) else want._asdict()
        got = got if isinstance(got, dict) else got._asdict()
        assert got.keys() == want.keys(), path
        for k in want:
            if k != "snp_windows":
                _assert_debug_equal(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_debug_equal(g, w, f"{path}[{i}]")
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=path)


@functools.lru_cache(maxsize=None)
def _jax_debug(name):
    """A scene's padded cloud, obstacle mask (JAX segmentation) and the
    JAX package's cluster_debug of it, computed once per test process."""
    (x, m), _ = _sorted_inputs(name, CFG)
    seg = jseg.gpf_segment(jnp.asarray(x), jnp.asarray(m), CFG.segmentation)
    obst = np.asarray(m & (np.asarray(seg.labels) == SEG_OBSTACLE))
    res, dbg = jsx.cluster_debug(jnp.asarray(x), jnp.asarray(obst),
                                 CFG.clustering, CFG.pipeline)
    return x, obst, res, dbg


@pytest.mark.parametrize("name", ["street0", "boxes"])
def test_cluster_debug_matches_jax(name):
    """Every entry of the debug dict equals the JAX package's, except the
    f32 window checksum `snp_windows`: a sum of 6.8 M lanes, nearly all
    ±1e9 fills, that cancel to ~-3.3e15. It is held to 2e-5 of the lane
    bound (lanes x 1e9, about its sum of magnitudes). On street0 the
    port's sum is 4e-7 of that bound from the float64 sum and XLA's CPU
    reduction 5.1e-6: its error grows with the terms per accumulator."""
    x, obst, want_res, want = _jax_debug(name)
    tcfg = config_from_jax(CFG)
    got_res, got = tsx.cluster_debug(torch.from_numpy(x),
                                     torch.from_numpy(obst),
                                     tcfg.clustering, tcfg.pipeline)
    _assert_tree_equal(got_res, want_res)
    _assert_debug_equal(got, want)
    lanes = 3 * sum(s * (u + 8 + v + 32) for u, v, s in tsx._TIERS_SNP)
    g, w = float(got["snp_windows"]), float(want["snp_windows"])
    assert got["snp_windows"].dtype == torch.float32
    assert abs(g - w) <= 2e-5 * lanes * tsx._F_BIG, (g, w)
    assert int(got["n_edges"]) > 0 and int(got_res.num_clusters) > 3


def _pair_tests(seed, n_pts, n_pairs):
    """Crafted exact-test records over a random-walk point buffer (near
    in index = near in space): sides of 0-8, 9-32, 33-96, 97-288 points,
    chunked ones (289-700), ones beyond the chunk grid (> 8 x 288), empty
    sides; v runs often right after their u run, so some pairs link."""
    rng = np.random.default_rng(seed)
    xyz = np.cumsum(rng.normal(0.0, 0.08, (n_pts, 3)), 0).astype(np.float32)
    bands = np.array([[0, 8], [9, 32], [33, 96], [97, 288], [289, 700],
                      [2400, 2600]])
    pick = rng.choice(len(bands), (2, n_pairs),
                      p=[0.3, 0.25, 0.2, 0.13, 0.1, 0.02])
    cnt = rng.integers(bands[pick, 0], bands[pick, 1] + 1).astype(np.int32)
    cnt[:, rng.random(n_pairs) < 0.05] = 0
    us = rng.integers(0, n_pts - cnt[0] - cnt[1] - 4)
    near = rng.random(n_pairs) < 0.5
    vs = np.where(near, us + cnt[0] + rng.integers(0, 4, n_pairs),
                  rng.integers(0, n_pts - cnt[1]))
    rec = (us.astype(np.int32), cnt[0], vs.astype(np.int32), cnt[1],
           rng.permutation(n_pairs).astype(np.int32),
           rng.random(n_pairs) < 0.8)
    return xyz, rec


# (tier table, chunk capacity, pairs): the intra-column table as shipped;
# a table of few slots, so tiers and the chunk list overflow; a table with
# no tier past 96 points, so pairs of 97-288 points fit no tier
_TIER_TABLES = {
    "intra": (jsx._TIERS_INTRA, jsx._CHUNK_PAIRS_INTRA, 1200),
    "overflow": (((8, 32, 24), (8, 96, 8), (32, 96, 12), (96, 96, 6),
                  (96, 288, 4), (288, 288, 4)), 6, 400),
    "no_fit": (((8, 32, 96), (32, 96, 64), (96, 96, 32)), 16, 400)}


@pytest.mark.parametrize("table", sorted(_TIER_TABLES))
def test_tiered_exact_matches_jax(table):
    """The restructured tier pass (one tier_min_d2 call, then vector ops
    over all slots) against the JAX package's per-tier loop: verdicts,
    overflow, per-tier counts and the index checksum equal, the window
    checksum within f32 rounding of its sum of magnitudes; and without
    debug the same verdicts and overflow."""
    tiers, chunk_pairs, n_pairs = _TIER_TABLES[table]
    xyz, rec = _pair_tests(len(table), 8192, n_pairs)
    r2 = CFG.clustering.distance_squared
    want, w_ovf, w_tiers, w_dbg = jsx._tiered_exact(
        jnp.asarray(xyz), jsx._PairTest(*map(jnp.asarray, rec)), r2,
        n_pairs, tiers=tiers, chunk_pairs=chunk_pairs)
    # the port's tier pass runs on a frame batch: here, one frame
    args = (torch.from_numpy(xyz)[None],
            tsx._PairTest(*(torch.from_numpy(a)[None] for a in rec)),
            r2, n_pairs)
    got, ovf, dbg = frame_of(tsx._tiered_exact(
        *args, tiers=tiers, chunk_pairs=chunk_pairs, debug=True), 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dbg["tiers"].numpy(), np.asarray(w_tiers))
    assert int(ovf) == int(w_ovf) and ovf.dtype == torch.int32
    assert int(dbg["tier_idx"]) == int(w_dbg["tier_idx"])
    lanes = 3 * sum(s * (u + 8 + v + 32) for u, v, s in tiers)
    assert abs(float(dbg["windows"]) - float(w_dbg["windows"])) \
        <= 2e-5 * lanes * tsx._F_BIG
    plain = frame_of(tsx._tiered_exact(*args, tiers=tiers,
                                       chunk_pairs=chunk_pairs), 0)
    assert torch.equal(plain[0], got) and torch.equal(plain[1], ovf)
    assert plain[2] is None
    # the crafted records reach what the case is for
    n_in = dbg["tiers"].numpy()
    act, small = rec[5], np.minimum(rec[1], rec[3])
    large = np.maximum(rec[1], rec[3])
    assert got.any() and (~got).any() and (act & (small == 0)).any()
    assert n_in[-1] > 0                                   # some chunked
    if table == "intra":
        assert (n_in[:-1] > 0).all() and int(ovf) > 0   # beyond the grid
    if table == "overflow":
        assert (n_in[:-1] > np.array([s for *_, s in tiers])).any()
    if table == "no_fit":
        assert (act & (large > 96) & (large <= 288)).any()


def test_cluster_fused_builds_no_debug_dict(monkeypatch):
    """cluster_fused asks _cluster_core for no dict (so the main path
    launches none of its reductions) and still equals the JAX package."""
    calls = []
    core = tsx._cluster_core

    def spy(*args, **kwargs):
        out = core(*args, **kwargs)
        calls.append((kwargs.get("debug", args[3] if len(args) > 3
                                 else False), out[3]))
        return out

    monkeypatch.setattr(tsx, "_cluster_core", spy)
    _, args = _sorted_inputs("street1", CFG)
    want = jsx.cluster_fused(*map(jnp.asarray, args), CFG.clustering,
                             CFG.pipeline)
    tcfg = config_from_jax(CFG)
    got = tsx.cluster_fused(*to_torch(args), tcfg.clustering, tcfg.pipeline)
    _assert_tree_equal(got, want)
    assert calls == [(False, None)]


@pytest.mark.parametrize("name", ["street0", "boxes"])
def test_cap_tools_match_jax(name):
    """tools/measure_caps.py's per-frame quantities and tools/tier_hist.py's
    ambiguous-pair sizes, from the port's cluster_debug, equal what the
    JAX tools compute from the JAX package's on the same obstacles
    (tools/measure_caps.py:28-57, tools/tier_hist.py:49-72)."""
    from lidar_processing_tpu_torch.tools import measure_caps, tier_hist
    x, obst, res, dbg = _jax_debug(name)
    tcfg = config_from_jax(CFG)
    got = measure_caps.cluster_stats(torch.from_numpy(x),
                                     torch.from_numpy(obst), tcfg)
    s_cap = CFG.pipeline.max_supernodes
    e_u, e_v, e_ok = dbg["e_u"], dbg["e_v"], dbg["e_ok"]
    imax = jnp.int32(np.iinfo(np.int32).max)
    lab = jnp.arange(s_cap, dtype=jnp.int32)
    mn = jnp.where(e_ok, jnp.minimum(lab[e_u], lab[e_v]), imax)
    lab = lab.at[jnp.where(e_ok, lab[e_u], s_cap)].min(mn, mode="drop")
    lab = lab.at[jnp.where(e_ok, lab[e_v], s_cap)].min(mn, mode="drop")
    for _ in range(4):
        lab = lab[lab]
    live = e_ok & (lab[e_u] != lab[e_v])
    want = dict(
        n_obst=dbg["sp"].n_obst, n_cells=dbg["cells"].n_cells,
        n_sn=dbg["sn"].n_sn,
        n_cols=jnp.sum((dbg["col_sn_count"] > 0).astype(jnp.int32)),
        n_cpairs=dbg["n_cpairs"], n_snp=dbg["n_snp"],
        n_edges=jnp.sum(e_ok.astype(jnp.int32)),
        n_live=jnp.sum(live.astype(jnp.int32)),
        tiers1=dbg["tiers1"], tiers2=dbg["tiers2"], n_cls=dbg["n_cls"],
        overflow=res.overflow, num=res.num_clusters)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(got["n_live"]) > 0

    _, tdbg = tsx.cluster_debug(torch.from_numpy(x), torch.from_numpy(obst),
                                tcfg.clustering, tcfg.pipeline)
    cnt = np.asarray(dbg["cells"].count)
    intra = np.concatenate([np.maximum(cnt, np.roll(cnt, -k))[
        np.asarray(dbg[f"intra_tests{k}"])] for k in (1, 2)])
    snc = np.asarray(dbg["sn"].count)
    pu, pv = np.asarray(dbg["pu"]), np.asarray(dbg["pv"])
    amb = ((np.arange(len(pu)) < int(dbg["n_snp"]))
           & ~np.asarray(dbg["impossible"]) & ~np.asarray(dbg["certain"]))
    for g, w in zip(tier_hist.pair_sizes(tdbg),
                    (intra, np.minimum(snc[pu], snc[pv])[amb],
                     np.maximum(snc[pu], snc[pv])[amb])):
        np.testing.assert_array_equal(g, w)
