"""PyTorch port on the card: CUDA kernels and the CUDA path vs the twins.

Every test here needs an NVIDIA GPU (marked `cuda`) and skips without
one. The file imports no jax, so it also runs on a machine without jax:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_processing_tpu_torch.config import DEFAULT_CONFIG
from lidar_processing_tpu_torch.io.synthetic import pad_frame, street_scene
from lidar_processing_tpu_torch.kernels import probe_uf as puf
from lidar_processing_tpu_torch.kernels import tier_min_d2 as ttm
from lidar_processing_tpu_torch.kernels import union_find as tuf
from lidar_processing_tpu_torch.kernels.min_d2 import (min_d2_planar,
                                                       min_d2_planar_ref)
from lidar_processing_tpu_torch.ops import stixel as tsx
from lidar_processing_tpu_torch.ops.segmentation import gpf_segment_sorted
from lidar_processing_tpu_torch.runtime import pipeline as tpipe
from lidar_processing_tpu_torch.runtime.pipeline import (
    device_frame_step_packed)
from lidar_processing_tpu_torch.tools import probe_uf, probe_uf2
from lidar_processing_tpu_torch.tools.kernel_cases import (tier_cases,
                                                           uf_graphs,
                                                           uf_oracle)
from lidar_processing_tpu_torch.types import SEG_OBSTACLE, frame_of

pytestmark = pytest.mark.cuda

CAP = 4096
CFG = DEFAULT_CONFIG.replace(pipeline=dataclasses.replace(
    DEFAULT_CONFIG.pipeline, max_points=CAP, max_obstacle_points=CAP,
    max_cells=2048, max_columns=1024, max_supernodes=2048,
    max_column_pairs=8192, max_sn_pairs=8192))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def test_min_d2_kernel_matches_twin_at_tier_shapes(cuda):
    rng = np.random.default_rng(0)
    for u_cap, v_cap, slots in tsx._TIERS_INTRA + tsx._TIERS_SNP:
        wu, wv = u_cap + 8, v_cap + 32
        planes = [rng.uniform(-30, 30, (slots, w)).astype(np.float32)
                  for w in (wu, wu, wu, wv, wv, wv)]
        for a in planes[:3]:
            a[::5, wu // 2:] = 1.0e9
        for a in planes[3:]:
            a[::3, wv // 3:] = -1.0e9
        args = [torch.from_numpy(a).to(cuda) for a in planes]
        before = min_d2_planar.launches
        got = min_d2_planar(*args).cpu().numpy()
        assert min_d2_planar.launches == before + 1
        assert _ulp(got, min_d2_planar_ref(*args).cpu().numpy()) <= 4


def test_union_find_kernel_matches_twin(cuda):
    rng = np.random.default_rng(1)
    for s_cap, n_edges in ((128, 0), (2048, 4000), (10240, 32000)):
        eu = rng.integers(0, s_cap, 32768).astype(np.int32)
        ev = np.minimum(s_cap - 1, eu + rng.integers(1, 30, 32768)
                        ).astype(np.int32)
        eu, ev = torch.from_numpy(eu).to(cuda), torch.from_numpy(ev).to(cuda)
        ne = torch.tensor(n_edges, dtype=torch.int32, device=cuda)
        got = tuf.cc_labels(eu, ev, ne, s_cap).cpu().numpy()
        np.testing.assert_array_equal(
            got, tuf.cc_labels_ref(eu, ev, ne, s_cap).cpu().numpy())


def _graphs(cuda):
    """The contract graphs and probe_uf2's fallback graph, on the card."""
    eu, ev, ne = probe_uf2.make_inputs()
    for name, *g in uf_graphs() + [("probe_uf2", eu, ev, ne)]:
        yield name, g, (torch.from_numpy(g[0]).to(cuda),
                        torch.from_numpy(g[1]).to(cuda),
                        torch.tensor(g[2], dtype=torch.int32, device=cuda))


def test_union_find_kernel_on_contract_graphs(cuda):
    for name, g, args in _graphs(cuda):
        before = tuf.cc_labels.launches
        got = tuf.cc_labels(*args, 10240).cpu()
        assert tuf.cc_labels.launches == before + 1
        assert torch.equal(got, tuf.cc_labels_ref(*args, 10240).cpu()), name
        np.testing.assert_array_equal(got.numpy(),
                                      uf_oracle(*g, 10240), err_msg=name)


def test_uf_serial_matches_twin(cuda):
    for name, _, args in _graphs(cuda):
        before = puf.uf_serial.launches
        got = puf.uf_serial(*args, 10240).cpu()
        assert puf.uf_serial.launches == before + 1
        assert torch.equal(got, tuf.cc_labels_ref(*args, 10240).cpu()), name


@pytest.mark.parametrize("name", list(puf.VARIANTS))
def test_uf_probe_kernels_match_oracle(cuda, name):
    """Each instantiation of csrc/probe_uf.cu on every contract graph,
    probe_uf's graph and probe_uf2's fallback graph: the contract's labels
    (scipy), one launch counted a call."""
    fn = getattr(puf, name)
    packed = name.startswith("uf_packed")
    eu, ev, ne = probe_uf.make_inputs()
    for graph, g, (teu, tev, tne) in [
            *_graphs(cuda),
            ("probe_uf", (eu, ev, ne), tuple(
                torch.as_tensor(a, dtype=torch.int32, device=cuda)
                for a in (eu, ev, ne)))]:
        if packed:
            euv = puf.pack_edges(teu, tev)
            a, b = (t.cpu().numpy() for t in puf.unpack_edges(euv))
            args = (euv, tne)
        else:
            a, b = g[0], g[1]
            args = (teu, tev, tne)
        before = fn.launches
        got = fn(*args, 10240).cpu().numpy()
        assert fn.launches == before + 1, graph
        np.testing.assert_array_equal(got, uf_oracle(a, b, g[2], 10240),
                                      err_msg=graph)


def test_staged_uf_reads_the_edges_past_the_last_granule(cuda):
    """ec no multiple of 4 with n_edges at or past ec: the producer reads
    the last 1-3 edges itself; ec over one chunk puts them in a later
    stage. Every staged variant gives the contract's labels."""
    rng = np.random.default_rng(7)
    for ec in (5, 1001, 1002, 1003, 4099):
        eu = rng.integers(0, 300, ec).astype(np.int32)
        ev = np.minimum(299, eu + rng.integers(1, 4, ec)).astype(np.int32)
        teu, tev = (torch.from_numpy(a).to(cuda) for a in (eu, ev))
        euv = puf.pack_edges(teu, tev)
        for ne in (ec - 1, ec, ec + 3):
            tne = torch.tensor(ne, dtype=torch.int32, device=cuda)
            want = uf_oracle(eu, ev, ne, 300)
            for got in (puf.uf_probe(teu, tev, tne, 300),
                        puf.uf_serial(teu, tev, tne, 300),
                        puf.uf_packed(euv, tne, 300),
                        puf.uf_packed_noskip(euv, tne, 300)):
                np.testing.assert_array_equal(got.cpu().numpy(), want,
                                              err_msg=f"ec={ec} ne={ne}")


def test_staged_uf_rejects_a_misaligned_edge_view(cuda):
    """A bulk copy needs a 16-byte aligned source: an edge view 4 bytes
    into its storage raises, and a fresh copy of it is taken."""
    e = torch.arange(1025, dtype=torch.int32, device=cuda) % 64
    ne = torch.tensor(1000, dtype=torch.int32, device=cuda)
    before = puf.uf_serial.launches
    with pytest.raises(ValueError, match="16-byte"):
        puf.uf_serial(e[1:], e[:1024], ne, 64)
    with pytest.raises(ValueError, match="16-byte"):
        puf.uf_packed(e[1:], ne, 64)
    assert puf.uf_serial.launches == before
    got = puf.uf_serial(e[1:].clone(), e[:1024], ne, 64)
    assert torch.equal(got, tuf.cc_labels_ref(e[1:], e[:1024], ne, 64))


@pytest.mark.parametrize("table", ["intra", "snp"])
def test_tier_min_d2_kernel_matches_twin(cuda, table):
    """Bit for bit at the shipped tier tables' full slot counts, on every
    crafted descriptor set (overflowing tiers and a clamped slice start,
    empty sides, counts past the caps, runs ending at and running past the
    last point of a full-size buffer)."""
    tiers = tsx._TIERS_INTRA if table == "intra" else tsx._TIERS_SNP
    n = DEFAULT_CONFIG.pipeline.max_obstacle_points
    for name, *case in tier_cases(tiers, n=n, seed=len(table)):
        args = [torch.from_numpy(a).to(cuda) for a in case]
        before = ttm.tier_min_d2.launches
        got = ttm.tier_min_d2(*args, tiers).cpu()
        assert ttm.tier_min_d2.launches == before + 1
        want = ttm.tier_min_d2_ref(*args, tiers).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (name, int((got != want).sum()))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    good = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError):
        min_d2_planar(good, good, good.double(), good, good, good)
    with pytest.raises(ValueError):
        min_d2_planar(good, good, good, good, good, good.t())
    e = torch.zeros(8, dtype=torch.int32, device=cuda)
    for bad in (60000, 0):
        with pytest.raises(ValueError):
            tuf.cc_labels(e, e, e[:1].reshape(()), bad)
    for fn in (tuf.cc_labels, puf.uf_serial):
        with pytest.raises(ValueError):
            fn(e.long(), e, e[:1].reshape(()), 64)
        with pytest.raises(ValueError):
            fn(e, e.cpu(), e[:1].reshape(()), 64)
        with pytest.raises(ValueError):
            fn(e, e[:4], e[:1].reshape(()), 64)
        with pytest.raises(ValueError):
            fn(e, torch.zeros(16, dtype=torch.int32, device=cuda)[::2],
               e[:1].reshape(()), 64)
    tiers = ((8, 32, 8),)
    xyz = torch.zeros((64, 3), device=cuda)
    d = torch.zeros(16, dtype=torch.int32, device=cuda)
    t1 = d[:1]
    ok = (xyz, d, d, t1, t1)
    assert ttm.tier_min_d2(*ok, tiers).shape == (8,)
    for i, bad in ((0, xyz.double()), (0, xyz[:40]), (0, xyz.t().contiguous()),
                   (0, xyz.t()), (1, d.float()), (2, d[:8]), (3, d[:2]),
                   (4, t1.cpu()), (1, d.reshape(4, 4))):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError):
            ttm.tier_min_d2(*args, tiers)
    for bad_tiers in (((8, 32, 17),), ((8, 320, 8),), tiers * 9):
        with pytest.raises(ValueError):
            ttm.tier_min_d2(*ok, bad_tiers)


@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_path_matches_cpu_path(cuda, seed):
    """cluster_fused on the card (kernels) == on the CPU (twins) from the
    same sorted inputs; the packed payload too where segmentation agrees."""
    xyz, _ = street_scene(seed, "small")
    x, m = (torch.from_numpy(a) for a in pad_frame(xyz, CAP))
    ss = gpf_segment_sorted(x.to(cuda), m.to(cuda), CFG.segmentation)
    args = (ss.xyz, ss.valid & (ss.labels == SEG_OBSTACLE), ss.valid,
            ss.orig, ss.labels)
    on_gpu = tsx.cluster_fused(*args, CFG.clustering, CFG.pipeline)
    on_cpu = tsx.cluster_fused(*(a.cpu() for a in args), CFG.clustering,
                               CFG.pipeline)
    for g, c in zip((*on_gpu.result, *on_gpu[1:]),
                    (*on_cpu.result, *on_cpu[1:])):
        assert g.dtype == c.dtype and torch.equal(g.cpu(), c)
    pay_gpu = device_frame_step_packed(x.to(cuda), m.to(cuda), CFG).cpu()
    pay_cpu = device_frame_step_packed(x, m, CFG)
    assert torch.equal(pay_gpu, pay_cpu)


def test_probe_union_find_kernels_match_twin(cuda):
    from lidar_processing_tpu_torch.kernels import probe_uf as puf
    from lidar_processing_tpu_torch.tools import probe_uf, probe_uf2
    for make in (probe_uf.make_inputs, probe_uf2.make_inputs):
        eu, ev, ne = make()
        eu, ev = torch.from_numpy(eu).to(cuda), torch.from_numpy(ev).to(cuda)
        ne = torch.tensor(ne, dtype=torch.int32, device=cuda)
        euv = puf.pack_edges(eu, ev)
        want = tuf.cc_labels_ref(eu, ev, ne, 10240).cpu()
        before = (puf.uf_probe.launches, puf.uf_packed.launches,
                  puf.uf_packed_noskip.launches)
        for got in (puf.uf_probe(eu, ev, ne, 10240),
                    puf.uf_packed(euv, ne, 10240),
                    puf.uf_packed_noskip(euv, ne, 10240)):
            assert torch.equal(got.cpu(), want)
        assert (puf.uf_probe.launches, puf.uf_packed.launches,
                puf.uf_packed_noskip.launches) == tuple(b + 1 for b in before)


def test_pair_kernels_match_twin(cuda):
    from lidar_processing_tpu_torch.kernels import probe_pairs as pp
    from lidar_processing_tpu_torch.tools import probe_mosaic, probe_mosaic3
    for fn, v_cap, (_, rows, *runs), lanes in (
            (pp.pair_min_d2_v48, 48, probe_mosaic.make_inputs(), 8),
            (pp.pair_min_d2_v96, 96, probe_mosaic3.make_inputs(), 128)):
        planes = pp.row_planes(torch.from_numpy(rows).to(cuda), lanes)
        runs = [torch.from_numpy(a).to(cuda) for a in runs]
        got = fn(*planes, *runs).cpu().numpy()
        want = pp.pair_min_d2_ref(*planes, *runs, v_cap).cpu().numpy()
        assert _ulp(got, want) <= 4


def test_mosaic2_kernels_match_twins(cuda):
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    from lidar_processing_tpu_torch.tools import probe_mosaic2
    idx, val = (torch.from_numpy(a).to(cuda)
                for a in probe_mosaic2.scalar_loads_inputs(16384))
    # the probe's size, and ragged ones: n % 4 != 0 for the int4 loop
    for n in (16384, 16383, 16381, 3, 0):
        i_n = idx[:n].clone()
        want = m2.gather_sum_ref(i_n, val)
        before = (m2.gather_sum.launches, m2.gather_sum_v0.launches)
        for got in (m2.gather_sum(i_n, val), m2.gather_sum(i_n, val, "atomic"),
                    m2.gather_sum_v0(i_n, val)):
            assert got.shape == (1, 1) and torch.equal(got, want), n
        assert (m2.gather_sum.launches, m2.gather_sum_v0.launches) == (
            before[0] + 2, before[1] + 1)
    with pytest.raises(ValueError, match="aligned"):
        m2.gather_sum(idx[1:], val)
    # a non-multiple of 1024 elements: the last block partly idle
    for n in (16384, 16384 + 128, 128):
        x = torch.randn(n, device=cuda)
        want = m2.tile_scale_ref(x)
        assert torch.equal(m2.tile_scale(x), want), n
        assert torch.equal(m2.tile_scale_v0(x), want), n
    with pytest.raises(ValueError, match="aligned"):
        m2.tile_scale(torch.zeros(16384 + 1, device=cuda)[1:])
    off, planes = probe_mosaic2.dyn_slice_inputs(16384)
    terms = probe_mosaic2.slice_terms(off, planes)
    off, planes = torch.from_numpy(off).to(cuda), torch.from_numpy(
        planes).to(cuda)
    assert abs(float(m2.slice_sum(off, planes)) - terms.sum()) \
        <= 1e-5 * np.abs(terms).sum()
    x = torch.from_numpy(probe_mosaic2.accum_store_inputs(16384)).to(cuda)
    assert torch.equal(m2.tile_scale(x), m2.tile_scale_ref(x))


def test_launch_skips_the_guard_on_the_current_device(cuda):
    """On the current device the launch path enters no device guard and
    still launches (counted) on the tensor's device."""
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    x = torch.randn(16384, device=cuda)
    m2.tile_scale(x)                                  # binds the library

    def no_guard(*a, **k):
        raise AssertionError("guard entered on the current device")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device", no_guard)
        before = m2.tile_scale.launches
        got = m2.tile_scale(x)
        assert m2.tile_scale.launches == before + 1
    assert got.device == x.device
    assert torch.equal(got, m2.tile_scale_ref(x))
    assert torch.cuda.current_device() == cuda.index


def test_launch_on_a_second_card(cuda):
    """A tensor on another card than the current one launches there,
    through the device guard; skips with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    for cur, other in ((0, 1), (1, 0)):
        with torch.cuda.device(cur):
            x = torch.randn(16384, device=f"cuda:{other}")
            idx = torch.randint(0, 100, (16383,), dtype=torch.int32,
                                device=x.device)
            val = torch.arange(100, dtype=torch.int32, device=x.device)
            got = m2.tile_scale(x)
            s = m2.gather_sum(idx, val)
            assert got.device == x.device and s.device == x.device
            assert torch.equal(got, m2.tile_scale_ref(x))
            assert torch.equal(s, m2.gather_sum_ref(idx, val))
            assert torch.cuda.current_device() == cur


def test_batched_kernels_match_single_launches(cuda):
    """One launch for B frames equals B single launches and the batched
    twin, bit for bit: tier_min_d2 on the shipped supernode table's four
    crafted sets (a cloud of its own for each frame), union_find on the
    eight contract graphs."""
    tiers = tsx._TIERS_SNP
    n = DEFAULT_CONFIG.pipeline.max_obstacle_points
    cases = [(xyz + np.float32(b), *rest) for b, (_, xyz, *rest)
             in enumerate(tier_cases(tiers, n=n, seed=7))]
    batch = [torch.from_numpy(np.stack(a)).to(cuda) for a in zip(*cases)]
    before = ttm.tier_min_d2.launches
    got = ttm.tier_min_d2(*batch, tiers)
    assert ttm.tier_min_d2.launches == before + 1
    want = ttm.tier_min_d2_ref(*batch, tiers)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for b in range(len(cases)):
        one = ttm.tier_min_d2(*(a[b] for a in batch), tiers)
        assert torch.equal(got[b].view(torch.int32), one.view(torch.int32))

    graphs = [g for _, _, g in _graphs(cuda)]
    eu, ev, ne = (torch.stack(a) for a in zip(*graphs))
    before = tuf.cc_labels.launches
    got = tuf.cc_labels(eu, ev, ne, 10240)
    assert tuf.cc_labels.launches == before + 1
    assert torch.equal(got, tuf.cc_labels_ref(eu, ev, ne, 10240))
    for b, g in enumerate(graphs):
        assert torch.equal(got[b], tuf.cc_labels(*g, 10240)), b


def test_batched_step_on_card_matches_per_frame(cuda):
    """The batched step on the card: each frame (one empty, one alone
    over the supernode cap, unequal point counts) equals its own step on
    the card, leaf for leaf and payload word for word, with one
    union_find and two tier_min_d2 launches for the whole batch."""
    cfg = CFG.replace(pipeline=dataclasses.replace(CFG.pipeline,
                                                   max_supernodes=240))
    clouds = [street_scene(0, "small")[0][:2400], np.zeros((0, 3)),
              street_scene(2, "small")[0], street_scene(1, "small")[0]]
    x, m = (torch.from_numpy(np.stack(a)).to(cuda)
            for a in zip(*(pad_frame(c, CAP) for c in clouds)))
    before = (ttm.tier_min_d2.launches, tuf.cc_labels.launches)
    got = tpipe.device_frame_step_batched(x, m, cfg)
    assert (ttm.tier_min_d2.launches, tuf.cc_labels.launches) == (
        before[0] + 2, before[1] + 1)
    pay = tpipe.pack_host_payload(got, cfg)
    for b in range(len(clouds)):
        want = tpipe.device_frame_step(x[b], m[b], cfg)
        for g, w in zip(torch.utils._pytree.tree_leaves(frame_of(got, b)),
                        torch.utils._pytree.tree_leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w), b
        assert torch.equal(pay[b], device_frame_step_packed(x[b], m[b], cfg))
    assert got.clustering.overflow.tolist()[:2] == [0, 0]
    assert int(got.clustering.overflow[2]) > 0


def test_hybrid_matches_twin(cuda):
    """cc_labels_hybrid on the card (its serial stage the union_find
    kernel, launched once a call) equals cc_labels_ref, per frame and for
    a batch of the contract graphs."""
    for name, _, args in _graphs(cuda):
        before = tuf.cc_labels.launches
        got = tuf.cc_labels_hybrid(*args, 10240)
        assert tuf.cc_labels.launches == before + 1
        assert torch.equal(got.cpu(), tuf.cc_labels_ref(*args, 10240).cpu()), \
            name
    graphs = [g for _, _, g in _graphs(cuda)]
    eu, ev, ne = (torch.stack(a) for a in zip(*graphs))
    before = tuf.cc_labels.launches
    got = tuf.cc_labels_hybrid(eu, ev, ne, 10240)
    assert tuf.cc_labels.launches == before + 1
    assert torch.equal(got, tuf.cc_labels_ref(eu, ev, ne, 10240))


@pytest.mark.parametrize("seed", [0, 1])
def test_cellgraph_step_on_card_matches_cpu(cuda, seed):
    """The cellgraph backend's step on the card equals its CPU run: every
    FrameResult leaf but the planes (segmentation's f32 sums on the card),
    given the same obstacle mask to cluster, and the whole payload where
    the two segmentations agree."""
    from lidar_processing_tpu_torch.ops import clustering as tcl
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    cfg = CFG.replace(pipeline=dataclasses.replace(
        CFG.pipeline, clustering_backend="cellgraph",
        max_ambiguous_pairs=8192))
    xyz, _ = street_scene(seed, "small")
    x, m = (torch.from_numpy(a) for a in pad_frame(xyz, CAP))
    seg = gpf_segment(x.to(cuda), m.to(cuda), cfg.segmentation)
    obst = m.to(cuda) & (seg.labels == SEG_OBSTACLE)
    on_gpu = tcl.cluster(x.to(cuda), obst, cfg.clustering, cfg.pipeline)
    on_cpu = tcl.cluster(x, obst.cpu(), cfg.clustering, cfg.pipeline)
    for g, c in zip(on_gpu, on_cpu):
        assert g.dtype == c.dtype and torch.equal(g.cpu(), c)
    gpu_seg = seg.labels.cpu()
    cpu_seg = gpf_segment(x, m, cfg.segmentation).labels
    if torch.equal(gpu_seg, cpu_seg):
        pay_gpu = device_frame_step_packed(x.to(cuda), m.to(cuda), cfg).cpu()
        assert torch.equal(pay_gpu, device_frame_step_packed(x, m, cfg))


def test_cluster_spatial_on_card_matches_single_device(cuda):
    """cluster_spatial on 8 x-band shards on the card (one rank, no
    process group; the mesh's default device): its 8 bands in one batched
    stixel run (two tier_min_d2 launches, one union_find), labels equal
    to stixel.cluster on the card and to the same call on the CPU, bit
    for bit."""
    from lidar_processing_tpu_torch.config import SpatialConfig
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.parallel.mesh import make_mesh
    from lidar_processing_tpu_torch.parallel.spatial import cluster_spatial
    scfg = SpatialConfig(block_points=2048, block_clusters=512,
                         halo_points=512, block_cells=2048,
                         block_columns=1024, block_supernodes=1536,
                         block_column_pairs=4096, block_sn_pairs=4096,
                         block_live_edges=1024)
    x, m = (torch.from_numpy(a) for a in pad_frame(
        street_scene(0, "small")[0], CAP))
    obst = m & (gpf_segment(x, m, CFG.segmentation).labels == SEG_OBSTACLE)
    mesh = make_mesh(8, "space")
    assert mesh.device.type == "cuda"
    before = (ttm.tier_min_d2.launches, tuf.cc_labels.launches)
    got = cluster_spatial(mesh, x, obst, CFG.clustering, CFG.pipeline, scfg)
    assert (ttm.tier_min_d2.launches, tuf.cc_labels.launches) == (
        before[0] + 2, before[1] + 1)
    one = tsx.cluster(x.to(cuda), obst.to(cuda), CFG.clustering,
                      CFG.pipeline)
    on_cpu = cluster_spatial(make_mesh(8, "space", device="cpu"), x, obst,
                             CFG.clustering, CFG.pipeline, scfg)
    for g, w, c in zip(got, one, on_cpu):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(g.cpu(), c)
    assert int(got.overflow) == 0 and int(got.num_clusters) > 0


def test_four_nccl_ranks_equal_one_rank(cuda, tmp_path):
    """The parallel entry points over 4 NCCL ranks, one a card (needs 4
    GPUs): 8 x-band shards as 4 ranks x 2 on a small scene and on a
    full-size one, the 2 x 4 mesh as 2 data x 2 space ranks x 2 shards,
    sharded_batch_step of 4 frames, and the spatial step; every rank's
    result equal to one rank holding every shard, bit for bit."""
    from lidar_processing_tpu_torch.config import SpatialConfig
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.parallel import launch
    from lidar_processing_tpu_torch.parallel.frame_spatial import \
        device_frame_step_spatial
    from lidar_processing_tpu_torch.parallel.sharded import \
        sharded_batch_step
    from lidar_processing_tpu_torch.parallel.spatial import (
        cluster_spatial, cluster_spatial_2d)
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 GPUs: NCCL takes one rank a card")
    scfg = SpatialConfig(block_points=2048, block_clusters=512,
                         halo_points=512, block_cells=2048,
                         block_columns=1024, block_supernodes=1536,
                         block_column_pairs=4096, block_sn_pairs=4096,
                         block_live_edges=1024)
    small = CFG.replace(spatial=scfg)
    sx_, sm_ = (np.stack(a) for a in zip(*(
        pad_frame(street_scene(s, "small")[0], CAP) for s in range(4))))
    full = DEFAULT_CONFIG
    x, m = pad_frame(street_scene(0)[0], full.pipeline.max_points)
    seg = gpf_segment(torch.from_numpy(x).to(cuda),
                      torch.from_numpy(m).to(cuda), full.segmentation)
    obst = m & (seg.labels == SEG_OBSTACLE).cpu().numpy()
    cl = (full.clustering, full.pipeline, full.spatial)
    calls = [
        (cluster_spatial, {"space": 8}, (sx_[0], sm_[0], small.clustering,
                                         small.pipeline, scfg)),
        (cluster_spatial, {"space": 8}, (x, obst, *cl)),
        (cluster_spatial_2d, {"data": 2, "space": 4},
         (np.stack([x, x]), np.stack([obst, m & ~obst]), *cl)),
        (sharded_batch_step, {"data": 4}, (sx_, sm_, small)),
        (device_frame_step_spatial, {"space": 8}, (sx_[0], sm_[0], small)),
    ]
    ranks = launch.spawn(launch.run_entry_points, 4, "cuda", calls,
                         rdzv_dir=tmp_path, backend="nccl", timeout_s=600)
    want = launch.run_entry_points("cuda", calls)

    def leaves(tree):
        return ([leaf for t in tree for leaf in leaves(t)]
                if isinstance(tree, tuple) else [tree])

    for rank, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got, want)):
            gl, wl = leaves(g), leaves(w)
            assert len(gl) == len(wl)
            for a, b in zip(gl, wl):
                assert a.dtype == b.dtype and a.shape == b.shape, (rank, i)
                assert a.tobytes() == b.tobytes(), (rank, i)
    assert int(want[1][2]) == 0 and int(want[1][1]) > 300
