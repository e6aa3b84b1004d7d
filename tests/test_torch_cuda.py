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

from lidar_processing_tpu_torch.config import DEFAULT_CONFIG, SpatialConfig
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
from lidar_processing_tpu_torch.tools.kernel_cases import (slice_cases,
                                                           tier_cases,
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
    """Both pair kernels equal the twin bit for bit: on the JAX probes'
    inputs in their own layouts and on every crafted case of
    tools/kernel_cases.py::pair_cases in the three layouts; mosaic_pairs /
    mosaic3_pairs launch once a call; a misshapen or non-contiguous
    layout raises."""
    from lidar_processing_tpu_torch.kernels import probe_pairs as pp
    from lidar_processing_tpu_torch.tools import probe_mosaic, probe_mosaic3
    from lidar_processing_tpu_torch.tools.kernel_cases import (pair_cases,
                                                               pair_layouts)
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    for fn, v_cap, user, (_, rows, *runs), lanes in (
            (pp.pair_min_d2_v48, 48, lambda r, u: pp.mosaic_pairs(r, *u),
             probe_mosaic.make_inputs(), 8),
            (pp.pair_min_d2_v96, 96, lambda r, u: pp.mosaic3_pairs(*u, r),
             probe_mosaic3.make_inputs(), 128)):
        rows, runs = to(rows), [to(a) for a in runs]
        want = pp.pair_min_d2_ref(*pp.row_planes(rows, lanes), *runs, v_cap)
        before = fn.launches
        assert torch.equal(fn(rows, lanes, *runs), want)
        assert torch.equal(user(rows, runs), want)
        assert fn.launches == before + 2
        for name, xyz, *case in pair_cases(v_cap):
            case = [to(a) for a in case]
            for layout, (points, ln, planes) in pair_layouts(xyz).items():
                want = pp.pair_min_d2_ref(*to(planes), *case, v_cap)
                got = fn(to(points), ln, *case)
                assert torch.equal(got, want), (v_cap, name, layout)
        for bad in (rows[:, :-1], rows.T.contiguous(), rows[:, ::2],
                    rows.reshape(-1)):
            with pytest.raises(ValueError):
                fn(bad, lanes, *runs)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.cat([rows, rows], 1)[:, ::2], lanes, *runs)


def test_mosaic2_kernels_match_twins(cuda):
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    from lidar_processing_tpu_torch.tools import probe_mosaic2
    idx, val = (torch.from_numpy(a).to(cuda)
                for a in probe_mosaic2.scalar_loads_inputs(16384))
    # the probe's size, and ragged ones: n % 4 != 0 for the int4 loop
    for n in (16384, 16383, 16381, 3, 0):
        i_n = idx[:n].clone()
        want = m2.gather_sum_ref(i_n, val)
        before = m2.gather_sum.launches
        for got in (m2.gather_sum(i_n, val), m2.gather_sum(i_n, val, "atomic")):
            assert got.shape == (1, 1) and torch.equal(got, want), n
        assert m2.gather_sum.launches == before + 2
    with pytest.raises(ValueError, match="aligned"):
        m2.gather_sum(idx[1:], val)
    # a non-multiple of 1024 elements: the last block partly idle
    for n in (16384, 16384 + 128, 128):
        x = torch.randn(n, device=cuda)
        want = m2.tile_scale_ref(x)
        assert torch.equal(m2.tile_scale(x), want), n
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


def test_slice_sum_kernel(cuda):
    """slice_sum on the card: within 1e-5 of the sum of |terms| of the twin
    and bit for bit the order model (tools/probe_mosaic2.py) for the grid
    the wrapper reports for each n (a warp a term, up to 2 blocks an SM),
    at n in {16384, 16383, 1, 0} x W in {384, 383,
    1} x R in {2, 640}, offsets clamped from below 0 and past R - 2; the
    same bits on 3 calls and on two streams, each with its own workspace;
    a misaligned planes view raises; one launch and one CUDA kernel a
    call."""
    from lidar_processing_tpu_torch.kernels import probe_mosaic2 as m2
    from lidar_processing_tpu_torch.tools import kernel_bench
    from lidar_processing_tpu_torch.tools import probe_mosaic2 as pm2
    most = m2.SLICE_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    assert [m2.slice_sum_grid(cuda, n) for n in (0, 1, 8, 9, 1024, 16384)] \
        == [1, 1, 1, 2, 128, most]
    for case, off, planes in slice_cases():
        grid = m2.slice_sum_grid(cuda, off.shape[0])
        rows = planes.shape[0]
        t_off, t_pl = (torch.from_numpy(a).to(cuda) for a in (off, planes))
        before = m2.slice_sum.launches
        got = [m2.slice_sum(t_off, t_pl) for _ in range(3)]
        assert m2.slice_sum.launches == before + 3
        bits = {g.cpu().numpy().tobytes() for g in got}
        assert len(bits) == 1, case
        assert got[0].shape == (1, 1) and got[0].dtype == torch.float32
        model = pm2.slice_sum_order_model(off, planes, grid)
        assert bits == {model.tobytes()}, case
        terms = pm2.slice_terms(np.clip(off, 0, rows - 2), planes)
        twin = float(m2.slice_sum_ref(t_off, t_pl))
        assert abs(float(got[0]) - twin) <= 1e-5 * np.abs(terms).sum(), case
        if off.size == 0:
            assert float(got[0]) == 0.0
    off, planes = (torch.from_numpy(a).to(cuda)
                   for a in pm2.dyn_slice_inputs(16384))
    want = m2.slice_sum(off, planes)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            outs.append(m2.slice_sum(off, planes))
    torch.cuda.synchronize(cuda)
    spaces = [m2._SLICE_WORKSPACES[(cuda.index, st.cuda_stream)]
              for st in streams]
    assert spaces[0].data_ptr() != spaces[1].data_ptr()
    for out in outs:
        assert torch.equal(out, want)
    flat = torch.zeros(640 * 384 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        m2.slice_sum(off, flat[1:].view(640, 384))
    with pytest.raises(ValueError):
        m2.slice_sum(off, planes[:1])
    seen = kernel_bench.kernels_per_call(lambda: m2.slice_sum(off, planes))
    assert list(seen.values()) == [1.0], seen


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


SCFG = SpatialConfig(block_points=2048, block_clusters=512,
                     halo_points=512, block_cells=2048, block_columns=1024,
                     block_supernodes=1536, block_column_pairs=4096,
                     block_sn_pairs=4096, block_live_edges=1024)


def test_cluster_spatial_on_card_matches_single_device(cuda):
    """cluster_spatial on 8 x-band shards on the card (one rank, no
    process group; the mesh's default device), on its graph: its 8 bands
    in one batched stixel run, the wrappers' launches those of the
    warm-up steps and the capture (two tier_min_d2, one union_find each)
    and none from a replay, labels equal to stixel.cluster on the card
    and to the same call on the CPU, bit for bit."""
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.parallel.mesh import make_mesh
    from lidar_processing_tpu_torch.parallel.spatial import cluster_spatial
    from lidar_processing_tpu_torch.runtime import compiled
    scfg = SCFG
    x, m = (torch.from_numpy(a) for a in pad_frame(
        street_scene(0, "small")[0], CAP))
    obst = m & (gpf_segment(x, m, CFG.segmentation).labels == SEG_OBSTACLE)
    mesh = make_mesh(8, "space")
    assert mesh.device.type == "cuda"
    compiled.release_graphs()
    before = (ttm.tier_min_d2.launches, tuf.cc_labels.launches)
    got = cluster_spatial(mesh, x, obst, CFG.clustering, CFG.pipeline, scfg)
    calls = compiled.WARMUP_STEPS + 1
    assert (ttm.tier_min_d2.launches, tuf.cc_labels.launches) == (
        before[0] + 2 * calls, before[1] + calls)
    cluster_spatial(mesh, x, obst, CFG.clustering, CFG.pipeline, scfg)
    assert (ttm.tier_min_d2.launches, tuf.cc_labels.launches) == (
        before[0] + 2 * calls, before[1] + calls)
    one = tsx.cluster(x.to(cuda), obst.to(cuda), CFG.clustering,
                      CFG.pipeline)
    on_cpu = cluster_spatial(make_mesh(8, "space", device="cpu"), x, obst,
                             CFG.clustering, CFG.pipeline, scfg)
    for g, w, c in zip(got, one, on_cpu):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(g.cpu(), c)
    assert int(got.overflow) == 0 and int(got.num_clusters) > 0
    compiled.release_graphs()


def test_four_nccl_ranks_equal_one_rank(cuda, tmp_path):
    """The parallel entry points over 4 NCCL ranks, one a card (needs 4
    GPUs), each on its captured graph with the P2P shift and the
    all_gathers inside: 8 x-band shards as 4 ranks x 2 on a small scene
    and on a full-size one, the 2 x 4 mesh as 2 data x 2 space ranks x 2
    shards, sharded_batch_step of 4 frames, and the spatial step, each
    called twice (capture, then a replay); every rank's results, read
    after the second call, equal to one rank holding every shard, bit
    for bit."""
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
    scfg = SCFG
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
    runs = launch.spawn(launch.run_on_graphs, 4, "cuda", calls, 2,
                        rdzv_dir=tmp_path, backend="nccl", timeout_s=600)
    want = [r for r in launch.run_entry_points("cuda", calls)
            for _ in range(2)]
    ranks = [got for got, _ in runs]
    for rank, (_, graphs) in enumerate(runs):
        print(f"rank {rank} graphs: {graphs}")
        assert sorted(g["name"] for g in graphs) == [
            "cluster_spatial 8", "cluster_spatial 8", "cluster_spatial_2d 2x4",
            "device_frame_step_spatial 8", "sharded_batch_step 4"], graphs
        for g in graphs:
            assert (g["tier_min_d2"], g["union_find"]) == (2, 1), g
            assert g["nccl"] >= 1 and g["replays"] == 2, g

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
    assert all(len(got) == len(want) for got in ranks)
    assert int(want[2][2]) == 0 and int(want[2][1]) > 300


def _step_and_payload(xyzs, masks, cfg):
    fr = tpipe.device_frame_step_batched(xyzs, masks, cfg)
    return fr, tpipe.pack_host_payload(fr, cfg)


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("batch", [1, 4])
def test_compiled_step_equals_eager_step(cuda, batch):
    """A CompiledStep replay (the step captured as one CUDA graph) equals
    the eager step bit for bit, every FrameResult leaf and payload word,
    at B = 1 and 4; the graph holds two tier_min_d2_kernel nodes and one
    union_find_kernel node, each replay runs them (torch.profiler) and
    launches nothing from Python."""
    from lidar_processing_tpu_torch.runtime.compiled import CompiledStep
    from lidar_processing_tpu_torch.tools.kernel_bench import (kernel_counts,
                                                               launches_of)
    clouds = [street_scene(s, "small")[0] for s in range(4)]
    x, m = (torch.from_numpy(np.stack(a)).to(cuda)
            for a in zip(*(pad_frame(c, CAP) for c in clouds)))
    step = CompiledStep(_step_and_payload, CFG, batch, cuda)
    assert (step.kernel_nodes("tier_min_d2_kernel"),
            step.kernel_nodes("union_find_kernel"),
            step.kernel_nodes("min_d2_kernel")) == (2, 1, 0)
    for lo in range(0, len(clouds), batch):
        before = (ttm.tier_min_d2.launches, tuf.cc_labels.launches)
        got, ran = kernel_counts(
            lambda: step(x[lo:lo + batch], m[lo:lo + batch]))
        assert (ttm.tier_min_d2.launches, tuf.cc_labels.launches) == before
        assert (launches_of(ran, "tier_min_d2_kernel"),
                launches_of(ran, "union_find_kernel")) == (2, 1)
        want = _step_and_payload(x[lo:lo + batch], m[lo:lo + batch], CFG)
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert _same_bits(g, w), lo


def test_replay_stream_on_graphs_equals_eager(cuda, tmp_path):
    """ReplayStream's compiled route (the default on the card) yields the
    eager route's outputs frame for frame over 3 frames."""
    from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream
    for seed in (0, 1):
        write_pcd_xyzi(tmp_path / f"{seed:06d}.pcd",
                       *street_scene(seed, "small"))
    graph = ReplayStream(CFG, data_dir=str(tmp_path), device=cuda)
    eager = ReplayStream(CFG, data_dir=str(tmp_path), device=cuda,
                         eager=True)
    got, want = list(graph.run(3)), list(eager.run(3))
    assert graph.graph is not None and eager.graph is None
    for (go, gm), (wo, wm) in zip(got, want):
        assert gm.frame_id == wm.frame_id
        for field in ("seg_labels", "cluster_labels", "num_clusters",
                      "overflow", "outline_cluster_ids",
                      "outline_z_extents"):
            assert np.array_equal(getattr(go, field), getattr(wo, field))
        assert len(go.outlines) == len(wo.outlines)
        assert all(np.array_equal(a, b)
                   for a, b in zip(go.outlines, wo.outlines))


def test_a_syncing_step_raises_at_capture(cuda):
    """A step that waits on the card (a test double calling .item()) runs
    eagerly but raises at capture, with CUDA's capture error; the card
    still runs the eager step afterwards."""
    from lidar_processing_tpu_torch.runtime.compiled import CompiledStep

    def syncing(xyzs, masks, cfg):
        out = tpipe.device_frame_step_packed_batched(xyzs, masks, cfg)
        out[0, 0].item()
        return out
    with pytest.raises(Exception, match="captur"):
        CompiledStep(syncing, CFG, 1, cuda)
    x, m = (torch.from_numpy(a).to(cuda) for a in pad_frame(
        street_scene(0, "small")[0], CAP))
    assert torch.equal(device_frame_step_packed(x, m, CFG).cpu(),
                       device_frame_step_packed(x.cpu(), m.cpu(), CFG))


@pytest.fixture(scope="module")
def nccl_rank():
    """One NCCL rank (world size 1) at a free localhost port for the
    parallel graph tests below (the last of this module); every
    registered graph is released before the group is destroyed."""
    import socket
    import torch.distributed as dist
    from lidar_processing_tpu_torch.runtime import compiled
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL runs on cards")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    yield dist.get_backend()
    compiled.release_graphs()
    dist.destroy_process_group()


def _graph_of(program: str):
    """The one registered graph of the parallel entry point `program`."""
    from lidar_processing_tpu_torch.parallel.mesh import program_name
    from lidar_processing_tpu_torch.runtime import compiled
    found = [step for key, step in compiled.programs().items()
             if program_name(key).split()[0] == program]
    assert len(found) == 1, (program, list(compiled.programs()))
    return found[0]


def _parallel_cases(cuda):
    """{case: (entry point's program, public call, eager body's result
    as the public call returns it, clusters)} on 8 small scenes."""
    import math
    from lidar_processing_tpu_torch.ops.segmentation import gpf_segment
    from lidar_processing_tpu_torch.parallel import frame_spatial as fs
    from lidar_processing_tpu_torch.parallel import sharded as sh
    from lidar_processing_tpu_torch.parallel import spatial as sp
    from lidar_processing_tpu_torch.parallel.mesh import (make_mesh,
                                                          make_mesh_2d)
    from lidar_processing_tpu_torch.types import ClusteringResult
    xs, ms = (torch.from_numpy(np.stack(a)).to(cuda) for a in zip(*(
        pad_frame(street_scene(s, "small")[0], CAP) for s in range(8))))
    obst = ms & (gpf_segment(xs, ms, CFG.segmentation).labels
                 == SEG_OBSTACLE)
    cfg = CFG.replace(spatial=SCFG)
    cl = (cfg.clustering, cfg.pipeline, cfg.spatial)
    r = math.sqrt(cfg.clustering.distance_squared)
    m2d = make_mesh_2d(2, 4)

    def one(out):
        return ClusteringResult(*(t[0] for t in out))
    cases = {f"cluster_spatial {s}": (
        "cluster_spatial",
        lambda s=s: sp.cluster_spatial(make_mesh(s, "space"), xs[0],
                                       obst[0], *cl),
        lambda s=s: one(sp._cluster_bands(make_mesh(s, "space"), "space",
                                          xs[:1], obst[:1], *cl)), True)
        for s in (8, 4)}
    cases.update({
        "cluster_spatial_2d": (
            "cluster_spatial_2d",
            lambda: sp.cluster_spatial_2d(m2d, xs[:2], obst[:2], *cl),
            lambda: ClusteringResult(*sp._spatial_2d_program(
                m2d, ("data", "space"), xs[:2], obst[:2], cl)), True),
        "gpf_spatial": (
            "gpf_spatial",
            lambda: fs.gpf_spatial(make_mesh(8, "space"), xs[0], ms[0],
                                   cfg.segmentation, cfg.spatial, r),
            lambda: fs._gpf_bands(make_mesh(8, "space"), xs[0], ms[0],
                                  cfg.segmentation, cfg.spatial, r,
                                  "space"), False),
        "device_frame_step_spatial": (
            "device_frame_step_spatial",
            lambda: fs.device_frame_step_spatial(make_mesh(8, "space"),
                                                 xs[0], ms[0], cfg),
            lambda: fs._step_spatial(make_mesh(8, "space"), xs[0], ms[0],
                                     cfg, "space"), True),
        "sharded_batch_step": (
            "sharded_batch_step",
            lambda: sh.sharded_batch_step(make_mesh(8, "data"), xs, ms, cfg),
            lambda: sh._batch_step(make_mesh(8, "data"), xs, ms, cfg), True),
        "sharded_pipeline_2d": (
            "sharded_pipeline_2d",
            lambda: sh.sharded_pipeline_2d(m2d, xs[:2], ms[:2], cfg),
            lambda: sh._pipeline_2d(m2d, xs[:2], ms[:2], cfg), True)})
    return cases


PARALLEL_CASES = ("cluster_spatial 8", "cluster_spatial 4",
                  "cluster_spatial_2d", "gpf_spatial",
                  "device_frame_step_spatial", "sharded_batch_step",
                  "sharded_pipeline_2d")


@pytest.mark.parametrize("case", PARALLEL_CASES)
def test_parallel_graph_equals_eager_body(cuda, nccl_rank, case):
    """Each public entry point of the parallel path on one NCCL rank runs
    its captured graph (equal meshes built anew share it): the first
    call's result and a second call's (a replay, which launches nothing
    from Python and leaves the first call's tensors as they were) equal
    the eager body's bit for bit; a graph that clusters holds
    {tier_min_d2_kernel: 2, union_find_kernel: 1} kernel nodes,
    gpf_spatial's none of them; released, it is captured again."""
    from lidar_processing_tpu_torch.runtime import compiled
    leaves = torch.utils._pytree.tree_leaves
    assert nccl_rank == "nccl"
    program, call, eager, clusters = _parallel_cases(cuda)[case]
    compiled.release_graphs()
    live = compiled.live_graphs()
    first = call()
    saved = [t.clone() for t in leaves(first)]
    assert compiled.live_graphs() == live + 1
    counts = (ttm.tier_min_d2.launches, tuf.cc_labels.launches)
    second = call()
    assert (ttm.tier_min_d2.launches, tuf.cc_labels.launches) == counts
    graph = _graph_of(program)
    assert graph.replays == 2
    want = leaves(eager())
    for got in (leaves(first), saved, leaves(second)):
        assert len(got) == len(want)
        assert all(_same_bits(g, w) for g, w in zip(got, want)), case
    nodes = (graph.kernel_nodes("tier_min_d2_kernel"),
             graph.kernel_nodes("union_find_kernel"))
    assert nodes == ((2, 1) if clusters else (0, 0)), nodes
    assert compiled.release_graphs() == 1
    assert compiled.live_graphs() == live
    assert all(_same_bits(g, w) for g, w in zip(leaves(call()), want))
    assert _graph_of(program).replays == 1
    compiled.release_graphs()


def test_stage_graphs_equal_eager_stages(cuda, tmp_path):
    """The stage-timed replay on the card replays two B = 1 graphs,
    segment_stage and cluster_stage: on frames 0 and 1 each equals its
    eager stage bit for bit (the clustering graph fed the segmentation
    graph's obstacle mask), the clustering graph holds
    {tier_min_d2_kernel: 2, union_find_kernel: 1} kernel nodes and the
    segmentation graph none; the stage-timed run yields the eager route's
    outputs and sets every stage time."""
    from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
    from lidar_processing_tpu_torch.runtime.stream import (ReplayStream,
                                                           cluster_stage,
                                                           segment_stage)
    from lidar_processing_tpu_torch.types import map_leaves
    leaves = torch.utils._pytree.tree_leaves
    for seed in (0, 1):
        write_pcd_xyzi(tmp_path / f"{seed:06d}.pcd",
                       *street_scene(seed, "small"))
    graph = ReplayStream(CFG, data_dir=str(tmp_path), device=cuda)
    eager = ReplayStream(CFG, data_dir=str(tmp_path), device=cuda,
                         eager=True)
    got = list(graph.run(2, stage_timing=True))
    want = list(eager.run(2, stage_timing=True))
    assert len(graph.stage_graphs) == 2 and eager.stage_graphs == ()
    seg_graph, cl_graph = graph.stage_graphs
    for f in (0, 1):
        x, m = graph.xyz[f:f + 1], graph.mask[f:f + 1]
        seg = map_leaves(torch.clone, seg_graph(x, m))
        seg_want = segment_stage(x, m, CFG)
        assert all(_same_bits(g, w) for g, w in zip(leaves(seg),
                                                    leaves(seg_want)))
        cl = cl_graph(x, seg[1])
        cl_want = cluster_stage(x, seg_want[1], CFG)
        assert all(_same_bits(g, w) for g, w in zip(leaves(cl),
                                                    leaves(cl_want)))
    assert [(g.kernel_nodes("tier_min_d2_kernel"),
             g.kernel_nodes("union_find_kernel"))
            for g in (seg_graph, cl_graph)] == [(0, 0), (2, 1)]
    for (go, gm), (wo, wm) in zip(got, want):
        assert gm.frame_id == wm.frame_id
        assert np.array_equal(go.cluster_labels, wo.cluster_labels)
        assert None not in (gm.t_seg_ms, gm.t_cluster_ms, gm.t_hull_ms)
    graph.release()
    assert graph.stage_graphs == () and graph.graph is None


def _small_frames(path):
    from lidar_processing_tpu_torch.io.pcd import write_pcd_xyzi
    for seed in (0, 1):
        write_pcd_xyzi(path / f"{seed:06d}.pcd", *street_scene(seed, "small"))
    return str(path)


def test_stamps_split_an_event_timed_replay(cuda):
    """The stamped step's graph holds five globaltimer_stamp_kernel nodes;
    on each of 20 replays every stage takes some time, and the stages
    sum to within 5% of CUDA events around the replay (median); the
    payload is the packed step's, and the counters the eager step's."""
    from lidar_processing_tpu_torch.runtime.compiled import CompiledStep
    x, m = (torch.from_numpy(a).to(cuda)[None] for a in pad_frame(
        street_scene(0, "small")[0], CAP))
    step = CompiledStep(tpipe.device_frame_step_stamped_batched, CFG, 1,
                        cuda)
    assert step.kernel_nodes("globaltimer_stamp_kernel") == 5
    stages = len(tpipe.STAGES)
    ratios = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        payload, stats = step(x, m)
        end.record()
        end.synchronize()
        stamps = stats[0, :stages + 1].tolist()
        assert all(b > a for a, b in zip(stamps, stamps[1:])), stamps
        ratios.append((stamps[-1] - stamps[0]) * 1e-6
                      / start.elapsed_time(end))
    assert abs(sorted(ratios)[10] - 1.0) <= 0.05, ratios
    _, want_stats = tpipe.device_frame_step_stamped_batched(x, m, CFG)
    assert torch.equal(payload,
                       tpipe.device_frame_step_packed_batched(x, m, CFG))
    assert torch.equal(stats[:, stages + 1:], want_stats[:, stages + 1:])
    step.release()


def test_stamps_map_causally_onto_the_host_clock(cuda, tmp_path):
    """Over 200 frames back to back, mapped onto the host clock within the
    stated calibration error (and 20 µs of drift): the first stamp comes
    after the dispatch began and the last before the wait on the payload
    ended on at least 99% of the frames, and every frame's spans tile
    publication to outputs within 0.5 ms, its four stages running on to
    the hold (test_torch_trace.py::check_chain)."""
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream
    from test_torch_trace import causal, check_chain
    stream = ReplayStream(CFG, data_dir=_small_frames(tmp_path), device=cuda)
    metrics = [m for _, m in stream.run(200)]
    err = stream.clock_error_ns * 1e-9
    assert err < 50e-6
    for m in metrics:
        check_chain(m)
    assert sum(causal(m, err + 20e-6) for m in metrics) >= 0.99 * 200
    stream.release()


def test_realtime_frames_are_consumed_before_the_next_publication(
        cuda, tmp_path):
    """Paced at 10 Hz over 20 frames on the compiled step: every frame is
    consumed while the next publication is not yet due, its outputs land
    before it, its hold is empty (the host waits on the device from the
    dispatch's return), and its spans tile publication to outputs."""
    from lidar_processing_tpu_torch.runtime import spans as tspans
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream
    from test_torch_trace import causal, check_chain
    cfg = CFG.replace(pipeline=dataclasses.replace(CFG.pipeline,
                                                   replay_rate_hz=10.0))
    stream = ReplayStream(cfg, data_dir=_small_frames(tmp_path), device=cuda)
    metrics = [m for _, m in stream.run(20, realtime=True)]
    err = stream.clock_error_ns * 1e-9
    for m in metrics:
        check_chain(m)
        assert causal(m, err + 20e-6)
        assert m.consumed_early and m.frames_dropped == 0
        assert m.spans[-1][2] < m.t_published + 0.1
        assert tspans.total_ms(m.spans, "stream.hold") < 1.0
    stream.release()


def test_profiler_spans_keep_the_host_clock(cuda, tmp_path):
    """A span's record_function event in torch.profiler's trace and its
    time.perf_counter start differ by one constant, within 50 µs, over a
    profiled replay of 30 frames."""
    import json
    from lidar_processing_tpu_torch.runtime.stream import ReplayStream
    stream = ReplayStream(CFG, data_dir=_small_frames(tmp_path), device=cuda)
    stream.warmup()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        metrics = [m for _, m in stream.run(30)]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted(float(e["ts"]) for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("name") == "host.chi_hulls"
        and e.get("ph") == "X")
    starts = [s for m in metrics for n, s, _ in m.spans
              if n == "host.chi_hulls"]
    assert len(events) == len(starts) == 30
    offsets = [ts - s * 1e6 for ts, s in zip(events, sorted(starts))]
    assert max(offsets) - min(offsets) <= 50.0, offsets
    stream.release()
