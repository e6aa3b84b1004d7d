"""PyTorch port: the probe kernels' twins against the JAX probes in tools/.

Each tools/probe_*.py is loaded by file path and its Pallas kernel body is
run in interpret mode (the call built inside
``pltpu.force_tpu_interpret_mode()``) on the port's copy of the probe's
seeded numpy inputs, at small sizes. On CPU tensors the port's wrappers
run their plain twins (a CUDA tensor would launch csrc/probe_*.cu;
tests/test_torch_cuda.py holds those against the twins on the card).

Tolerances: union-find labels equal (the labelling is canonical); pair
minima within 4 ULP of the Pallas kernels in interpret mode
(tests/test_kernels.py's criterion for min_d2), and the port's trimmed
window, its layouts and its twin equal bit for bit;
mosaic2 A and C equal, B within 1e-5 of the sum of |terms| (f32 sums
taken in another order), and so is the numpy model of the B kernel's own
order (which the card tests hold the kernel to bit for bit).
"""

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lidar_processing_tpu_torch.kernels import probe_mosaic2 as tm2
from lidar_processing_tpu_torch.kernels import probe_pairs as tpp
from lidar_processing_tpu_torch.kernels import probe_uf as tpu_uf
from lidar_processing_tpu_torch.kernels.union_find import (cc_labels,
                                                           cc_labels_ref)
from lidar_processing_tpu_torch.tools import kernel_cases
from lidar_processing_tpu_torch.tools import probe_mosaic as tmos
from lidar_processing_tpu_torch.tools import probe_mosaic2 as tmos2
from lidar_processing_tpu_torch.tools import probe_mosaic3 as tmos3
from lidar_processing_tpu_torch.tools import probe_uf as tprobe_uf
from lidar_processing_tpu_torch.tools import probe_uf2 as tprobe_uf2
from lidar_processing_tpu_torch.tools.kernel_cases import uf_graphs, uf_oracle

_TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def _load_probe(name):
    """Import tools/<name>.py by path; its module top points jax's
    compilation cache elsewhere, so the settings are restored after."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  _TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def _smem_call(kernel, s, n_in):
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((s,), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * n_in,
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM))


# ---- union-find: tools/probe_uf.py, tools/probe_uf2.py ------------------

S_SMALL, E_SMALL, NE_SMALL = 512, 1024, 300


def test_probe_uf_twin_matches_pallas_interpret(monkeypatch):
    jprobe = _load_probe("probe_uf")
    monkeypatch.setattr(jprobe, "S", S_SMALL)   # the kernel's label count
    eu, ev, ne = tprobe_uf.make_inputs(S_SMALL, E_SMALL, NE_SMALL)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_smem_call(jprobe.kernel, S_SMALL, 3)(
            jnp.asarray(eu), jnp.asarray(ev), jnp.asarray([ne], jnp.int32)))
    got = tpu_uf.uf_probe(torch.from_numpy(eu), torch.from_numpy(ev),
                          torch.tensor(ne, dtype=torch.int32), S_SMALL)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, tprobe_uf.scipy_labels(eu, ev, ne, S_SMALL))
    for model in (tpu_uf.schedule_model, tpu_uf.serial_model):
        np.testing.assert_array_equal(
            model(eu, ev, ne, S_SMALL, *tpu_uf.VARIANTS["uf_probe"])[0],
            want)


@pytest.mark.parametrize("variant", ["k_v0", "k_v1", "k_v2"])
def test_probe_uf2_variants_match_pallas_interpret(variant):
    jprobe = _load_probe("probe_uf2")
    eu, ev, ne = tprobe_uf2.make_inputs(S_SMALL, E_SMALL, NE_SMALL)
    teu, tev = torch.from_numpy(eu), torch.from_numpy(ev)
    tne = torch.tensor(ne, dtype=torch.int32)
    euv = tpu_uf.pack_edges(teu, tev)
    np.testing.assert_array_equal(   # the JAX probe's packing
        euv.numpy(), (eu.astype(np.int64) << 15 | ev).astype(np.int32))
    nej = jnp.asarray([ne], jnp.int32)
    args = ((jnp.asarray(eu), jnp.asarray(ev), nej) if variant == "k_v0"
            else (jnp.asarray(euv.numpy()), nej))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jprobe.run(getattr(jprobe, variant), args,
                                     s=S_SMALL))
    got = {"k_v0": lambda: tpu_uf.uf_serial(teu, tev, tne, S_SMALL),
           "k_v1": lambda: tpu_uf.uf_packed(euv, tne, S_SMALL),
           "k_v2": lambda: tpu_uf.uf_packed_noskip(euv, tne, S_SMALL)
           }[variant]()
    np.testing.assert_array_equal(got.numpy(), want)
    name = {"k_v0": "uf_serial", "k_v1": "uf_packed",
            "k_v2": "uf_packed_noskip"}[variant]
    a, b = (eu, ev) if variant == "k_v0" else (
        t.numpy() for t in tpu_uf.unpack_edges(euv))
    for model in (tpu_uf.schedule_model, tpu_uf.serial_model):
        np.testing.assert_array_equal(
            model(a, b, ne, S_SMALL, *tpu_uf.VARIANTS[name])[0], want)


def test_probe_uf2_main_takes_a_frame_edge_list():
    """main(edges=...) runs the given (e_u, e_v, n_edges) — here the JAX
    probe's fallback graph, packed and unpacked — and every variant
    agrees with scipy."""
    eu, ev, ne = tprobe_uf2.make_inputs(S_SMALL, E_SMALL, NE_SMALL, seed=3)
    out = tprobe_uf2.main(device="cpu", edges=(eu, ev, ne), s=S_SMALL,
                          reps=1)
    assert out["edges"] == ne and set(out["ms"]) == {"v0", "v1", "v2"}
    np.testing.assert_array_equal(
        out["labels"], tprobe_uf.scipy_labels(eu, ev, ne, S_SMALL))
    a, b = tpu_uf.unpack_edges(tpu_uf.pack_edges(torch.from_numpy(eu),
                                                 torch.from_numpy(ev)))
    np.testing.assert_array_equal(a.numpy(), eu)
    np.testing.assert_array_equal(b.numpy(), ev)


def test_probe_uf_main_checks_against_scipy():
    out = tprobe_uf.main(device="cpu", s=S_SMALL, e=E_SMALL, ne=NE_SMALL,
                         reps=1)
    assert out["correct"] and out["labels"].shape == (S_SMALL,)


def test_uf_wrappers_on_cpu_run_the_twin_without_counting():
    eu, ev, ne = tprobe_uf.make_inputs(S_SMALL, E_SMALL, NE_SMALL, seed=5)
    teu, tev = torch.from_numpy(eu), torch.from_numpy(ev)
    tne = torch.tensor(ne, dtype=torch.int32)
    euv = tpu_uf.pack_edges(teu, tev)
    want = cc_labels(teu, tev, tne, S_SMALL).numpy()
    wrappers = (tpu_uf.uf_probe, tpu_uf.uf_serial, tpu_uf.uf_packed,
                tpu_uf.uf_packed_noskip)
    counts = [w.launches for w in wrappers]
    for got in (tpu_uf.uf_probe(teu, tev, tne, S_SMALL),
                tpu_uf.uf_serial(teu, tev, tne, S_SMALL),
                tpu_uf.uf_packed(euv, tne, S_SMALL),
                tpu_uf.uf_packed_noskip(euv, tne, S_SMALL)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert counts == [w.launches for w in wrappers]


def _variant_edges(name, eu, ev):
    """A variant's edges as its kernel reads them: the packed variants
    through pack_edges / unpack_edges (ids past 2^15 change)."""
    if not name.startswith("uf_packed"):
        return eu, ev
    a, b = tpu_uf.unpack_edges(tpu_uf.pack_edges(torch.from_numpy(eu),
                                                 torch.from_numpy(ev)))
    return a.numpy(), b.numpy()


@pytest.mark.parametrize("name", list(tpu_uf.VARIANTS))
def test_schedule_model_matches_twin_and_oracle_on_contract_graphs(name):
    """The staged kernel's schedule (windows screened at their start,
    lane 0's in-order unions, finds from prefetched parents) and the
    serial pass give the contract's labels on every crafted graph,
    equal to cc_labels_ref and to scipy."""
    s_cap = 512
    for graph, eu, ev, ne in uf_graphs(s_cap, 2048):
        a, b = _variant_edges(name, eu, ev)
        want = uf_oracle(a, b, ne, s_cap)
        twin = cc_labels_ref(torch.from_numpy(a), torch.from_numpy(b),
                             torch.tensor(ne, dtype=torch.int32), s_cap)
        np.testing.assert_array_equal(twin.numpy(), want, err_msg=graph)
        for model in (tpu_uf.schedule_model, tpu_uf.serial_model):
            got = model(a, b, ne, s_cap, *tpu_uf.VARIANTS[name])[0]
            np.testing.assert_array_equal(got, want, err_msg=graph)


@pytest.mark.parametrize("name", ["uf_serial", "uf_packed"])
def test_screened_edges_are_ones_the_serial_pass_skips_or_finds_joined(name):
    """Every edge the window screen takes off lane 0 is one the serial
    variant skips or finds already joined, on the contract graphs and the
    two probes' graphs (small); the screen does take edges off."""
    graphs = uf_graphs(512, 2048) + [
        ("probe_uf", *tprobe_uf.make_inputs(S_SMALL, E_SMALL, NE_SMALL)),
        ("probe_uf2", *tprobe_uf2.make_inputs(S_SMALL, E_SMALL, NE_SMALL))]
    total = 0
    for graph, eu, ev, ne in graphs:
        a, b = _variant_edges(name, eu, ev)
        _, screened = tpu_uf.schedule_model(a, b, ne, 512,
                                            *tpu_uf.VARIANTS[name])
        _, outcome = tpu_uf.serial_model(a, b, ne, 512,
                                         *tpu_uf.VARIANTS[name])
        bad = [j for j in screened if outcome[j] == "hooked"]
        assert not bad, (graph, bad[:5])
        total += len(screened)
    assert total > 0


def test_entries_bind_every_entry_point_of_probe_uf_cu():
    """kernels/_build.py binds each extern "C" function of csrc/probe_uf.cu
    with as many arguments as the source declares."""
    from lidar_processing_tpu_torch.kernels import _build
    src = (_build.CSRC / "probe_uf.cu").read_text()
    decls = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert len(decls) == 4
    entries = dict(_build._ENTRIES)
    for name, params in decls:
        assert name in entries, name
        assert len(entries[name]) == len(params.split(",")), name
    assert {n for n, _ in decls} == {f"{v}_launch" for v in tpu_uf.VARIANTS}


def test_staged_wrappers_reject_a_misaligned_edge_view():
    """An edge view off by 4 bytes raises before any launch (a bulk copy
    needs a 16-byte aligned source), whatever the other array."""
    e = torch.zeros(1025, dtype=torch.int32)
    ne = torch.tensor(1000, dtype=torch.int32)
    before = tpu_uf.uf_serial.launches
    for edges in ((("eu", e[1:]), ("ev", e[:1024])),
                  (("eu", e[:1024]), ("ev", e[1:])), (("euv", e[1:]),)):
        with pytest.raises(ValueError, match="16-byte"):
            tpu_uf._staged(tpu_uf.uf_serial, "uf_serial_launch", edges, ne,
                           64)
    assert tpu_uf.uf_serial.launches == before


# ---- pair minima: tools/probe_mosaic.py, tools/probe_mosaic3.py ---------

def test_probe_mosaic_twin_matches_pallas_interpret():
    jprobe = _load_probe("probe_mosaic")
    xyz, stacked, us, uc, vs, vc = tmos.make_inputs(n=1024, n_pairs=160)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            jprobe.kernel,
            out_shape=jax.ShapeDtypeStruct((len(us),), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))
        want = np.asarray(call(*map(jnp.asarray, (stacked, us, uc, vs, vc))))
    got = tpp.mosaic_pairs(*map(torch.from_numpy,
                                (stacked, us, uc, vs, vc))).numpy()
    assert got.shape == (len(us),) and got.dtype == np.float32
    assert _ulp(got, want) <= 4
    np.testing.assert_allclose(got, tmos.numpy_min_d2(xyz, us, uc, vs, vc),
                               rtol=1e-5)


def test_probe_mosaic3_twin_matches_pallas_interpret(monkeypatch):
    jprobe = _load_probe("probe_mosaic3")
    blk = 32                      # pairs per grid step (the probe's 1024)
    monkeypatch.setattr(jprobe, "BLK", blk)
    xyz, planes, us, uc, vs, vc = tmos3.make_inputs(n=2048, n_pairs=4 * blk)
    sspec = lambda: pl.BlockSpec((blk,), lambda i: (i,),  # noqa: E731
                                 memory_space=pltpu.SMEM)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            jprobe.kernel, grid=(len(us) // blk,),
            out_shape=jax.ShapeDtypeStruct((len(us),), jnp.float32),
            in_specs=[sspec(), sspec(), sspec(), sspec(),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((blk,), lambda i: (i,),
                                   memory_space=pltpu.SMEM))
        want = np.asarray(call(*map(jnp.asarray, (us, uc, vs, vc, planes))))
    got = tpp.mosaic3_pairs(*map(torch.from_numpy,
                                 (us, uc, vs, vc, planes))).numpy()
    assert _ulp(got, want) <= 4
    np.testing.assert_allclose(got, tmos.numpy_min_d2(xyz, us, uc, vs, vc),
                               rtol=1e-5, atol=1e-5)


def test_pair_twin_equals_stacked_windows_and_min_d2():
    """The twin is the min_d2 tier computation on the windows the
    clustering path gathers (u in 8-point rows, v in 32-point rows): bit
    for bit, with counts past the caps clamped, empty runs, and runs
    reaching the last point."""
    from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar_ref
    from lidar_processing_tpu_torch.ops.stixel import _stacked_windows
    rng = np.random.default_rng(11)
    n, p = 2048, 200
    xyz = torch.from_numpy(rng.uniform(-20, 20, (n, 3)).astype(np.float32))
    us = torch.from_numpy(rng.integers(0, n - 8, p).astype(np.int32))
    uc = torch.from_numpy(rng.integers(0, 11, p).astype(np.int32))
    vs = torch.from_numpy(rng.integers(0, n - 96, p).astype(np.int32))
    vc = torch.from_numpy(rng.integers(0, 120, p).astype(np.int32))
    us[0], uc[0], vs[1], vc[1] = n - 8, 8, n - 96, 96
    got = tpp.pair_min_d2_v96(tpp.planar(xyz), n, us, uc, vs, vc)
    pu = _stacked_windows(xyz, us, uc, 1.0e9, 8, sr=8)
    pv = _stacked_windows(xyz, vs, vc, -1.0e9, 96, sr=32)
    want = min_d2_planar_ref(*pu, *pv)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _fma32(a, b, c):
    """Correctly rounded f32 fma(a, b, c), from float64: the product of
    two f32 is exact there, TwoSum gives the sum's error exactly, and only
    a sum that lands on an f32 midpoint needs that error to round."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64)
               for t in (a, b, c))
    prod = a * b
    s = prod + c
    t = s - prod
    err = (prod - (s - t)) + (c - t)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                     np.float32(-np.inf)))
    mid = (r != s) & ((r.astype(np.float64) + other) / 2 == s)
    fix = np.where(err > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(mid & (err != 0), fix, r)


def _trimmed_model(planes, us, uc, vs, vc, v_cap, fills=True):
    """The kernel's trimmed window in numpy: the real points of each run
    plus one fill row (+1e9) and one fill column (-1e9) where the run is
    short of its cap, d² = fma(dz, dz, fma(dx, dx, dy·dy)). fills=False:
    the real points only (inf for an empty side)."""
    n = planes.shape[1]
    out = np.empty(len(us), np.float32)
    for p in range(len(us)):
        sides = []
        for st, cnt, cap, fill in ((us[p], uc[p], tpp.U_CAP, 1.0e9),
                                   (vs[p], vc[p], v_cap, -1.0e9)):
            k = min(max(int(cnt), 0), cap)
            pts = planes[:, np.clip(int(st) + np.arange(k), 0, n - 1)]
            if fills and k < cap:
                pts = np.concatenate([pts, np.full((3, 1), fill,
                                                   np.float32)], 1)
            sides.append(pts)
        d = sides[0][:, :, None] - sides[1][:, None, :]
        d2 = _fma32(d[2], d[2], _fma32(d[0], d[0], d[1] * d[1]))
        out[p] = d2.min(initial=np.inf)
    return out


_PAIR_CASES = {v: kernel_cases.pair_cases(v) for v in (48, 96)}


@pytest.mark.parametrize("v_cap,case", [
    (v, i) for v in (48, 96) for i in range(len(_PAIR_CASES[v]))],
    ids=lambda a: str(a))
def test_trimmed_window_equals_pair_twin(v_cap, case):
    """The kernel's trim (real points, one fill row, one fill column)
    equals the twin's full 8 x v_cap window bit for bit on the crafted
    cases (tools/kernel_cases.py::pair_cases); in "fills win" a fill row
    or column does win on some pairs."""
    name, xyz, *runs = _PAIR_CASES[v_cap][case]
    planes = np.ascontiguousarray(xyz.T)
    want = tpp.pair_min_d2_ref(*torch.from_numpy(planes),
                               *map(torch.from_numpy, runs), v_cap).numpy()
    got = _trimmed_model(planes, *runs, v_cap)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                  err_msg=name)
    if name == "fills win":
        real = _trimmed_model(planes, *runs, v_cap, fills=False)
        assert (real != want).sum() >= 4, name


@pytest.mark.parametrize("layout", list(kernel_cases.pair_layouts(
    np.zeros((128, 3), np.float32))))
def test_pair_wrappers_read_each_layout_as_its_planes(layout):
    """The wrappers on a CPU layout (L = 8, L = 128 with padding rows,
    planar (1, 3n)) equal the twin on that layout's planes, built apart
    from the wrapper, bit for bit; runs that run past the last point
    clamp into the padding rows where the layout has them."""
    for v_cap, fn in ((48, tpp.pair_min_d2_v48), (96, tpp.pair_min_d2_v96)):
        for name, xyz, *runs in (_PAIR_CASES[v_cap][i] for i in (0, 6, 7)):
            points, lanes, planes = kernel_cases.pair_layouts(xyz)[layout]
            runs = [torch.from_numpy(a) for a in runs]
            before = fn.launches
            got = fn(torch.from_numpy(points), lanes, *runs)
            want = tpp.pair_min_d2_ref(*torch.from_numpy(planes), *runs,
                                       v_cap)
            assert fn.launches == before
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.numpy().view(np.int32),
                                          err_msg=f"{layout} {name}")


@pytest.mark.parametrize("shape,lanes", [((16, 25), 8), ((0, 24), 8),
                                         ((384,), 128), ((2, 24), 0)])
def test_pair_wrappers_reject_a_misshapen_layout(shape, lanes):
    pts = torch.zeros(shape)
    runs = [torch.zeros(4, dtype=torch.int32)] * 4
    for fn in (tpp.pair_min_d2_v48, tpp.pair_min_d2_v96):
        with pytest.raises(ValueError, match="lanes"):
            fn(pts, lanes, *runs)


def test_entries_bind_every_entry_point_of_probe_pairs_cu():
    """kernels/_build.py binds each extern "C" function of
    csrc/probe_pairs.cu with as many arguments as the source declares."""
    from lidar_processing_tpu_torch.kernels import _build
    src = (_build.CSRC / "probe_pairs.cu").read_text()
    decls = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert {n for n, _ in decls} == {"pair_min_d2_v48_launch",
                                     "pair_min_d2_v96_launch"}
    entries = dict(_build._ENTRIES)
    for name, params in decls:
        assert len(entries[name]) == len(params.split(",")), name


def test_probe_mosaic_mains_check_against_numpy():
    assert tmos.main(device="cpu", n=1024, n_pairs=64, reps=1)["correct"]
    assert tmos3.main(device="cpu", n=4096, n_pairs=256, reps=1)["correct"]


# ---- tools/probe_mosaic2.py -----------------------------------------------

def test_probe_mosaic2_twins_match_pallas_interpret(monkeypatch):
    """The JAX probe's three functions build their calls and inputs
    themselves; its `timed` is replaced by one that records each call's
    output (and returns a time, which the probe prints)."""
    jprobe = _load_probe("probe_mosaic2")
    outs = []
    monkeypatch.setattr(jprobe, "timed", lambda fn, args, name, iters=30:
                        outs.append(np.asarray(fn(*args))) or 1.0)
    n_a, n_b, n_c = 256, 256, 1024
    with pltpu.force_tpu_interpret_mode():
        jprobe.probe_scalar_loads(n_a)
        jprobe.probe_dyn_slice(n_b)
        jprobe.probe_accum_store(n_c)
    want_a, want_b, want_c = outs

    idx, val = tmos2.scalar_loads_inputs(n_a)
    got_a = tm2.gather_sum(torch.from_numpy(idx), torch.from_numpy(val))
    assert got_a.dtype == torch.int32
    np.testing.assert_array_equal(got_a.numpy(), want_a)

    off, planes = tmos2.dyn_slice_inputs(n_b)
    got_b = tm2.slice_sum(torch.from_numpy(off), torch.from_numpy(planes))
    assert got_b.shape == want_b.shape == (1, 1)
    terms = tmos2.slice_terms(off, planes)
    assert abs(float(got_b[0, 0]) - float(want_b[0, 0])) \
        <= 1e-5 * np.abs(terms).sum()

    x = tmos2.accum_store_inputs(n_c)
    np.testing.assert_array_equal(tm2.tile_scale(torch.from_numpy(x)).numpy(),
                                  want_c)


def test_probe_mosaic2_main_and_edge_cases():
    out = tmos2.main(device="cpu", n=2048, reps=1)
    assert set(out) == {"A", "B", "C"}
    # indices clamp into range, as the kernels' do
    val = torch.arange(10, dtype=torch.int32)
    got = tm2.gather_sum(torch.tensor([-3, 4, 99], dtype=torch.int32), val)
    assert int(got) == 0 + 4 + 9
    planes = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    got = tm2.slice_sum(torch.tensor([3], dtype=torch.int32), planes)
    assert float(got) == float(planes[2:4].sum())
    with pytest.raises(ValueError):
        tm2.tile_scale(torch.zeros(100))


def test_entries_bind_every_entry_point_of_probe_mosaic2_cu():
    """kernels/_build.py binds each extern "C" function of
    csrc/probe_mosaic2.cu with as many arguments as the source declares,
    and keeps no first-port (v0) entry or launch path."""
    from lidar_processing_tpu_torch.kernels import _build
    src = (_build.CSRC / "probe_mosaic2.cu").read_text()
    decls = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert {n for n, _ in decls} == {"gather_sum_launch",
                                     "slice_sum_launch", "tile_scale_launch"}
    entries = dict(_build._ENTRIES)
    for name, params in decls:
        assert len(entries[name]) == len(params.split(",")), name
    assert not [n for n in (*vars(_build), *entries, *vars(tm2))
                if "_v0" in n]


def test_slice_kernel_constants_match_the_wrapper():
    """The order model and the wrapper take the kernel's split and
    in-flight counts from kernels/probe_mosaic2.py: they must be the
    .cu file's."""
    from lidar_processing_tpu_torch.kernels import _build
    src = (_build.CSRC / "probe_mosaic2.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (kSlice\w+) = (\d+);", src)}
    assert const == {"kSliceWarps": tm2.SLICE_WARPS,
                     "kSliceTerms": tm2.SLICE_TERMS,
                     "kSliceChunks": tm2.SLICE_CHUNKS,
                     "kSliceBlocksPerSm": tm2.SLICE_BLOCKS_PER_SM}
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) \
        == str(32 * tm2.SLICE_WARPS)
    assert 32 % tm2.SLICE_TERMS == 0   # a group never straddles 32 offsets


def _cancelling_planes(rows, width, seed=1):
    """Rows of +-1e4 with small residues: an f32 sum's order shows."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random((rows, width)) < 0.5, -1.0, 1.0)
    return (sign * 1e4 + rng.uniform(-1e-2, 1e-2, (rows, width))).astype(
        np.float32)


@pytest.mark.parametrize("grid", [1, 7, 264])
def test_slice_sum_order_model_within_tolerance(grid):
    """The kernel's order of f32 adds, as the numpy model computes it,
    lands within 1e-5 of the sum of |terms| of the float64 sum: on the
    probe's inputs (the float4 path), their first 383 columns (the float
    path) and crafted cancelling rows, ragged term counts included."""
    off, planes = tmos2.dyn_slice_inputs(16384)
    cases = [(off, planes), (off[:16383], np.ascontiguousarray(
        planes[:, :383])), (off[:1000], _cancelling_planes(640, 384)),
        (off[:999], _cancelling_planes(640, 383))]
    for o, p in cases:
        terms = tmos2.slice_terms(o, p)
        got = tmos2.slice_sum_order_model(o, p, grid)
        assert got.dtype == np.float32
        assert abs(float(got) - terms.sum()) <= 1e-5 * np.abs(terms).sum()
    assert tmos2.slice_sum_order_model(off[:0], planes, grid) == 0.0


def test_slice_sum_order_model_adds_in_the_stated_order():
    """One term, one warp: item q of the 2 x W slice is lane q's (a
    float4 at W = 4, components into s0..s3; chunk c into s_(c % 4) at
    W = 33), a lane's value (s0 + s1) + (s2 + s3) and lane 0 adds lane 1
    last. Values where another order rounds otherwise; clamped offsets
    read rows R - 2 and 0."""
    x = np.array([[1e8, 1, -1e8, 1], [3, 1e-3, -7, 2.5]], np.float32)
    lane = [(x[r, 0] + x[r, 1]) + (x[r, 2] + x[r, 3]) for r in (0, 1)]
    for o in (0, 5, -3):
        got = tmos2.slice_sum_order_model(np.array([o], np.int32), x, 1, 1,
                                          1, 1)
        assert got.tobytes() == (lane[0] + lane[1]).tobytes()
    assert float(lane[0] + lane[1]) != float(x.astype(np.float64).sum())
    # the float path: 66 items, lanes 0 and 1 take 3 chunks, the rest 2
    y = _cancelling_planes(2, 33)
    items = y.reshape(-1)
    lanes = []
    for ln in range(32):
        s = np.zeros(4, np.float32)
        for c in range(3):
            if 32 * c + ln < 66:
                s[c % 4] = s[c % 4] + items[32 * c + ln]
        lanes.append((s[0] + s[1]) + (s[2] + s[3]))
    v = np.array(lanes, np.float32)
    for step in (16, 8, 4, 2, 1):
        v[:step] = v[:step] + v[step:2 * step]
    got = tmos2.slice_sum_order_model(np.array([0], np.int32), y, 1, 1, 1, 8)
    assert got.tobytes() == v[0].tobytes()


def test_slice_sum_twin_contract_on_the_cpu():
    """R = 2 (every offset clamps to row 0), W = 1, n = 0 (0.0), offsets
    below 0 and past R - 2: the twin, the model and numpy agree."""
    for rows, width in ((2, 1), (2, 384), (640, 383), (5, 4)):
        planes = _cancelling_planes(rows, width, seed=rows + width)
        for off in (np.array([], np.int32),
                    np.array([-7, 0, rows - 2, rows - 1, 10 ** 6], np.int32)):
            got = tm2.slice_sum(torch.from_numpy(off),
                                torch.from_numpy(planes))
            assert got.shape == (1, 1) and got.dtype == torch.float32
            terms = tmos2.slice_terms(np.clip(off, 0, rows - 2), planes)
            tol = 1e-5 * np.abs(terms).sum()
            assert abs(float(got) - terms.sum()) <= tol
            model = tmos2.slice_sum_order_model(off, planes, 3)
            assert abs(float(model) - terms.sum()) <= tol
            if off.size == 0:
                assert float(got) == 0.0 and float(model) == 0.0


def test_probe_entry_points_need_a_named_device_without_a_gpu(monkeypatch):
    """No silent CPU fallback: without a GPU, main() with no device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tprobe_uf.main, tprobe_uf2.main, tmos.main, tmos3.main,
                 tmos2.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()


def test_step_bench_needs_a_gpu(monkeypatch):
    """The step comparison measures in a process of its own per tree and
    fails there, rather than timing the CPU, when no GPU is present."""
    from lidar_processing_tpu_torch.tools import step_bench
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        step_bench.main(["--frames", "1"])
