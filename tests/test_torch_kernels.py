"""PyTorch port: the main path's kernels' plain twins against the JAX package.

On the CPU the wrappers run their plain PyTorch twins (a CUDA tensor would
launch the hand-written Hopper kernel instead). The twins are held against
the JAX package's Pallas kernels run as its own tests run them — min_d2 in
interpret mode, union-find under pltpu.force_tpu_interpret_mode() — and
against their XLA twins. The tier pass twin (tier_min_d2_ref) is held
against the JAX package's per-tier loop, and a numpy model of the CUDA
kernel's per-slot formula against the twin. tests/test_torch_cuda.py
compares the CUDA kernels with the twins on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.kernels import union_find as juf
from lidar_processing_tpu.kernels.min_d2 import (min_d2_planar as jmin_d2,
                                                 min_d2_planar_xla)
from lidar_processing_tpu.ops import stixel as jsx
from lidar_processing_tpu_torch.kernels import _build
from lidar_processing_tpu_torch.kernels import tier_min_d2 as ttm
from lidar_processing_tpu_torch.kernels import union_find as tuf
from lidar_processing_tpu_torch.kernels.min_d2 import (min_d2_planar,
                                                       min_d2_planar_ref)
from lidar_processing_tpu_torch.ops import stixel as tsx
from lidar_processing_tpu_torch.tools.knife_cases import d2_fma_xy
from lidar_processing_tpu_torch.tools.kernel_cases import (tier_cases,
                                                           uf_graphs,
                                                           uf_oracle)


def _windows(seed, p, wu, wv):
    """Random planar windows with masked suffixes (+1e9 u / -1e9 v), as
    the stixel caller fills them."""
    rng = np.random.default_rng(seed)
    pts_u = rng.uniform(-30, 30, (p, wu, 3)).astype(np.float32)
    pts_v = rng.uniform(-30, 30, (p, wv, 3)).astype(np.float32)
    for q in range(0, p, max(1, p // 7)):
        pts_u[q, wu - (q % wu):] = 1.0e9
        pts_v[q, wv - (q % wv):] = -1.0e9
    return tuple(np.ascontiguousarray(pts[:, :, a])
                 for pts in (pts_u, pts_v) for a in range(3))


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def _tier_widths():
    return [(u + 8, v + 32) for u, v, _ in tsx._TIERS_INTRA + tsx._TIERS_SNP]


@pytest.mark.parametrize("p,wu,wv", [(24, 16, 64), (9, 104, 320),
                                     (7, 160, 160), (1, 64, 64)])
def test_min_d2_twin_matches_pallas_interpret(p, wu, wv):
    args = _windows(p, p, wu, wv)
    want = np.asarray(jmin_d2(*args, interpret=True))
    got = min_d2_planar(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (p,) and got.dtype == np.float32
    assert _ulp(got, want) <= 4


@pytest.mark.parametrize("wu,wv", sorted(set(_tier_widths())))
def test_min_d2_twin_matches_xla_at_tier_widths(wu, wv):
    args = _windows(wu * wv, 40, wu, wv)
    want = np.asarray(min_d2_planar_xla(*args))
    got = min_d2_planar_ref(*map(torch.from_numpy, args)).numpy()
    assert _ulp(got, want) <= 4


def test_min_d2_wrapper_on_cpu_runs_twin_without_counting():
    args = tuple(map(torch.from_numpy, _windows(0, 33, 40, 128)))
    before = min_d2_planar.launches
    np.testing.assert_array_equal(min_d2_planar(*args).numpy(),
                                  min_d2_planar_ref(*args).numpy())
    assert min_d2_planar.launches == before


def _graph(seed, s_cap, n_edges):
    rng = np.random.default_rng(seed)
    ec = max(n_edges + 64, 128)
    eu = rng.integers(0, s_cap, ec).astype(np.int32)
    ev = np.minimum(s_cap - 1, rng.integers(0, s_cap, ec)
                    + rng.integers(0, 30, ec)).astype(np.int32)
    return eu, ev


@pytest.mark.parametrize("seed,s_cap,n_edges", [
    (0, 512, 900), (1, 1024, 300), (3, 128, 0)])
def test_union_find_twin_matches_pallas_interpret(seed, s_cap, n_edges):
    from jax.experimental.pallas import tpu as pltpu
    eu, ev = _graph(seed, s_cap, n_edges)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(juf.cc_labels_pallas(
            jnp.asarray(eu), jnp.asarray(ev), jnp.int32(n_edges), s_cap))
    got = tuf.cc_labels(torch.from_numpy(eu), torch.from_numpy(ev),
                        torch.tensor(n_edges, dtype=torch.int32), s_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,s_cap,n_edges", [
    (2, 2048, 4000), (4, 8192, 20000), (5, 10240, 32000), (6, 64, 5000)])
def test_union_find_twin_matches_xla(seed, s_cap, n_edges):
    eu, ev = _graph(seed, s_cap, n_edges)
    want = np.asarray(juf.cc_labels_xla(jnp.asarray(eu), jnp.asarray(ev),
                                        jnp.int32(n_edges), s_cap))
    got = tuf.cc_labels_ref(torch.from_numpy(eu), torch.from_numpy(ev),
                            torch.tensor(n_edges, dtype=torch.int32), s_cap)
    np.testing.assert_array_equal(got.numpy(), want)


def test_union_find_twin_long_chain_converges():
    """A path whose min id sits at the far end needs many hook rounds; the
    twin runs to the fixpoint (the JAX twin stops at 32 rounds)."""
    s_cap = 4096
    perm = np.random.default_rng(7).permutation(s_cap).astype(np.int32)
    eu, ev = perm[:-1].copy(), perm[1:].copy()
    got = tuf.cc_labels_ref(torch.from_numpy(eu), torch.from_numpy(ev),
                            torch.tensor(s_cap - 1, dtype=torch.int32), s_cap)
    assert np.all(got.numpy() == 0)


_GRAPHS = {name: (eu, ev, ne) for name, eu, ev, ne in uf_graphs()}


@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_union_find_twin_on_contract_graphs(name):
    """The kernel's contract at its edges (s_cap 10240, 32768 edge slots):
    a descending chain, a permuted path, a star on the largest id,
    duplicates and self-loops, out-of-range ids (clamp), n_edges 0, > ec
    and < 0. The twin equals a scipy min-id oracle on every graph and the
    JAX twin, which converges within its 32 rounds on all of them. JAX
    wraps negative gather indices where the contract clamps them, so the
    JAX twin gets the ids clamped below."""
    eu, ev, ne = _GRAPHS[name]
    got = tuf.cc_labels_ref(torch.from_numpy(eu), torch.from_numpy(ev),
                            torch.tensor(ne, dtype=torch.int32), 10240)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), uf_oracle(eu, ev, ne, 10240))
    want = juf.cc_labels_xla(jnp.asarray(np.maximum(eu, 0)),
                             jnp.asarray(np.maximum(ev, 0)), jnp.int32(ne),
                             10240)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# a tier table with the real caps and few slots, so the CPU twin is quick
_SMALL_TIERS = ((8, 32, 40), (8, 96, 16), (32, 96, 24), (96, 96, 12),
                (96, 288, 8), (288, 288, 6))
_TIER_CASES = {name: case for name, *case in tier_cases(_SMALL_TIERS)}


@functools.partial(jax.jit, static_argnames=("tiers",))
def _jax_tier_loop(xyz, s_usuc, s_vsvc, starts, n_in_tier, tiers):
    """The JAX package's per-tier loop of _tiered_exact, up to min d²:
    dynamic slice, unpack, _stacked_windows on both sides, min_d2; jitted,
    as it runs inside the JAX package's jitted ``cluster`` (eagerly, op by
    op, XLA would round each product and sum of d² on its own)."""
    out = []
    for t, (u_cap, v_cap, slots) in enumerate(tiers):
        act = jnp.arange(slots, dtype=jnp.int32) < n_in_tier[t]
        usuc = jax.lax.dynamic_slice(s_usuc, (starts[t],), (slots,))
        vsvc = jax.lax.dynamic_slice(s_vsvc, (starts[t],), (slots,))
        us, uc, vs, vc = (jnp.where(act, a, 0) for a in (
            usuc >> 9, usuc & 511, vsvc >> 9, vsvc & 511))
        pu = jsx._stacked_windows(xyz, us, uc, jsx._F_BIG, u_cap, sr=8)
        pv = jsx._stacked_windows(xyz, vs, vc, -jsx._F_BIG, v_cap, sr=32)
        out.append(min_d2_planar_xla(*pu, *pv))
    return jnp.concatenate(out)


@pytest.mark.parametrize("name", sorted(_TIER_CASES))
def test_tier_min_d2_twin_matches_jax_tier_loop(name):
    """tier_min_d2_ref equals the old per-tier loop bit for bit: every
    slot full, overflowing tiers with a clamped slice start, sparse tiers,
    no active slot; empty sides, counts past the caps, runs ending at and
    running past the buffer's last point."""
    case = _TIER_CASES[name]
    got = ttm.tier_min_d2_ref(*map(torch.from_numpy, case), _SMALL_TIERS)
    want = np.asarray(_jax_tier_loop(*map(jnp.asarray, case), _SMALL_TIERS))
    assert got.dtype == torch.float32
    assert got.shape == (sum(s for *_, s in _SMALL_TIERS),)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _kernel_model(xyz, s_usuc, s_vsvc, starts, n_in_tier, tiers):
    """csrc/tier_min_d2.cu's per-slot formula, written out in numpy f32:
    the clamped slice start, the active test, the count clamp, the read of
    a point index q as row clamp(q >> log2(sr)), lane q mod sr, an
    empty side as its one fill point, and d² = fma(dz, dz, fma(dx, dx,
    dy·dy))."""
    n, length = xyz.shape[0], s_usuc.shape[0]
    big = np.float32(1.0e9)

    def run(desc, cap, shift, fill):
        q = (desc >> 9) + np.arange(min(desc & 511, cap))
        if q.size == 0:
            return np.full((1, 3), fill, np.float32)
        row = np.clip(q >> shift, 0, (n >> shift) - 1)
        return xyz[(row << shift) | (q & ((1 << shift) - 1))]

    out = []
    for t, (u_cap, v_cap, slots) in enumerate(tiers):
        lo = min(max(int(starts[t]), 0), length - slots)
        for k in range(slots):
            act = k < n_in_tier[t]
            u = run(s_usuc[lo + k] if act else 0, u_cap, 3, big)
            v = run(s_vsvc[lo + k] if act else 0, v_cap, 5, -big)
            out.append(d2_fma_xy(u[:, None] - v[None, :]).min())
    return np.array(out, np.float32)


@pytest.mark.parametrize("name", sorted(_TIER_CASES))
def test_tier_min_d2_kernel_formula_matches_twin(name):
    """The CUDA kernel reads runs in place and skips the fill lanes; its
    formula, modelled in numpy, equals the window twin bit for bit."""
    case = _TIER_CASES[name]
    want = ttm.tier_min_d2_ref(*map(torch.from_numpy, case), _SMALL_TIERS)
    got = _kernel_model(*case, _SMALL_TIERS)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))


def test_tier_min_d2_wrapper_on_cpu_runs_twin_without_counting():
    case = tuple(map(torch.from_numpy, _TIER_CASES["overflow"]))
    before = ttm.tier_min_d2.launches
    got = ttm.tier_min_d2(*case, _SMALL_TIERS)
    assert torch.equal(got, ttm.tier_min_d2_ref(*case, _SMALL_TIERS))
    assert ttm.tier_min_d2.launches == before


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    """The library name carries a hash of sources and flags, so an edited
    source never loads a stale build."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build._digest()
    (src / "k.cu").write_text("// b\n")
    assert _build._digest() != first


@pytest.mark.parametrize("seed,s_cap,n_edges", [
    (0, 512, 900), (2, 2048, 4000), (4, 8192, 20000), (3, 128, 0),
    (5, 1 << 16, 5000)])    # above the packed-key limit: 3-operand path
def test_hybrid_matches_jax_hybrid(seed, s_cap, n_edges):
    """cc_labels_hybrid(serial=cc_labels_ref) against the JAX package's
    cc_labels_hybrid(serial=cc_labels_xla) on tests/test_kernels.py's
    graphs, and against cc_labels_ref alone; the default serial stage is
    cc_labels (its twin on the CPU)."""
    eu, ev = _graph(seed, s_cap, n_edges)
    ne = torch.tensor(n_edges, dtype=torch.int32)
    want = np.asarray(juf.cc_labels_hybrid(
        jnp.asarray(eu), jnp.asarray(ev), jnp.int32(n_edges), s_cap,
        serial=juf.cc_labels_xla))
    args = (torch.from_numpy(eu), torch.from_numpy(ev), ne, s_cap)
    got = tuf.cc_labels_hybrid(*args, serial=tuf.cc_labels_ref)
    assert got.dtype == torch.int32 and got.shape == (s_cap,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  tuf.cc_labels_ref(*args).numpy())
    if s_cap <= 10240:
        assert torch.equal(tuf.cc_labels_hybrid(*args), got)


def test_hybrid_batched_equals_frames_alone():
    """Three frames of different edge counts (one with none) in one call:
    each row equals the frame alone, and the serial stage is called once
    for the batch with (B, ec) edges."""
    graphs = [_graph(s, 2048, 4000) for s in (2, 3, 6)]
    eu, ev = (torch.from_numpy(np.stack(a)) for a in zip(*graphs))
    ne = torch.tensor([4000, 0, 1500], dtype=torch.int32)
    calls = []

    def serial(*a):
        calls.append(a[0].shape)
        return tuf.cc_labels_ref(*a)
    got = tuf.cc_labels_hybrid(eu, ev, ne, 2048, serial=serial)
    assert calls == [eu.shape]
    for b in range(3):
        one = tuf.cc_labels_hybrid(eu[b], ev[b], ne[b], 2048)
        assert torch.equal(got[b], one), b
        assert torch.equal(one, tuf.cc_labels_ref(eu[b], ev[b], ne[b], 2048))
