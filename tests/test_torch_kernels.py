"""PyTorch port: the two kernels' plain twins against the Pallas kernels.

On the CPU the wrappers run their plain PyTorch twins (a CUDA tensor would
launch the hand-written Hopper kernel instead). The twins are held against
the JAX package's Pallas kernels run as its own tests run them — min_d2 in
interpret mode, union-find under pltpu.force_tpu_interpret_mode() — and
against their XLA twins. tests/test_torch_cuda.py compares the CUDA
kernels with the twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.kernels import union_find as juf
from lidar_processing_tpu.kernels.min_d2 import (min_d2_planar as jmin_d2,
                                                 min_d2_planar_xla)
from lidar_processing_tpu_torch.kernels import _build
from lidar_processing_tpu_torch.kernels import union_find as tuf
from lidar_processing_tpu_torch.kernels.min_d2 import (min_d2_planar,
                                                       min_d2_planar_ref)
from lidar_processing_tpu_torch.ops import stixel as tsx


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
