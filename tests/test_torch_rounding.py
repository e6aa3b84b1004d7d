"""PyTorch port: every clustering d² site rounds as its JAX counterpart.

Each site computes a sum of three float32 squares; within an ULP of R² its
rounding decides a link. The JAX package's roundings on the CPU were found
through its jitted functions with crafted knife-edge pairs
(tools/knife_cases.py; tests/test_torch_spatial.py and
tests/test_torch_cellgraph.py run those pairs through both packages). Here
each port site is held bit for bit, on 10⁴ seeded float32 triples, against
the JAX site's own expression jitted in its own form (reduce axis, broadcast,
``lax.scan``) and against the numpy emulation of that rounding:
fma(z, z, fma(y, y, x·x)) at the screens, the cellgraph's row scan and the
halo test; fma(z, z, fma(x, x, y·y)) at the stixel exact test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.kernels.min_d2 import min_d2_planar_xla
from lidar_processing_tpu_torch.kernels.min_d2 import min_d2_planar_ref
from lidar_processing_tpu_torch.ops import clustering as tcl
from lidar_processing_tpu_torch.ops import stixel as tsx
from lidar_processing_tpu_torch.ops.scan_utils import sum_sq3
from lidar_processing_tpu_torch.parallel import spatial as tsp
from lidar_processing_tpu_torch.tools import knife_cases as kc

N = 10_000
R2 = float(kc.R2)


def _points(seed, *shape):
    """Seeded float32 points (..., 3) in a cube of side 1 m: their
    differences are d² near R² = 0.18 often enough that the three
    roundings part on a good share of them."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (*shape, 3)).astype(np.float32)


def _aabbs(seed, n):
    p = _points(seed, n, 2)
    return np.concatenate([p.min(1), p.max(1)], -1)         # (n, 6)


def _jax_pair_classify(aabb, rep, k):
    """ops/stixel.py:688-702: pair_classify's gap and rep d² for the
    shift-k pairs of an (M, 6) / (M, 3) cell table."""
    v_aabb = jnp.roll(aabb, -k, axis=0)
    v_rep = jnp.roll(rep, -k, axis=0)
    gap = jnp.maximum(0.0, jnp.maximum(aabb[:, 0:3] - v_aabb[:, 3:6],
                                       v_aabb[:, 0:3] - aabb[:, 3:6]))
    dr = rep - v_rep
    return jnp.sum(gap * gap, axis=1), jnp.sum(dr * dr, axis=1)


def _jax_gap(u, v):
    """ops/stixel.py:882-884 (supernode pairs)."""
    gap = jnp.maximum(0.0, jnp.maximum(u[:, 0:3] - v[:, 3:6],
                                       v[:, 0:3] - u[:, 3:6]))
    return jnp.sum(gap * gap, axis=1)


def _jax_d2(a, b):
    """ops/stixel.py:886-888, one of the four supernode rep probes."""
    d = a - b
    return jnp.sum(d * d, axis=1)


def _jax_cellgraph_gap(amin, amax, bmin, bmax):
    """ops/clustering.py:127-131, an (M, 124) table of neighbours."""
    gap = jnp.maximum(0.0, jnp.maximum(amin[:, None, :] - bmax,
                                       bmin - amax[:, None, :]))
    return jnp.sum(gap * gap, axis=-1)


def _jax_cellgraph_rep(rep, nrep):
    """ops/clustering.py:134-136."""
    dr = rep[:, None, :] - nrep
    return jnp.sum(dr * dr, axis=-1)


def _jax_row_scan(pa, pb):
    """ops/clustering.py:173-181, the exact row scan inside lax.scan."""
    def row(carry, k):
        diff = pa[:, k, None, :] - pb
        d2 = jnp.sum(diff * diff, axis=-1)
        return jnp.minimum(carry, jnp.min(d2, axis=-1)), None
    init = jnp.full((pa.shape[0],), 3.4e38, jnp.float32)
    return jax.lax.scan(row, init, jnp.arange(pa.shape[1]))[0]


def _jax_halo(rx, lx):
    """parallel/spatial.py:213-214, the halo test's (H, H) d²."""
    d = rx[:, None, :] - lx[None, :, :]
    return jnp.sum(d * d, axis=2)


def _site_cells(k, which):
    """The cell-pair screens over a table of the shipped max_cells rows
    (XLA picks the rep screen's fusion by that shape: unfused at other
    sizes, ROADMAP §3), the shift-k pairs as stixel.py's _roll makes
    them."""
    m = kc.PIPELINE.max_cells
    aabb, rep = _aabbs(1 + k, m), _points(3 + k, m)
    t_aabb, t_rep = torch.from_numpy(aabb)[None], torch.from_numpy(rep)[None]
    want = jax.jit(_jax_pair_classify, static_argnums=2)(aabb, rep, k)
    if which == "gap":
        v = np.roll(aabb, -k, 0)
        gap = np.maximum(0, np.maximum(aabb[:, :3] - v[:, 3:],
                                       v[:, :3] - aabb[:, 3:]))
        return (tsx._pair_gap_d2(t_aabb, tsx._roll(t_aabb, k))[0], want[0],
                kc.d2_fma_yx(gap))
    return (tsx._d2(t_rep, tsx._roll(t_rep, k))[0], want[1],
            kc.d2_fma_yx(rep - np.roll(rep, -k, 0)))


def _site_sn_probes():
    """The supernode rows [aabb(6), rep(3), rep2(3)] and all four probes:
    ru rep / rep2 against rv rep / rep2."""
    ru, rv = (np.concatenate([_aabbs(s, N), _points(s + 1, N, 2).reshape(
        N, 6)], -1) for s in (3, 5))
    slices = [(slice(6, 9), slice(6, 9)), (slice(6, 9), slice(9, 12)),
              (slice(9, 12), slice(6, 9)), (slice(9, 12), slice(9, 12))]
    tu, tv = torch.from_numpy(ru), torch.from_numpy(rv)
    port = torch.stack([tsx._d2(tu[:, a], tv[:, b]) for a, b in slices])
    want = jax.jit(lambda u, v: jnp.stack([_jax_d2(u[:, a], v[:, b])
                                           for a, b in slices]))(ru, rv)
    emul = np.stack([kc.d2_fma_yx(ru[:, a] - rv[:, b]) for a, b in slices])
    return port, want, emul


def _site_sn_gap():
    ru, rv = _aabbs(7, N), _aabbs(8, N)
    port = tsx._pair_gap_d2(torch.from_numpy(ru), torch.from_numpy(rv))
    gap = np.maximum(0, np.maximum(ru[:, :3] - rv[:, 3:],
                                   rv[:, :3] - ru[:, 3:]))
    return port, jax.jit(_jax_gap)(ru, rv), kc.d2_fma_yx(gap)


def _site_cellgraph_gap():
    m, k = 100, 100                      # N table entries (M, 124-like)
    a, b = _aabbs(9, m), _aabbs(10, m * k).reshape(m, k, 6)
    amin, amax, bmin, bmax = a[:, :3], a[:, 3:], b[..., :3], b[..., 3:]
    gap = np.maximum(0, np.maximum(amin[:, None] - bmax,
                                   bmin - amax[:, None]))
    port = sum_sq3(*torch.from_numpy(gap).unbind(-1))
    return (port, jax.jit(_jax_cellgraph_gap)(amin, amax, bmin, bmax),
            kc.d2_fma_yx(gap))


def _site_cellgraph_rep():
    rep, nrep = _points(11, 100), _points(12, 100, 100)
    dr = rep[:, None] - nrep
    port = sum_sq3(*torch.from_numpy(dr).unbind(-1))
    return port, jax.jit(_jax_cellgraph_rep)(rep, nrep), kc.d2_fma_yx(dr)


def _site_row_scan():
    """Min over 4 x 4 point pairs of N cell pairs: the min of each pair is
    one of its 16 triples' d²."""
    pa, pb = _points(13, N, 4), _points(14, N, 4)
    port = tcl._min_d2_rows(torch.from_numpy(pa).permute(2, 0, 1)[:, None],
                            torch.from_numpy(pb).permute(2, 0, 1)[:, None])
    emul = kc.d2_fma_yx(pa[:, :, None] - pb[:, None]).min((1, 2))
    return port[0], jax.jit(_jax_row_scan)(pa, pb), emul


def _site_halo():
    rx, lx = _points(15, 100), _points(16, 100)
    d = rx[:, None] - lx[None]
    port = sum_sq3(*torch.from_numpy(d).unbind(-1))
    want = jax.jit(_jax_halo)(rx, lx)
    # and the site itself: its verdicts are the JAX d²'s
    gid = torch.zeros(100, dtype=torch.int32)
    got = tsp._cross_edges(torch.from_numpy(rx), gid, torch.from_numpy(lx),
                           gid, R2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want) <= kc.R2)
    return port, want, kc.d2_fma_yx(d)


def _site_exact():
    """The stixel exact test: windows of one point a side, so each pair's
    min is its one triple."""
    u, v = _points(17, N, 1), _points(18, N, 1)
    planes = [u[..., a] for a in range(3)] + [v[..., a] for a in range(3)]
    port = min_d2_planar_ref(*map(torch.from_numpy, planes))
    return (port, jax.jit(min_d2_planar_xla)(*planes),
            kc.d2_fma_xy(u[:, 0] - v[:, 0]))


SITES = {"stixel cell gap, k = 1": lambda: _site_cells(1, "gap"),
         "stixel cell gap, k = 2": lambda: _site_cells(2, "gap"),
         "stixel cell rep, k = 1": lambda: _site_cells(1, "rep"),
         "stixel cell rep, k = 2": lambda: _site_cells(2, "rep"),
         "stixel supernode gap": _site_sn_gap,
         "stixel supernode rep probes": _site_sn_probes,
         "stixel exact test": _site_exact,
         "cellgraph gap": _site_cellgraph_gap,
         "cellgraph rep": _site_cellgraph_rep,
         "cellgraph row scan": _site_row_scan,
         "halo test": _site_halo}


@pytest.mark.parametrize("site", sorted(SITES))
def test_d2_site_matches_jax_bit_for_bit(site):
    port, want, emul = SITES[site]()
    port, want = port.numpy(), np.asarray(want)
    assert port.dtype == want.dtype == np.float32
    assert port.shape == want.shape == emul.shape
    assert port.size >= N
    np.testing.assert_array_equal(port.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(port.view(np.int32),
                                  emul.astype(np.float32).view(np.int32))


def test_the_roundings_part_on_the_seeded_triples():
    """The check above has teeth: on these triples the three roundings
    give other bits on a good share (the sites would not all pass with
    the wrong one)."""
    t = (_points(1, N) - _points(2, N)).astype(np.float32)
    d2 = {k: f(t).view(np.int32) for k, f in kc.ROUNDINGS.items()}
    for a, b in (("unfused", "fma_yx"), ("unfused", "fma_xy"),
                 ("fma_yx", "fma_xy")):
        assert (d2[a] != d2[b]).mean() > 0.05, (a, b)
