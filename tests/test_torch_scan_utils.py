"""PyTorch port: sort and run primitives against the JAX package.

Inputs are made with numpy from a seed and given to both packages; every
result must be bit-identical (same values, same int32 dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_processing_tpu.ops import scan_utils as jsu
from lidar_processing_tpu_torch.ops import scan_utils as tsu


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _runs(rng, n, n_ids):
    return np.sort(rng.integers(0, n_ids, n)).astype(np.int32)


@pytest.mark.parametrize("seed,n,num_runs", [(0, 64, 16), (1, 500, 700),
                                             (2, 1000, 37), (3, 7, 7)])
def test_run_starts(seed, n, num_runs):
    rng = np.random.default_rng(seed)
    ids = _runs(rng, n, max(2, n // 10))
    new_run = np.concatenate([[True], ids[1:] != ids[:-1]])
    want = jsu.run_starts(jnp.asarray(new_run), num_runs)
    _eq(tsu.run_starts(torch.from_numpy(new_run), num_runs), want)


@pytest.mark.parametrize("seed,n,cap,p", [(0, 100, 64, 0.3), (1, 100, 16, 0.5),
                                          (2, 50, 200, 0.9), (3, 30, 8, 0.0)])
def test_compact_mask(seed, n, cap, p):
    mask = np.random.default_rng(seed).uniform(size=n) < p
    want = jsu.compact_mask(jnp.asarray(mask), cap)
    got = tsu.compact_mask(torch.from_numpy(mask), cap)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("seed,n", [(0, 200), (1, 1), (2, 200)])
def test_seg_broadcast_first(seed, n):
    rng = np.random.default_rng(seed)
    ids = _runs(rng, n, max(1, n // 5))
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    want = jsu.seg_broadcast_first(jnp.asarray(vals), jnp.asarray(ids))
    _eq(tsu.seg_broadcast_first(torch.from_numpy(vals),
                                torch.from_numpy(ids)), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_by_matches_lax_sort(seed):
    """One and two keys, heavy ties, float keys holding both -0.0 and 0.0:
    the stable passes reproduce lax.sort's order exactly."""
    rng = np.random.default_rng(seed)
    n = 3000
    k1 = rng.integers(0, 5, n).astype(np.int32)
    k2 = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25, 7.0], np.float32), n)
    pay = np.arange(n, dtype=np.int32)
    pay_f = rng.standard_normal(n).astype(np.float32)
    want1 = jax.lax.sort((jnp.asarray(k2), jnp.asarray(pay)), num_keys=1)
    got1 = tsu.sort_by(torch.from_numpy(k2), torch.from_numpy(pay))
    want2 = jax.lax.sort(tuple(map(jnp.asarray, (k1, k2, pay, pay_f))),
                         num_keys=2)
    got2 = tsu.sort_by((torch.from_numpy(k1), torch.from_numpy(k2)),
                       torch.from_numpy(pay), torch.from_numpy(pay_f))
    for got, want in ((got1, want1), (got2, want2)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                          np.asarray(w).view(np.uint8))


def test_indexing_helpers_follow_jax_semantics():
    """Clamped gathers, clamped dynamic slices and dropping scatters."""
    x = np.arange(10, dtype=np.int32) * 3
    idx = np.array([0, 9, 12, 5], np.int32)
    _eq(tsu.take(torch.from_numpy(x), torch.from_numpy(idx)),
        jnp.asarray(x)[jnp.asarray(idx)])
    for start in (0, 4, 6, 8, 20):
        _eq(tsu.dynamic_slice(torch.from_numpy(x),
                              torch.tensor(start, dtype=torch.int32), 4),
            jax.lax.dynamic_slice(jnp.asarray(x), (jnp.int32(start),), (4,)))
    tgt = np.array([1, 3, 10, 3, 99, 0], np.int32)
    vals = np.array([5, -2, 7, 4, 1, 9], np.int32)
    for reduce, fill, jfn in (("sum", 0, "add"), ("amin", 100, "min"),
                              ("amax", -100, "max")):
        want = getattr(jnp.full((10,), fill, jnp.int32).at[jnp.asarray(tgt)],
                       jfn)(jnp.asarray(vals), mode="drop")
        _eq(tsu.scatter_drop(10, torch.from_numpy(tgt),
                             torch.from_numpy(vals), fill, reduce), want)
    tgt_u = np.array([2, 11, 7, 10], np.int32)
    vals_u = np.array([1, 2, 3, 4], np.int32)
    want = jnp.zeros((10,), jnp.int32).at[jnp.asarray(tgt_u)].set(
        jnp.asarray(vals_u), mode="drop")
    _eq(tsu.set_drop(torch.zeros(10, dtype=torch.int32),
                     torch.from_numpy(tgt_u), torch.from_numpy(vals_u)), want)
