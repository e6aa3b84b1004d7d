"""Crafted inputs at the edges of the two main-path kernels' contracts.

Numpy only, made from a seed, shared by the CPU tests, the card tests and
chip_smoke.py:

- ``uf_graphs``: edge lists for the union-find contract (labels[i] = the
  smallest node id of i's component over the first n_edges edges, ids
  clamped into [0, s_cap), n_edges clamped into [0, ec]), with
  ``uf_oracle``, an independent scipy answer;
- ``tier_cases``: packed descriptor sets for one tier table of the
  exact-test pass (kernels/tier_min_d2.py): every slot full, tiers that
  overflow their slots (so a later tier's slice start clamps), sparse
  tiers, empty sides, counts beyond the caps, runs that end at the
  buffer's last point and runs past it;
- ``pair_cases`` and ``pair_layouts``: runs for the pair-minimum probe
  kernels (kernels/probe_pairs.py; u <= 8, v <= v_cap points) at their
  contract's edges, and one point array in the three row layouts the
  kernels read in place;
- ``slice_cases``: (off, planes) for the dynamic-slice probe kernel
  (kernels/probe_mosaic2.py::slice_sum) at n in {16384, 16383, 1, 0} x
  W in {384, 383, 1} x R in {2, 640}, offsets below 0 and past R - 2.
"""

from __future__ import annotations

import numpy as np

from .probe_mosaic2 import dyn_slice_inputs
from .probe_uf import scipy_labels


def _padded(eu, ev, ec: int):
    out = np.zeros((2, ec), np.int32)
    out[0, :len(eu)], out[1, :len(ev)] = eu, ev
    return out[0], out[1]


def uf_graphs(s_cap: int = 10240, ec: int = 32768, seed: int = 0):
    """[(name, eu, ev, n_edges)]: (ec,) int32 edge arrays (zeros past the
    live edges) and an int n_edges."""
    rng = np.random.default_rng(seed)
    ids = np.arange(s_cap - 1, 0, -1)
    chain = _padded(ids, ids - 1, ec)                  # listed descending
    perm = rng.permutation(s_cap)
    path = _padded(perm[:-1], perm[1:], ec)
    star = _padded(np.full(s_cap - 1, s_cap - 1), np.arange(s_cap - 1), ec)
    m = ec // 4
    eu = rng.integers(0, s_cap, m)
    ev = np.minimum(s_cap - 1, eu + rng.integers(0, 6, m))
    loops = rng.integers(0, s_cap, m)
    dup = _padded(np.concatenate([eu, ev, loops, eu]),
                  np.concatenate([ev, eu, loops, ev]), ec)
    oor = _padded(rng.integers(-s_cap, 2 * s_cap, ec),
                  rng.integers(-s_cap, 2 * s_cap, ec), ec)
    eu = rng.integers(0, s_cap, ec)
    rnd = _padded(eu, np.minimum(s_cap - 1, eu + rng.integers(1, 40, ec)),
                  ec)
    return [("chain_descending", *chain, s_cap - 1),
            ("path_permuted", *path, s_cap - 1),
            ("star", *star, s_cap - 1),
            ("duplicates_selfloops", *dup, 4 * m),
            ("out_of_range_ids", *oor, ec // 2),
            ("n_edges_0", *rnd, 0),
            ("n_edges_over_ec", *rnd, ec + 1000),
            ("n_edges_negative", *rnd, -7)]


def uf_oracle(eu, ev, n_edges: int, s_cap: int) -> np.ndarray:
    """The contract's labels by scipy: ids clamped, n_edges clamped."""
    ne = min(max(int(n_edges), 0), len(eu))
    return scipy_labels(np.clip(eu, 0, s_cap - 1), np.clip(ev, 0, s_cap - 1),
                        ne, s_cap)


def _descriptors(rng, length: int, n: int):
    """(length,) packed start * 512 + count: counts 0-511 (a twentieth 0,
    a fifth beyond 96 points), starts mostly inside the buffer, some runs
    ending at its last point, a few running past it."""
    count = rng.integers(1, 97, length)
    big = rng.random(length) < 0.2
    count[big] = rng.integers(97, 512, int(big.sum()))
    count[rng.random(length) < 0.05] = 0
    start = rng.integers(0, np.maximum(n - count, 1))
    at_end = rng.random(length) < 0.05
    start[at_end] = n - count[at_end]
    past = rng.random(length) < 0.02
    start[past] = rng.integers(n - 16, n + 64, int(past.sum()))
    return (start * 512 + count).astype(np.int32)


def tier_cases(tiers, n: int = 4096, seed: int = 0):
    """[(name, xyz, s_usuc, s_vsvc, starts, n_in_tier)] for one tier
    table: xyz (n, 3) f32, a random walk, so runs near in index are near in
    space; (L,) int32 descriptors with L = sum of slots + 64; (T,) int32
    slice starts (the exclusive prefix sum of n_in_tier) and counts."""
    rng = np.random.default_rng(seed)
    xyz = np.cumsum(rng.normal(0.0, 0.08, (n, 3)), 0).astype(np.float32)
    slots = np.array([s for *_, s in tiers])
    length = int(slots.sum()) + 64
    over = slots + slots // 4 + 1
    over[-1] = slots[-1] // 2     # after the overflows its start clamps
    out = []
    for name, n_in in (("full", slots), ("overflow", over),
                       ("sparse", slots // 16 + 1),
                       ("empty", np.zeros_like(slots))):
        starts = np.concatenate([[0], np.cumsum(n_in)[:-1]])
        out.append((name, xyz, _descriptors(rng, length, n),
                    _descriptors(rng, length, n), starts.astype(np.int32),
                    n_in.astype(np.int32)))
    return out


def pair_cases(v_cap: int, n: int = 1024, p: int = 64, seed: int = 0):
    """[(name, xyz, us, uc, vs, vc)] for the pair kernels: xyz (n, 3) f32
    (a random walk, so runs near in index are near in space; in "fills
    win", points on the scale of the +-1e9 fills), and (p,) int32 runs:
    empty sides, negative counts, counts past the caps, runs that reach
    the last point or run past it, negative starts that clamp to point 0,
    and fill rows or columns that win the min."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0.0, 0.08, (n, 3)), 0).astype(np.float32)

    def runs(cap, lo=0, hi=None):
        count = rng.integers(lo, cap + 1 if hi is None else hi, p)
        return rng.integers(0, n - cap, p), count

    def case(name, u, v, xyz=walk):
        out.append((name, xyz, *(a.astype(np.int32) for a in (*u, *v))))

    out = []
    case("random", runs(8), runs(v_cap))
    case("empty u", runs(8, 0, 1), runs(v_cap))
    case("empty v", runs(8), runs(v_cap, 0, 1))
    case("both empty", runs(8, 0, 1), runs(v_cap, 0, 1))
    case("negative counts", runs(8, -9, 9), runs(v_cap, -3 * v_cap, 0))
    case("past the caps", runs(8, 9, 64), runs(v_cap, v_cap + 1, 4 * v_cap))
    (us, uc), (vs, vc) = runs(8), runs(v_cap)
    us[::2], vs[1::2] = n - uc[::2], n - vc[1::2]     # end at point n - 1
    us[1::4], vs[::4] = n - 3, n - rng.integers(1, 8, len(vs[::4]))  # past
    case("last point", (us, uc), (vs, vc))
    (us, uc), (vs, vc) = runs(8), runs(v_cap)
    us[::2], vs[1::2] = -rng.integers(1, 9, len(us[::2])), -rng.integers(
        1, 2 * v_cap, len(vs[1::2]))
    case("negative starts", (us, uc), (vs, vc))
    # a third of the points near +1e9, a third near -1e9 (the fills'
    # scale), a third near 0: a fill row or column wins where a run holds
    # a point near the other side's fill
    big = np.float32(1.0e9) * rng.choice([-1.0, 0.0, 1.0], (n, 1))
    near = (big + rng.normal(0.0, 256.0, (n, 3))).astype(np.float32)
    case("fills win", runs(8, 0, 9), runs(v_cap, 0, v_cap + 1), near)
    return out


def pair_layouts(xyz: np.ndarray, pad_rows: int = 16):
    """{name: (points, lanes, planes)} for one (n, 3) f32 point array
    (n a multiple of 128): probe_mosaic's (n/8, 24) stacked view (L = 8),
    probe_mosaic3's (n/128 + pad_rows, 384) rows with zero padding rows
    (L = 128), and the planar (1, 3n) view of a (3, n) array (L = n);
    planes (3, R * L) are each layout's x/y/z planes, padding included."""
    n = xyz.shape[0]
    planes = np.ascontiguousarray(xyz.T, dtype=np.float32)
    padded = np.concatenate([planes, np.zeros((3, 128 * pad_rows),
                                              np.float32)], 1)
    rows = lambda lanes, pl: np.concatenate(  # noqa: E731
        [pl[a].reshape(-1, lanes) for a in range(3)], 1)
    return {"stacked (L = 8)": (rows(8, planes), 8, planes),
            "rows (L = 128)": (rows(128, padded), 128, padded),
            "planar (L = n)": (planes.reshape(1, -1), n, planes)}


def slice_cases(seed: int = 0):
    """[(name, off (n,) int32, planes (R, W) f32)]: probe_mosaic2's
    inputs (16384 terms of a (640, 384) array) with some offsets set
    below 0, past R - 2 and to R - 1 (all clamp), cut to n terms, W
    columns (W % 4 == 0: float4 rows; else the float path) and R rows
    (R = 2: every term is rows 0 and 1)."""
    off, planes = dyn_slice_inputs(16384, seed)
    off[::97] = -5
    off[1::89] = 10 ** 6
    off[2::83] = planes.shape[0] - 1
    return [(f"n={n} W={w} R={r}", off[:n].copy(),
             np.ascontiguousarray(planes[:r, :w]))
            for n in (16384, 16383, 1, 0) for w in (384, 383, 1)
            for r in (2, 640)]
