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
  buffer's last point and runs past it.
"""

from __future__ import annotations

import numpy as np

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
