"""Exact connected components of the radius graph, plain PyTorch.

Two points are joined when the exact squared distance between their
float32 coordinates is at most R², the configured ``distance_squared``
as float32: the differences and squares are taken in float64, where the
squares of float32 differences are exact and their sum rounds once, in
the 53rd bit, far below float32's rounding. The program rounds its d² in
float32 (a fused multiply-add chain), so a pair within about one float32
ulp of R² (1.5e-8 m² at 0.18) may be decided the other way there; the
reference's verdict is the exact one.

Candidate pairs come from a uniform grid of cell size R, each cell
against itself and its 13 forward neighbours, in blocks of at most
``block_pairs`` pairs; each block's edges are merged by hooking the
larger root under the smaller and compressing paths until every edge has
one root. Components of fewer than ``min_cluster_size`` points (or more
than ``max_cluster_size``) are not clusters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]
_SHIFT = 21                      # bits a cell coordinate takes in a key
_BIAS = 1 << (_SHIFT - 1)


def _compress(parent: torch.Tensor) -> torch.Tensor:
    while True:
        up = parent[parent]
        if torch.equal(up, parent):
            return parent
        parent = up


def _union(parent: torch.Tensor, i: torch.Tensor,
           j: torch.Tensor) -> torch.Tensor:
    """parent (fully compressed) after joining each pair (i, j)."""
    while i.numel():
        ri, rj = parent[i], parent[j]
        split = ri != rj
        if not bool(split.any()):
            break
        i, j, ri, rj = i[split], j[split], ri[split], rj[split]
        parent = parent.scatter_reduce(0, torch.maximum(ri, rj),
                                       torch.minimum(ri, rj), "amin")
        parent = _compress(parent)
    return parent


def components(xyz: np.ndarray, r2: float, device="cpu",
               block_pairs: int = 1 << 24) -> np.ndarray:
    """(n,) int64 root of each point's component: its smallest point
    index. xyz (n, 3) float32; r2 the threshold on the exact d²."""
    n = xyz.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    pts = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    p64 = pts.double()
    r = math.sqrt(r2)
    cell = torch.floor(p64 / r).long() + _BIAS
    key = (cell[:, 0] << (2 * _SHIFT)) | (cell[:, 1] << _SHIFT) | cell[:, 2]
    key_s, order = torch.sort(key, stable=True)
    ukey, counts = torch.unique_consecutive(key_s, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    ps = p64[order]
    parent = torch.arange(n, device=device)
    r2_t = torch.tensor(r2, dtype=torch.float64, device=device)

    def pairs_of(a_start, a_cnt, b_start, b_cnt, same):
        tot = a_cnt * b_cnt
        keep = tot > 0
        a_start, a_cnt, b_start, b_cnt, tot = (
            a_start[keep], a_cnt[keep], b_start[keep], b_cnt[keep], tot[keep])
        cum = torch.cumsum(tot, 0)
        lo = 0
        while lo < tot.numel():
            base = int(cum[lo - 1]) if lo else 0
            hi = int(torch.searchsorted(cum, base + block_pairs, right=True))
            hi = max(hi, lo + 1)
            sel = slice(lo, hi)
            t = tot[sel]
            g = torch.repeat_interleave(torch.arange(t.numel(), device=device),
                                        t)
            local = torch.arange(int(t.sum()), device=device) - (
                torch.cumsum(t, 0) - t)[g]
            i = a_start[sel][g] + local // b_cnt[sel][g]
            j = b_start[sel][g] + local % b_cnt[sel][g]
            if same:
                m = i < j
                i, j = i[m], j[m]
            d = ps[i] - ps[j]
            d2 = (d * d).sum(1)
            m = d2 <= r2_t
            yield order[i[m]], order[j[m]]
            lo = hi

    for i, j in pairs_of(starts, counts, starts, counts, True):
        parent = _union(parent, i, j)
    for dx, dy, dz in _OFFSETS:
        nkey = ukey + ((dx << (2 * _SHIFT)) + (dy << _SHIFT) + dz)
        pos = torch.searchsorted(ukey, nkey).clamp(max=ukey.numel() - 1)
        hit = ukey[pos] == nkey
        for i, j in pairs_of(starts[hit], counts[hit], starts[pos[hit]],
                             counts[pos[hit]], False):
            parent = _union(parent, i, j)
    return parent.cpu().numpy()


def cluster_labels(xyz: np.ndarray, r2: float, min_size: int,
                   max_size: int, device="cpu") -> np.ndarray:
    """(n,) int32 cluster ids 0..L-1 (ordered by each cluster's smallest
    point index) and -1 for points of components outside
    [min_size, max_size]."""
    n = xyz.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    roots = components(xyz, r2, device)
    uniq, inv, cnt = np.unique(roots, return_inverse=True,
                               return_counts=True)
    ok = (cnt >= min_size) & (cnt <= max_size)
    ids = np.full(uniq.size, -1, np.int32)
    ids[ok] = np.arange(int(ok.sum()), dtype=np.int32)
    return ids[inv]
