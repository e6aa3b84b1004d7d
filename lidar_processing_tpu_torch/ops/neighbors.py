"""Batched neighbour search: the reference KD-tree's API as dense tiles.

Port of ``lidar_processing_tpu/ops/neighbors.py``. The reference exposes
a 3-D KD-tree with ``rebuild``, ``k_nearest`` and ``radius_search``
(ref: src/kdtree.hpp:41-136, :174-225 build, :227-290 k-NN, :292-341
radius search). Here, as in the JAX package, the "index" is the padded
point buffer itself: queries are answered in bulk, each tile of points is
scored against every query at once, and a running top-k merge keeps the
results bounded, so ``rebuild`` keeps the buffer and queries are one pass
over the points, on the tensors' device.

Semantics are the JAX package's, bit for bit:
  * ``k_nearest`` returns the k smallest-d² points ascending by d², ties
    to the lower point index (a stable sort of [best, tile] per merge);
  * ``radius_search`` returns every point with d² <= r² up to a static
    capacity, ascending by d² or, unsorted, in point-index order, with the
    TRUE count per query and the total dropped to the capacity;
  * absent results are +inf distances and -1 indices; masked (padding)
    points never appear.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..tools._common import resolve_device
from .scan_utils import sum_sq3

_I32 = torch.int32
_F_INF = float("inf")


class KNNResult(NamedTuple):
    """k nearest neighbours per query, ascending by squared distance."""

    indices: torch.Tensor    # (Q, k) int32; -1 where fewer than k valid
    distances: torch.Tensor  # (Q, k) f32 squared distances; +inf where absent


class RadiusResult(NamedTuple):
    """All neighbours with d² <= r² per query, up to a static capacity."""

    indices: torch.Tensor    # (Q, cap) int32; -1 past each query's count
    distances: torch.Tensor  # (Q, cap) f32 squared distances; +inf past it
    counts: torch.Tensor     # (Q,) int32 TRUE neighbour counts (may exceed cap)
    overflow: torch.Tensor   # () int32: total results dropped to capacity


def _pairwise_d2(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(Q, P) exact squared distances by direct difference (no ‖q‖² +
    ‖p‖² − 2q·p expansion: its cancellation would break distance ties
    differently). The squares accumulate as XLA compiles the JAX
    package's ``jnp.sum(d * d, -1)`` (``sum_sq3``)."""
    return sum_sq3(*(queries[:, None, a] - points[None, :, a]
                     for a in range(3)))


def _valid(points: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
    return mask


def k_nearest(points: torch.Tensor, queries: torch.Tensor, k: int,
              mask: Optional[torch.Tensor] = None,
              tile: int = 8192) -> KNNResult:
    """Batched exact k-NN over a (possibly padded) point set.

    points (P, 3) f32, queries (Q, 3) f32, mask (P,) bool validity (None:
    all valid). Tiles of `tile` points are scored per pass and merged into
    a running per-query top-k, so peak memory is O(Q * (tile + k))
    whatever P is.
    """
    p_n, q_n = points.shape[0], queries.shape[0]
    dev = points.device
    valid = _valid(points, mask)
    best_d = torch.full((q_n, k), _F_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((q_n, k), -1, dtype=_I32, device=dev)
    tile = min(tile, p_n)
    for start in range(0, p_n, tile):
        stop = min(start + tile, p_n)
        d2 = torch.where(valid[None, start:stop],
                         _pairwise_d2(queries, points[start:stop]), _F_INF)
        idx = torch.arange(start, stop, dtype=_I32, device=dev)
        cat_d = torch.cat([best_d, d2], 1)
        cat_i = torch.cat([best_i, idx.expand(q_n, -1)], 1)
        # ascending d², ties to the lowest point index: the running best
        # precede the tile, and a stable sort keeps that order
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d = cat_d.gather(1, order)
        best_i = cat_i.gather(1, order)
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return KNNResult(best_i, best_d)


def radius_search(points: torch.Tensor, queries: torch.Tensor,
                  radius_squared: float, capacity: int,
                  mask: Optional[torch.Tensor] = None,
                  sort_results: bool = True,
                  tile: int = 8192) -> RadiusResult:
    """Batched exact fixed-radius search over a (possibly padded) point
    set: up to `capacity` hits per query (the reference's dynamically
    sized result vector becomes a static buffer + true count + overflow,
    ref: src/kdtree.hpp:292-341), ascending by d² (ties by index) with
    sort_results, else in point-index order."""
    r2 = torch.full((), radius_squared, dtype=torch.float32,
                    device=points.device)
    knn = k_nearest(points, queries, capacity, mask=mask, tile=tile)
    in_r = knn.distances <= r2
    if not sort_results:
        # the k-NN merge is ascending in d²; a stable sort by index
        # (misses last) gives point-index order
        order = torch.sort(torch.where(in_r, knn.indices, 2 ** 31 - 1),
                           dim=1, stable=True).indices
        knn = KNNResult(knn.indices.gather(1, order),
                        knn.distances.gather(1, order))
        in_r = knn.distances <= r2
    indices = torch.where(in_r, knn.indices, -1)
    distances = torch.where(in_r, knn.distances, _F_INF)

    # true counts: one more masked pass over every tile
    p_n = points.shape[0]
    valid = _valid(points, mask)
    counts = torch.zeros(queries.shape[0], dtype=_I32, device=points.device)
    t = min(tile, p_n)
    for start in range(0, p_n, t):
        stop = min(start + t, p_n)
        hit = ((_pairwise_d2(queries, points[start:stop]) <= r2)
               & valid[None, start:stop])
        counts = counts + hit.sum(1, dtype=_I32)
    overflow = torch.clamp(counts - capacity, min=0).sum(dtype=_I32)
    return RadiusResult(indices, distances, counts, overflow)


class NeighborIndex:
    """Object-style wrapper mirroring the reference KDTree API.

    ``rebuild`` keeps the (padded) point buffer: the dense buffer is the
    index. A tensor stays on its device; other points go to the card (it
    raises without one), and other queries and masks to the points'
    device.
    """

    def __init__(self, points=None, mask=None):
        self._points = None
        self._mask = None
        if points is not None:
            self.rebuild(points, mask)

    def _tensor(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(dtype)
        dev = (self._points.device if self._points is not None
               else resolve_device())
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def rebuild(self, points, mask=None) -> None:
        self._points = None
        self._points = self._tensor(points, torch.float32)
        self._mask = None if mask is None else self._tensor(mask, torch.bool)

    def _queries(self, queries) -> torch.Tensor:
        if self._points is None:
            raise ValueError("rebuild() must be called before queries")
        return torch.atleast_2d(self._tensor(queries, torch.float32))

    def k_nearest(self, queries, k: int) -> KNNResult:
        return k_nearest(self._points, self._queries(queries), k,
                         mask=self._mask)

    def radius_search(self, queries, radius_squared: float,
                      capacity: int = 256,
                      sort_results: bool = True) -> RadiusResult:
        return radius_search(self._points, self._queries(queries),
                             radius_squared, capacity, mask=self._mask,
                             sort_results=sort_results)
