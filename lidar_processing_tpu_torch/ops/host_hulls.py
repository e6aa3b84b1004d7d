"""Host outline hulls: jax-free copies of the JAX package's host path.

The port's host stage needs the large-cluster outline code the JAX
package runs when its native module is not built:

  * ``convex_hull_indices`` and ``chi_concave_hull_indices``, copied from
    ``lidar_processing_tpu/oracle/reference.py`` (Andrew monotone chain;
    Duckham et al. chi-shape over a scipy Delaunay triangulation);
  * ``chi_concave_hull``, the fallback chain of
    ``lidar_processing_tpu/ops/hull_native.py::chi_concave_hull``.

They are copies because the JAX package's modules pull jax in on import
(``__init__`` -> ``types`` -> ``jax.numpy``) and the GPU machine has no
jax. tests/test_torch_hull.py holds each copy against its original.
Building ``native/lidar_native.cpp`` for the port is later work.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np


def convex_hull_indices(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain, CCW, strictly convex; returns indices.

    Behavioral equivalent of the reference's Convex-Hull submodule call
    (ref: src/polygon_simplification.cpp:107-108).
    """
    m = points.shape[0]
    if m == 0:
        return np.zeros((0,), np.int64)
    if m == 1:
        return np.zeros((1,), np.int64)
    pts = points.astype(np.float64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))

    def cross(o, a, b):
        return ((pts[a, 0] - pts[o, 0]) * (pts[b, 1] - pts[o, 1])
                - (pts[a, 1] - pts[o, 1]) * (pts[b, 0] - pts[o, 0]))

    lower: List[int] = []
    for p in order:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(int(p))
    upper: List[int] = []
    for p in order[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(int(p))
    hull = lower[:-1] + upper[:-1]
    if not hull:  # all points identical
        hull = [int(order[0])]
    return np.asarray(hull, np.int64)


def chi_concave_hull_indices(points: np.ndarray, chi: float) -> np.ndarray:
    """Chi-shape concave hull (Duckham et al. 2008): Delaunay triangulation,
    then iterative longest-boundary-edge removal subject to the regularity
    constraint, with length threshold l = l_min + chi * (l_max - l_min) over
    the triangulation's edge lengths.

    Behavioral equivalent of the reference's Concave-Hull submodule call
    (ref: src/polygon_simplification.cpp:129-130). Returns boundary vertex
    indices in order.
    """
    import heapq

    from scipy.spatial import Delaunay, QhullError  # type: ignore

    m = points.shape[0]
    if m < 3:
        return np.arange(m, dtype=np.int64)
    pts = points.astype(np.float64)
    try:
        tri = Delaunay(pts)
    except QhullError:
        return convex_hull_indices(points)

    def elen(a: int, b: int) -> float:
        return float(np.hypot(*(pts[a] - pts[b])))

    # Edge -> set of adjacent triangles
    edge_tris: Dict[Tuple[int, int], List[int]] = collections.defaultdict(list)
    for t, simplex in enumerate(tri.simplices):
        for k in range(3):
            a, b = int(simplex[k]), int(simplex[(k + 1) % 3])
            edge_tris[(min(a, b), max(a, b))].append(t)

    all_lengths = [elen(a, b) for (a, b) in edge_tris]
    l_min, l_max = min(all_lengths), max(all_lengths)
    l_thresh = l_min + chi * (l_max - l_min)

    boundary_edges = {e for e, ts in edge_tris.items() if len(ts) == 1}
    boundary_vertices = collections.Counter()
    for a, b in boundary_edges:
        boundary_vertices[a] += 1
        boundary_vertices[b] += 1
    alive_tri = np.ones(len(tri.simplices), bool)

    heap = [(-elen(a, b), (a, b)) for (a, b) in boundary_edges]
    heapq.heapify(heap)
    while heap:
        neg_l, e = heapq.heappop(heap)
        if e not in boundary_edges:
            continue
        if -neg_l <= l_thresh:
            break  # longest remaining edge within threshold: done
        ts = [t for t in edge_tris[e] if alive_tri[t]]
        if len(ts) != 1:
            continue
        t = ts[0]
        simplex = [int(v) for v in tri.simplices[t]]
        opposite = next(v for v in simplex if v not in e)
        # regularity: the exposed vertex must not already be on the boundary
        if boundary_vertices[opposite] > 0:
            continue
        a, b = e
        boundary_edges.discard(e)
        alive_tri[t] = False
        for v in (a, b):
            ne = (min(v, opposite), max(v, opposite))
            boundary_edges.add(ne)
            heapq.heappush(heap, (-elen(*ne), ne))
        boundary_vertices[opposite] += 2

    # Walk the boundary cycle in order
    adj: Dict[int, List[int]] = collections.defaultdict(list)
    for a, b in boundary_edges:
        adj[a].append(b)
        adj[b].append(a)
    start = min(adj)
    walk = [start]
    prev, cur = -1, start
    while True:
        nxts = [v for v in adj[cur] if v != prev]
        if not nxts:
            break
        nxt = nxts[0]
        if nxt == start:
            break
        walk.append(nxt)
        prev, cur = cur, nxt
        if len(walk) > 2 * len(boundary_edges):
            break  # safety: malformed boundary
    # orient CCW via the shoelace sign
    poly = pts[walk]
    area2 = float(np.sum(poly[:, 0] * np.roll(poly[:, 1], -1)
                         - np.roll(poly[:, 0], -1) * poly[:, 1]))
    if area2 < 0:
        walk = walk[::-1]
    return np.asarray(walk, np.int64)


def chi_concave_hull(points: np.ndarray, chi: float) -> np.ndarray:
    """Ordered chi-shape outline vertices (k,2) float32."""
    pts = np.ascontiguousarray(points[:, :2], np.float32)
    if pts.shape[0] < 3:
        return pts[convex_hull_indices(pts)].astype(np.float32)
    idx = chi_concave_hull_indices(pts, chi)
    return pts[idx].astype(np.float32)
