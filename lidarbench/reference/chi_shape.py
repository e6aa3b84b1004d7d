"""The chi-shape of a cluster's points, plain NumPy over scipy's Delaunay.

The outline a cluster should get (ref: src/polygon_simplification.cpp:
98-138): below ``small_cluster_size`` points its convex hull, from there
on the chi-shape of Duckham et al. (2008) with parameter ``chi``. The
chi-shape starts from the Delaunay triangulation of the points and
takes triangles off its boundary, longest boundary edge first, while
that edge is longer than l_min + chi * (l_max - l_min) over the
triangulation's edge lengths and the vertex it would expose is not on
the boundary yet (the regularity rule, which keeps the shape one simple
polygon).

The shape is returned as its triangulation and the triangles it keeps;
an outline is compared with it by area (``area_gap``): each triangle of
the triangulation lies inside the outline or outside it, judged by its
centroid, and what the outline covers that the shape does not, and the
other way round, is summed. Where the outline's edges are edges of the
same triangulation that area is exact; where rounding of the outline's
points flips a near-cocircular pair of triangles, one triangle is
misjudged at most.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple, Tuple

import numpy as np

from . import geometry


class Shape(NamedTuple):
    pts: np.ndarray          # (m, 2) float64
    tris: np.ndarray         # (T, 3) vertex indices of the triangulation
    kept: np.ndarray         # (T,) bool: triangles of the shape


def _triangulate(pts: np.ndarray) -> np.ndarray:
    """Delaunay triangles of (m, 2) points; (0, 3) where they span no
    area (fewer than 3 distinct points, or all on one line)."""
    from scipy.spatial import Delaunay, QhullError
    if pts.shape[0] < 3:
        return np.zeros((0, 3), np.int64)
    try:
        return Delaunay(pts).simplices.astype(np.int64)
    except QhullError:
        return np.zeros((0, 3), np.int64)


def shape(xy: np.ndarray, chi: float, small_cluster_size: int) -> Shape:
    """The outline's shape for a cluster's (m, 2) points."""
    pts = np.asarray(xy, np.float64)
    tris = _triangulate(pts)
    kept = np.ones(tris.shape[0], bool)
    if pts.shape[0] < small_cluster_size or tris.shape[0] == 0:
        return Shape(pts, tris, kept)        # the convex hull
    T = tris.shape[0]
    # every directed edge (t, k): v[k] -> v[k+1]; its undirected key
    a = tris
    b = np.roll(tris, -1, 1)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = (lo * pts.shape[0] + hi).ravel()
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    ulen = np.hypot(*(pts[uniq // pts.shape[0]]
                      - pts[uniq % pts.shape[0]]).T)
    thresh = ulen.min() + chi * (ulen.max() - ulen.min())
    # the triangle across each directed edge (-1 on the hull)
    order = np.argsort(inv, kind="stable")
    across = np.full(3 * T, -1, np.int64)
    starts = np.concatenate([[0], np.cumsum(cnt)])
    first = order[starts[:-1][cnt == 2]]
    second = order[starts[:-1][cnt == 2] + 1]
    across[first] = second // 3
    across[second] = first // 3
    elen = ulen[inv]                          # (3T,) by directed edge
    bdeg = np.zeros(pts.shape[0], np.int64)
    heap = []
    for e in np.flatnonzero(across < 0):
        t, k = divmod(int(e), 3)
        bdeg[tris[t, k]] += 1
        bdeg[tris[t, (k + 1) % 3]] += 1
        heap.append((-float(elen[e]), int(e)))
    heapq.heapify(heap)
    while heap:
        neg, e = heapq.heappop(heap)
        t, k = divmod(e, 3)
        if not kept[t]:
            continue
        if -neg <= thresh:
            break
        opp = int(tris[t, (k + 2) % 3])
        if bdeg[opp] > 0:
            continue
        kept[t] = False
        bdeg[opp] += 2
        for kk in ((k + 1) % 3, (k + 2) % 3):
            nb = int(across[3 * t + kk])
            # the edge seen from the neighbour's side is now on the boundary
            for k2 in range(3):
                if across[3 * nb + k2] == t:
                    heapq.heappush(heap, (-float(elen[3 * nb + k2]),
                                          3 * nb + k2))
                    break
    return Shape(pts, tris, kept)


def _tri_areas(pts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    p, q, r = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    return 0.5 * np.abs((q[:, 0] - p[:, 0]) * (r[:, 1] - p[:, 1])
                        - (q[:, 1] - p[:, 1]) * (r[:, 0] - p[:, 0]))


def area_gap(outline: np.ndarray, ref: Shape) -> Tuple[float, float]:
    """(area inside one of the outline and the shape but not the other,
    the shape's area), in m²."""
    if ref.tris.shape[0] == 0:
        return 0.0, 0.0
    areas = _tri_areas(ref.pts, ref.tris)
    cent = ref.pts[ref.tris].mean(1)
    inside = geometry.inside(np.asarray(outline, np.float64).reshape(-1, 2),
                             cent)
    gap = areas[inside != ref.kept].sum()
    return float(gap), float(areas[ref.kept].sum())
