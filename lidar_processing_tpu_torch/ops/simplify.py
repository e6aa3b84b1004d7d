"""Polygon vertex-count simplification (Visvalingam-Whyatt).

Realizes the reference's planned ``max_polygon_points`` cap
(ref: src/polygonization.hpp:56 ``max_polygon_points{300U}`` — dead code
there; live here): outlines with more vertices than the cap are decimated
by repeatedly removing the vertex whose removal loses the least area
(Visvalingam-Whyatt effective-area criterion), preserving overall shape
far better than uniform subsampling for the ring polygons this pipeline
emits.

A copy of ``lidar_processing_tpu/ops/simplify.py`` (jax-free import path
for the port; tests/test_torch_hull.py holds it against the original).

Host-side: outlines are tiny (<= a few hundred vertices) and irregular;
this is readout post-processing, not device compute.
"""

from __future__ import annotations

import heapq

import numpy as np


def _tri_area2(p: np.ndarray, q: np.ndarray, r: np.ndarray) -> float:
    """Twice the triangle area |pqr| (doubled area avoids a 0.5 mult)."""
    return abs((q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0]))


def simplify_ring(vertices: np.ndarray, max_points: int) -> np.ndarray:
    """Decimate a closed-ring polygon to at most ``max_points`` vertices.

    vertices: (n, 2) float array of ring vertices (first vertex NOT
    repeated at the end). Returns a (m, 2) array, m <= max_points, in the
    original vertex order. Rings already under the cap (or with fewer than
    4 vertices) are returned unchanged.
    """
    n = len(vertices)
    if n <= max_points or n < 4 or max_points < 3:
        return vertices
    v = np.asarray(vertices, dtype=np.float64)
    prev = np.arange(-1, n - 1)
    prev[0] = n - 1
    nxt = np.arange(1, n + 1)
    nxt[-1] = 0
    alive = np.ones(n, dtype=bool)
    # lazy-deletion heap of (effective_area, version, index)
    version = np.zeros(n, dtype=np.int64)
    heap = [( _tri_area2(v[prev[i]], v[i], v[nxt[i]]), 0, i)
            for i in range(n)]
    heapq.heapify(heap)
    remaining = n
    while remaining > max_points and heap:
        area, ver, i = heapq.heappop(heap)
        if not alive[i] or ver != version[i]:
            continue
        alive[i] = False
        remaining -= 1
        p, q = prev[i], nxt[i]
        nxt[p], prev[q] = q, p
        for j in (p, q):
            version[j] += 1
            heapq.heappush(
                heap,
                (_tri_area2(v[prev[j]], v[j], v[nxt[j]]), version[j], j))
    return np.asarray(vertices)[alive]
