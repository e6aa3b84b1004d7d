"""The scipy/Python chi-shape chain: the plain reference of the host stage.

``chi_concave_hull`` is the fallback chain of
``lidar_processing_tpu/ops/hull_native.py::chi_concave_hull`` without its
native call: fewer than 3 points take the monotone-chain convex hull, the
rest the Duckham et al. chi-shape over a scipy Delaunay triangulation
(both from ``oracle/reference.py``). The main path runs the native module
(``ops/hull_native.py``); this chain is what the native call falls back
to on a degenerate input, and the reference the tests and chip_smoke.py
hold the native outlines against.
"""

from __future__ import annotations

import numpy as np

from ..oracle.reference import chi_concave_hull_indices, convex_hull_indices

__all__ = ["chi_concave_hull", "chi_concave_hull_indices",
           "convex_hull_indices"]


def chi_concave_hull(points: np.ndarray, chi: float) -> np.ndarray:
    """Ordered chi-shape outline vertices (k,2) float32."""
    pts = np.ascontiguousarray(points[:, :2], np.float32)
    if pts.shape[0] < 3:
        return pts[convex_hull_indices(pts)].astype(np.float32)
    idx = chi_concave_hull_indices(pts, chi)
    return pts[idx].astype(np.float32)
