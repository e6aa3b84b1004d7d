"""Host hull and graph operations through the native C++ module.

Port of ``lidar_processing_tpu/ops/hull_native.py``: the same functions
over the same C entry points (``native/lidar_native.cpp``, built by
``native/_build.py`` at first use). Unlike the JAX package, which drops to
its scipy/Python oracles whenever its library is absent, the port has no
fallback for a missing module: a failed build or a missing entry point
raises. The fallbacks kept are the JAX module's per-input ones:

  * ``chi_hulls_batch``: a degenerate cluster (count < 0) goes through
    the single-cluster chain, ``chi_concave_hull``;
  * ``chi_concave_hull``: fewer than 3 points, or a negative count from
    the native call, goes to the scipy oracle chain
    (``ops/host_hulls.py::chi_concave_hull``).

``chi_hulls_batch.calls`` counts the batched native calls and
``chi_hulls_batch.fallbacks`` the clusters it sent down the single chain,
as the CUDA kernel wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..native._build import library
from .host_hulls import chi_concave_hull as _oracle_chain

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def native_available() -> bool:
    """True once the module is built and loaded. There is nothing to fall
    back to, so a failed build or a missing entry point raises (with g++'s
    log) rather than returning False."""
    library()
    return True


def convex_hull_indices(points: np.ndarray,
                        algorithm: str = "monotone") -> np.ndarray:
    """CCW strictly-convex hull indices.

    algorithm: "monotone" (Andrew chain) or "chan" (Chan's grouped march —
    the reference routes >1000-point clusters to Chan,
    ref: src/polygon_simplification.cpp:53-63). Both give the same hull.
    """
    lib = library()
    pts = np.ascontiguousarray(points[:, :2], np.float32)
    n = pts.shape[0]
    out = np.empty(n + 1, np.int32)
    fn = lib.chan_convex_hull if algorithm == "chan" else lib.convex_hull
    k = fn(_ptr(pts, _FP), n, _ptr(out, _IP), out.shape[0])
    if k < 0:
        raise RuntimeError(f"{fn.__name__}: hull of {n} points exceeds its "
                           f"{out.shape[0]}-slot buffer")
    return out[:k].astype(np.int64)


def union_find_cc(edges_u: np.ndarray, edges_v: np.ndarray,
                  n_nodes: int) -> np.ndarray:
    """Connected-component labels (min node id per component) over edges."""
    u = np.ascontiguousarray(edges_u, np.int32)
    v = np.ascontiguousarray(edges_v, np.int32)
    # the C loop indexes its parent array with every id unchecked
    if u.shape != v.shape or (u.size and not (
            0 <= min(u.min(), v.min()) and max(u.max(), v.max()) < n_nodes)):
        raise ValueError(f"union_find_cc: edges {u.shape}/{v.shape} must "
                         f"pair up and lie in [0, {n_nodes})")
    out = np.empty(n_nodes, np.int32)
    library().union_find_cc(_ptr(u, _IP), _ptr(v, _IP), np.int64(u.size),
                            np.int32(n_nodes), _ptr(out, _IP))
    return out


def fec_cluster(points: np.ndarray, distance_squared: float,
                cluster_quality: float, min_size: int,
                max_size: int) -> np.ndarray:
    """Faithful serial FEC (ref: src/clustering.cpp:47-125), bit-identical
    to oracle.reference.fec_cluster(..., allow_native=False)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = pts.shape[0]
    out = np.empty(n, np.int32)
    library().fec_cluster(
        _ptr(pts, _FP), np.int32(n), ctypes.c_double(distance_squared),
        ctypes.c_double(cluster_quality), ctypes.c_uint32(min_size),
        ctypes.c_uint32(min(max_size, 2**32 - 1)), _ptr(out, _IP))
    return out


def radius_cc(points: np.ndarray, radius: float) -> np.ndarray:
    """Exact radius-graph CC labels (min point index per component)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = pts.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    out = np.empty(n, np.int32)
    library().radius_cc(_ptr(pts, _FP), np.int32(n), np.float32(radius),
                        _ptr(out, _IP))
    return out


def chi_hulls_batch(packed_xy: np.ndarray, offsets: np.ndarray, chi: float):
    """Ordered chi-shape outlines of many clusters in ONE native call (its
    own thread pool, one worker per host core; pass clusters largest-first).

    packed_xy: (P, 2) f32 concatenated cluster points; offsets: (m+1,)
    int64 point offsets. Returns a list of (k_j, 2) f32 outline vertices.
    """
    m = offsets.shape[0] - 1
    if m == 0:
        return []
    lib = library()
    pts = np.ascontiguousarray(packed_xy, np.float32)
    offs = np.ascontiguousarray(offsets, np.int64)
    # the C workers read pts[offs[j]:offs[j+1]] unchecked
    if (pts.ndim != 2 or pts.shape[1] != 2 or offs[0] != 0
            or offs[-1] != pts.shape[0] or np.any(np.diff(offs) < 0)):
        raise ValueError(f"chi_hulls_batch: points {pts.shape} and offsets "
                         f"from {offs[0]} to {offs[-1]} do not match")
    out = np.empty(pts.shape[0], np.int32)
    counts = np.empty(m, np.int32)
    lib.chi_hulls_batch(_ptr(pts, _FP),
                        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        np.int32(m), ctypes.c_double(chi), _ptr(out, _IP),
                        _ptr(counts, _IP), np.int32(os.cpu_count() or 1))
    chi_hulls_batch.calls += 1
    res = []
    for j in range(m):
        lo, hi = int(offs[j]), int(offs[j + 1])
        k = int(counts[j])
        if k < 0:
            # degenerate cluster: the single-cluster chain
            chi_hulls_batch.fallbacks += 1
            res.append(chi_concave_hull(pts[lo:hi], chi))
        else:
            res.append(pts[lo:hi][out[lo:lo + k]])
    return res


chi_hulls_batch.calls = 0
chi_hulls_batch.fallbacks = 0


def chi_concave_hull(points: np.ndarray, chi: float) -> np.ndarray:
    """Ordered chi-shape outline vertices (k, 2) float32."""
    pts = np.ascontiguousarray(points[:, :2], np.float32)
    n = pts.shape[0]
    if n >= 3:
        out = np.empty(n + 1, np.int32)
        k = library().chi_concave_hull(_ptr(pts, _FP), n,
                                       ctypes.c_double(chi), _ptr(out, _IP),
                                       out.shape[0])
        if k >= 0:
            return pts[out[:k]].astype(np.float32)
    # fewer than 3 points, or a degenerate input the native call refused
    return _oracle_chain(pts, chi)
