"""Plane geometry for judging outlines, plain NumPy in float64."""

from __future__ import annotations

import numpy as np


def _segment_dist(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m, k) distances from points p (m, 2) to segments a[k]-b[k]."""
    ab = b - a
    ap = p[:, None, :] - a[None]
    den = (ab * ab).sum(-1)
    t = np.where(den > 0, (ap * ab[None]).sum(-1) / np.where(den > 0, den, 1),
                 0.0)
    t = np.clip(t, 0.0, 1.0)
    q = a[None] + t[..., None] * ab[None]
    return np.hypot(*(p[:, None, :] - q).transpose(2, 0, 1))


def vertex_gap(outline: np.ndarray, pts: np.ndarray) -> float:
    """Largest distance from a vertex of the outline to the nearest of
    the points (m): an outline is made of its cluster's points."""
    v = np.asarray(outline, np.float64)
    p = np.asarray(pts, np.float64)
    if v.shape[0] == 0:
        return 0.0
    if p.shape[0] == 0:
        return float("inf")
    d = np.hypot(*(v[:, None, :] - p[None]).transpose(2, 0, 1))
    return float(d.min(1).max())


def cover_gap(outline: np.ndarray, pts: np.ndarray) -> float:
    """Largest distance by which one of the points lies outside the
    closed outline (m; 0 when every point is inside or on it). An
    outline of one or two vertices is a point or a segment."""
    v = np.asarray(outline, np.float64)
    p = np.asarray(pts, np.float64)
    if p.shape[0] == 0:
        return 0.0
    if v.shape[0] == 0:
        return float("inf")
    dist = _segment_dist(p, v, np.roll(v, -1, 0)).min(1)
    return float(np.where(inside(v, p), 0.0, dist).max())


def inside(outline: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(m,) bool: which of the points lie inside the closed outline, by
    the even-odd rule; nothing lies inside fewer than 3 vertices."""
    v = np.asarray(outline, np.float64)
    p = np.asarray(pts, np.float64)
    if v.shape[0] < 3:
        return np.zeros(p.shape[0], bool)
    a, b = v, np.roll(v, -1, 0)
    ay, by = a[None, :, 1], b[None, :, 1]
    py, px = p[:, 1:2], p[:, 0:1]
    straddle = (ay > py) != (by > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_cross = a[None, :, 0] + (py - ay) * (b[None, :, 0] - a[None, :, 0]) \
            / (by - ay)
    return (np.count_nonzero(straddle & (px < x_cross), 1) % 2) == 1


def convex_hull(xy: np.ndarray) -> np.ndarray:
    """Counter-clockwise convex hull of (m, 2) points, Andrew's monotone
    chain; one vertex for coincident points."""
    pts = np.asarray(xy, np.float64)
    if pts.shape[0] <= 1:
        return pts.copy()
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order].tolist()

    def half(seq):
        out = []
        for q in seq:
            while len(out) >= 2:
                o, a = out[-2], out[-1]
                if ((a[0] - o[0]) * (q[1] - o[1])
                        - (a[1] - o[1]) * (q[0] - o[0])) > 0:
                    break
                out.pop()
            out.append(q)
        return out

    lower, upper = half(pts), half(pts[::-1])
    hull = lower[:-1] + upper[:-1]
    return np.asarray(hull if hull else [pts[0]])
