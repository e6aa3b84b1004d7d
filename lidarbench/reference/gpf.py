"""Ground plane fitting, plain NumPy in float64.

A frozen copy of the GPF in the port's host oracle
(``lidar_processing_tpu_torch/oracle/reference.py``), which follows the
reference's Zermas-style segmentation (ref: src/segmentation.cpp:62-345)
with its quirks: an integer-division split into x-sorted partitions that
leaves up to (partitions - 1) trailing points UNKNOWN, a seed cutoff scan
that yields an empty seed set when no point lies above the threshold,
and a SIGNED plane distance in the ground test. The plane normal points
upward (n_z >= 0). Every accumulation is float64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

SEG_UNKNOWN, SEG_GROUND, SEG_OBSTACLE = 0, 1, 2


def _plane(g: np.ndarray) -> Optional[Tuple[np.ndarray, float]]:
    """Least-squares plane through g (m, 3): (unit normal, d)."""
    if g.shape[0] < 3:
        return None
    g64 = g.astype(np.float64)
    centroid = g64.mean(axis=0)
    centered = g64 - centroid
    cov = centered.T @ centered / (g.shape[0] - 1)
    if not np.all(np.isfinite(cov)):
        return None
    _, v = np.linalg.eigh(cov)
    normal = v[:, 0]
    if normal[2] < 0.0:
        normal = -normal
    elif normal[2] == 0.0:
        k = int(np.argmax(np.abs(normal)))
        if normal[k] < 0.0:
            normal = -normal
    return normal, float(normal @ centroid)


def _seeds(z: np.ndarray, cfg) -> np.ndarray:
    order = np.argsort(z, kind="stable")
    zs = z[order].astype(np.float64)
    above = zs > -cfg["z_min_outlier_scale"] * cfg["sensor_height_m"]
    start = int(np.argmax(above)) if above.any() else 0
    order, zs = order[start:], zs[start:]
    if order.size == 0:
        return order
    k = min(cfg["number_of_lower_point_representatives"], order.size)
    above2 = zs > float(zs[:k].mean()) + cfg["initial_seed_threshold"]
    cut = int(np.argmax(above2)) if above2.any() else 0
    return order[:cut]


def _fit(pts: np.ndarray, cfg) -> np.ndarray:
    m = pts.shape[0]
    labels = np.full(m, SEG_UNKNOWN, np.int32)
    if m < 3:
        return labels
    ground = np.zeros(m, bool)
    ground[_seeds(pts[:, 2], cfg)] = True
    pts64 = pts.astype(np.float64)
    for _ in range(cfg["number_of_iterations"]):
        plane = _plane(pts[ground]) if int(ground.sum()) >= 3 else None
        if plane is None:
            labels[:] = SEG_OBSTACLE
            return labels
        normal, d = plane
        thr = cfg["orthogonal_distance_threshold"] * float(
            np.linalg.norm(normal))
        ground = pts64 @ normal - d < thr
    labels[:] = np.where(ground, SEG_GROUND, SEG_OBSTACLE)
    return labels


def segment(xyz: np.ndarray, cfg) -> np.ndarray:
    """(n,) labels in {UNKNOWN 0, GROUND 1, OBSTACLE 2} of an (n, 3)
    cloud; cfg holds SegmentationConfig's fields by name."""
    n = xyz.shape[0]
    labels = np.full(n, SEG_UNKNOWN, np.int32)
    if n == 0:
        return labels
    order = np.argsort(xyz[:, 0], kind="stable")
    parts = cfg["number_of_planar_partitions"]
    per = n // parts
    for s in range(parts):
        idx = order[s * per:(s + 1) * per]
        labels[idx] = _fit(xyz[idx], cfg)
    return labels
