"""Per-frame visualization exports: the reference's four topics as files.

The reference publishes ground/obstacle clouds recolored RGB(220,220,220)/
RGB(0,255,0) (ref: src/processor.cpp:152-163), a cluster-colorized cloud
(random RGB per cluster, ref: src/conversions.cpp:32-60), and polygon
outlines as closed magenta LINE_STRIP markers
(ref: src/conversions.hpp:72-120) for RViz. Here each frame exports:

    <dir>/frame_<k>_ground.ply      gray ground points
    <dir>/frame_<k>_obstacle.ply    green obstacle points
    <dir>/frame_<k>_clustered.ply   per-cluster colors
    <dir>/frame_<k>_polygons.json   closed outlines + cluster ids

PLY binary little-endian (viewable in MeshLab/CloudCompare/Open3D).
Cluster colors are a deterministic hash of the cluster id (the reference
uses std::rand() per cluster per frame; determinism is friendlier to
regression diffs and preserves the one-color-per-cluster contract).
A copy of ``lidar_processing_tpu/io/export.py`` on the port's ``types``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..types import SEG_GROUND, SEG_OBSTACLE

GROUND_RGB = (220, 220, 220)   # ref: src/processor.cpp:154
OBSTACLE_RGB = (0, 255, 0)     # ref: src/processor.cpp:159


def write_ply_xyzrgb(path: str, xyz: np.ndarray, rgb: np.ndarray,
                     intensity: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY with x/y/z float32 + r/g/b uchar.

    When ``intensity`` is given, each vertex also carries a float32
    ``intensity`` property — the input schema's fourth field carried
    through to the outputs (ref: src/dataloader.cpp:106-110).
    """
    n = xyz.shape[0]
    inten_prop = "property float intensity\n" if intensity is not None else ""
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"{inten_prop}end_header\n"
    )
    fields = [("xyz", "<f4", 3), ("rgb", "u1", 3)]
    if intensity is not None:
        fields.append(("intensity", "<f4"))
    rec = np.zeros(n, dtype=fields)
    rec["xyz"] = xyz.astype("<f4")
    rec["rgb"] = rgb.astype("u1")
    if intensity is not None:
        rec["intensity"] = np.asarray(intensity).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply_xyzrgb(path: str):
    """Read back a PLY written by write_ply_xyzrgb.

    Returns (xyz (n,3) f32, rgb (n,3) u8, intensity (n,) f32 or None).
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = next(int(l.split()[-1]) for l in header
             if l.startswith("element vertex"))
    has_inten = any(l == "property float intensity" for l in header)
    fields = [("xyz", "<f4", 3), ("rgb", "u1", 3)]
    if has_inten:
        fields.append(("intensity", "<f4"))
    rec = np.frombuffer(data[end:], dtype=fields, count=n)
    return (rec["xyz"].copy(), rec["rgb"].copy(),
            rec["intensity"].copy() if has_inten else None)


def cluster_colors(labels: np.ndarray) -> np.ndarray:
    """Deterministic bright RGB per cluster id (vectorized splitmix hash)."""
    h = labels.astype(np.uint32)
    for mult, shift in ((0x9E3779B9, 15), (0x85EBCA6B, 13), (0xC2B2AE35, 16)):
        h = (h * np.uint32(mult)) & np.uint32(0xFFFFFFFF)
        h ^= h >> np.uint32(shift)
    r = 64 + (h & 0xBF)
    g = 64 + ((h >> np.uint32(8)) & 0xBF)
    b = 64 + ((h >> np.uint32(16)) & 0xBF)
    return np.stack([r, g, b], axis=1).astype(np.uint8)


def export_frame(out_dir: str, frame_id: int, xyz: np.ndarray,
                 seg_labels: np.ndarray, cluster_labels: np.ndarray,
                 outlines: List[np.ndarray],
                 outline_cluster_ids: Optional[List[int]] = None,
                 outline_z_extents: Optional[List[tuple]] = None,
                 intensity: Optional[np.ndarray] = None) -> List[str]:
    """Write the four per-frame visualization artifacts; returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"frame_{frame_id:04d}"
    paths = []

    def _inten(mask):
        return intensity[mask] if intensity is not None else None

    ground = seg_labels == SEG_GROUND
    p = os.path.join(out_dir, f"{tag}_ground.ply")
    write_ply_xyzrgb(p, xyz[ground],
                     np.tile(GROUND_RGB, (int(ground.sum()), 1)),
                     intensity=_inten(ground))
    paths.append(p)

    obstacle = seg_labels == SEG_OBSTACLE
    p = os.path.join(out_dir, f"{tag}_obstacle.ply")
    write_ply_xyzrgb(p, xyz[obstacle],
                     np.tile(OBSTACLE_RGB, (int(obstacle.sum()), 1)),
                     intensity=_inten(obstacle))
    paths.append(p)

    clustered = cluster_labels >= 0
    p = os.path.join(out_dir, f"{tag}_clustered.ply")
    write_ply_xyzrgb(p, xyz[clustered],
                     cluster_colors(cluster_labels[clustered]),
                     intensity=_inten(clustered))
    paths.append(p)

    ids = (outline_cluster_ids if outline_cluster_ids is not None
           else list(range(len(outlines))))
    zex = (outline_z_extents if outline_z_extents is not None
           else [(0.0, 0.0)] * len(outlines))
    polys = [
        {"cluster_id": int(cid),
         # closed: repeat the first vertex, like the reference's markers
         # (ref: src/conversions.hpp:117)
         "vertices": np.concatenate([o, o[:1]]).tolist(),
         # 2.5-D extent (ref: src/polygonization.hpp:35-49 PointXYdZ)
         "z_min": float(ze[0]), "z_max": float(ze[1])}
        for cid, o, ze in zip(ids, outlines, zex) if len(o)
    ]
    p = os.path.join(out_dir, f"{tag}_polygons.json")
    with open(p, "w") as f:
        json.dump({"frame": frame_id, "polygons": polys}, f)
    paths.append(p)
    return paths
