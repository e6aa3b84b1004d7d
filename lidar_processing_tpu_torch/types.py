"""Core tensor types of the PyTorch port.

Mirrors ``lidar_processing_tpu/types.py``: the same label conventions
(bit-for-bit the reference's) and NamedTuples of tensors in place of JAX
pytrees. The shapes below are one frame's; a batched result (the JAX
package's vmap, written out) has a leading frame axis B on every leaf.

  segmentation: UNKNOWN=0, GROUND=1, OBSTACLE=2
                (ref: src/segmentation.hpp:41-46)
  clustering:   UNDEFINED=INT32_MIN, INVALID=-1, clusters 0..L-1
                (ref: src/clustering.hpp:53-54)
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

SEG_UNKNOWN = 0
SEG_GROUND = 1
SEG_OBSTACLE = 2

CLUSTER_UNDEFINED = -(2 ** 31)
CLUSTER_INVALID = -1


class Plane(NamedTuple):
    """Plane a*x + b*y + c*z = d (ref: src/segmentation.hpp:90-102)."""

    normal: torch.Tensor  # (..., 3) f32
    d: torch.Tensor       # (...,) f32


class SegmentationResult(NamedTuple):
    """Per-point segmentation labels plus fitted planes per partition."""

    labels: torch.Tensor       # (N,) int32 in {UNKNOWN, GROUND, OBSTACLE}
    planes: Plane              # (P, 3) normals, (P,) offsets
    plane_valid: torch.Tensor  # (P,) bool — False => all-obstacle fallback


class ClusteringResult(NamedTuple):
    """Per-point cluster labels (contract of the JAX ClusteringResult).

    labels: (N,) int32 — CLUSTER_INVALID for too-small/too-large clusters,
            CLUSTER_UNDEFINED for padded entries, else compact ids 0..L-1
            ordered by each cluster's minimum point index.
    num_clusters: () int32
    overflow: () int32 — static-capacity violations; nonzero means the
            neighbor graph may be missing edges.
    """

    labels: torch.Tensor
    num_clusters: torch.Tensor
    overflow: torch.Tensor


class PolygonBatch(NamedTuple):
    """Padded batch of 2-D polygons (cluster outlines).

    vertices: (C, V, 2) float32 — ordered CCW, closed implicitly.
    counts:   (C,)      int32   — vertices used per polygon; 0 => empty slot.
    """

    vertices: torch.Tensor
    counts: torch.Tensor


def map_leaves(fn, tree: Any) -> Any:
    """fn applied to every tensor leaf, recursing through NamedTuples,
    tuples and dicts (other leaves, such as None, as they are)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(map_leaves(fn, v) for v in tree)
    return tree


def frame_of(tree: Any, b: int) -> Any:
    """Frame b of a batched result: row b of every tensor leaf. A
    per-frame entry point is its batched body at B = 1, then
    ``frame_of(result, 0)``."""
    return map_leaves(lambda t: t[b], tree)
