"""Spatially sharded FULL frame step: GPF and clustering over x-bands.

Port of ``lidar_processing_tpu/parallel/frame_spatial.py``. The
reference's GPF already partitions by x into number_of_planar_partitions
contiguous bands (ref: src/segmentation.cpp:104-149); the x-bands of the
spatial sharding are finer than those partitions, and each GPF fit
iteration becomes a distributed moment reduction:

  * prologue (every rank, on the whole cloud): partition membership by
    x-rank (with the reference's tail-drop quirk) and the initial seed
    mask, computed EXACTLY as the single-device ``gpf_segment``
    (ops/segmentation.py's sorts and ``_seed_runs``);
  * fit iterations (sharded): the single-device fit
    (``segmentation._fit_partition``) with each band a row. Each band's
    masked per-partition moment partials over ITS points are fixed-tree
    sums of elementwise products (``_tree_sum``: the same bits alone or in
    a batch, where a matmul or einsum picks its order by shape); the S
    partials are gathered and added in band order (``Mesh.sum_shards``),
    so every layout of ranks gives the same bits; every rank solves the
    same closed-form 3x3 eigenproblems and re-thresholds its own points.
    3 iterations, the reference's loop (ref: src/segmentation.cpp:247-309).

Labels match the single-device ``gpf_segment`` up to float32 summation
order in the moments (a few points at the 0.3 m threshold may flip).
Clustering then runs ``cluster_spatial`` on the sharded obstacle mask,
bit-identical to the single-device clustering of that mask, and the hull
stage runs unsharded on the reassembled labels.
"""

from __future__ import annotations

import math

import torch

from ..config import EngineConfig, SegmentationConfig, SpatialConfig
from ..ops.hull import label_runs
from ..ops.scan_utils import set_drop, sort_by
from ..ops.segmentation import _fit_partition, _partition_sort, _seed_runs
from ..runtime.pipeline import NUM_SLOTS, FrameResult, _hull_stage
from ..types import (Plane, SegmentationResult, SEG_OBSTACLE, SEG_UNKNOWN,
                     frame_of, map_leaves)
from .mesh import Mesh
from .spatial import _distribute, cluster_spatial

_I32 = torch.int32


def _gpf_prologue(xyz: torch.Tensor, mask: torch.Tensor,
                  cfg: SegmentationConfig):
    """Partition ids and seed mask of one cloud in ORIGINAL point order.

    The single-device sorts and seed selection (``_partition_sort``,
    ``_seed_runs``), so partition assignment and seeds are bit-identical
    to gpf_segment's; only the fit is distributed. Returns (seg_id (N,)
    i32, -1 outside every partition; seed (N,) bool).
    """
    num_p = cfg.number_of_planar_partitions
    sp, porig, per_seg, _ = _partition_sort(xyz[None], mask[None], num_p)
    seeds_sorted, seg_of_rank = _seed_runs(sp[..., 2], per_seg, num_p, cfg)
    # back to original order: (seg + 1, seed) packed into one value, ONE
    # unsort (seg_of_rank is -1 outside partitions -> 0)
    packed = (seg_of_rank[0] + 1) * 2 + seeds_sorted[0].to(_I32)
    _, packed_orig = sort_by(porig[0], packed)
    return packed_orig // 2 - 1, (packed_orig % 2) == 1


def _fit_bands(mesh: Mesh, axis: str, bx, bv, bseg, bseed,
               cfg: SegmentationConfig):
    """GPF iterations over this rank's K bands, moments summed over all S:
    the single-device fit with each band a row and every sum the sum over
    the bands in band order.

    bx (K, cap, 3), bv / bseg / bseed (K, cap). Returns (labels (K, cap),
    normals (P, 3), d (P,), plane_valid (P,)); the planes are the same on
    every rank.
    """
    in_part = bv & (bseg >= 0)
    pmask = ((bseg[:, None, :] == torch.arange(
        cfg.number_of_planar_partitions, dtype=_I32,
        device=bx.device)[:, None]) & in_part[:, None, :])   # (K, P, cap)
    labels, normals, ds, valid = _fit_partition(
        bx, pmask, pmask & bseed[:, None, :], cfg,
        total=lambda x: mesh.sum_shards(x, axis).expand(x.shape))
    return labels, normals[0], ds[0], valid[0]


def gpf_spatial(mesh: Mesh, xyz: torch.Tensor, mask: torch.Tensor,
                cfg: SegmentationConfig, scfg: SpatialConfig,
                clustering_radius: float, axis: str = "space"):
    """GPF ground segmentation of one padded cloud sharded over `axis`.

    Returns (SegmentationResult, overflow): overflow counts the points the
    x-band distribution dropped (the block_points cap); they come back
    SEG_UNKNOWN, and by the package's contract that is never silent.
    """
    dev = mesh.device
    xyz, mask = xyz.to(dev), mask.to(dev)
    n = xyz.shape[0]
    s = mesh.shape[axis]
    seg_id, seed = _gpf_prologue(xyz, mask, cfg)
    bx, bo, bv, _, _, ovf_d = _distribute(
        xyz[None], mask[None], s, scfg.block_points,
        float(clustering_radius))
    # partition id and seed ride into band layout through the orig index
    slot_orig = torch.where(bo[0] >= 0, bo[0], n).long()     # (S, cap)
    bseg = torch.cat([seg_id, seg_id.new_full((1,), -1)])[slot_orig]
    bseed = torch.cat([seed, seed.new_zeros(1)])[slot_orig]
    blab, normals, ds, pvalid = _fit_bands(
        mesh, axis, *(mesh.local(t, axis) for t in (bx[0], bv[0], bseg,
                                                    bseed)), cfg)
    blab = mesh.all_gather(blab, axis)                        # (S, cap)
    labels = set_drop(torch.full((n,), SEG_UNKNOWN, dtype=_I32, device=dev),
                      slot_orig.reshape(-1), blab.reshape(-1))
    labels = torch.where(mask, labels, SEG_UNKNOWN)
    return SegmentationResult(labels, Plane(normals, ds), pvalid), ovf_d[0]


def device_frame_step_spatial(mesh: Mesh, xyz: torch.Tensor,
                              mask: torch.Tensor, config: EngineConfig,
                              axis: str = "space") -> FrameResult:
    """Spatially sharded segment -> cluster -> hull step for ONE frame.

    Returns a FrameResult like device_frame_step's (no frame axis): the
    segmentation within float32 summation order of the single-device
    step's, the clustering bit-identical to the single-device clustering
    of the same obstacle mask, and the hull stage unsharded on the
    reassembled labels (``label_runs`` and the pipeline's hull stage,
    called directly). Overflow counts the segmentation's dropped points
    too.
    """
    dev = mesh.device
    xyz, mask = xyz.to(dev), mask.to(dev)
    r = math.sqrt(config.clustering.distance_squared)
    seg, seg_ovf = gpf_spatial(mesh, xyz, mask, config.segmentation,
                               config.spatial, r, axis)
    obstacle = mask & (seg.labels == SEG_OBSTACLE)
    cl = cluster_spatial(mesh, xyz, obstacle, config.clustering,
                         config.pipeline, config.spatial, axis)
    cl = cl._replace(overflow=cl.overflow + seg_ovf)
    runs = label_runs(xyz, cl.labels, NUM_SLOTS)
    one = map_leaves(lambda t: t[None], (seg, cl, runs))
    return frame_of(_hull_stage(*one, config), 0)
