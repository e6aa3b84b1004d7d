"""GPF ground segmentation — masked, fixed-shape, batched over partitions.

Port of ``lidar_processing_tpu/ops/segmentation.py`` (Zermas-style Ground
Plane Fitting, ref: src/segmentation.cpp:62-345): one sort by x gives the
partition ids, a second stable sort by (partition, z) makes every
partition a contiguous ascending-z run, seed selection becomes prefix
arithmetic, and every partition is fitted at once over a written-out
partition batch dimension (the JAX package's vmap). The moment products
are ``torch.matmul``/``einsum`` in full float32 (TF32 is off, see the
package ``__init__``).

The f32 reductions (the seed prefix sum, the moments, the eigen-solve)
run in a different order than XLA's, so labels of points lying on the
0.3 m threshold may differ from the JAX package's; that is the only place
the two packages may disagree.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SegmentationConfig
from ..types import (Plane, SegmentationResult, SEG_GROUND, SEG_OBSTACLE,
                     SEG_UNKNOWN)
from .eig3 import smallest_eigenvector_3x3
from .scan_utils import sort_by

_BIG = torch.finfo(torch.float32).max
_I32 = torch.int32


def _f32(value: float, device) -> torch.Tensor:
    """A float32 scalar made on the device (no host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


class SortedSegmentation(NamedTuple):
    """gpf output in (partition, z)-sorted space (no unsort).

    xyz:    (N, 3) f32 cloud sorted by (partition id, z); invalid points
            and the tail-drop quirk's points sort last.
    labels: (N,) i32 GROUND/OBSTACLE/UNKNOWN per sorted position.
    orig:   (N,) i32 original index per sorted position.
    valid:  (N,) bool validity per sorted position.
    planes: per-partition fitted planes.
    plane_valid: (P,) bool.
    """

    xyz: torch.Tensor
    labels: torch.Tensor
    orig: torch.Tensor
    valid: torch.Tensor
    planes: Plane
    plane_valid: torch.Tensor


def _seed_runs(z_s: torch.Tensor, per_seg: torch.Tensor, num_p: int,
               cfg: SegmentationConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial seed mask over the (partition, z)-sorted cloud.

    Implements ref: src/segmentation.cpp:151-217 per partition run:
    partition p occupies sorted ranks [p*per_seg, (p+1)*per_seg), ascending
    in z. Returns (seeds (N,) bool, seg_of_rank (N,) i32 with -1 padding).
    """
    n = z_s.shape[0]
    dev = z_s.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    in_any = pos < per_seg * num_p
    seg_of_rank = torch.where(in_any, pos // torch.clamp(per_seg, min=1), -1)
    seg_of_rank = torch.where(per_seg > 0, seg_of_rank, -1)

    z_min_cut = _f32(-cfg.z_min_outlier_scale * cfg.sensor_height_m, dev)
    k_cfg = min(cfg.number_of_lower_point_representatives, n)
    csum = torch.cumsum(z_s, 0)

    below = (z_s <= z_min_cut) & in_any
    # per-partition count of below-cutoff points (each partition's below
    # points form the PREFIX of its ascending-z run)
    seg_iota = torch.arange(num_p, dtype=_I32, device=dev)
    below_per = (below[None, :] & (seg_of_rank[None, :] == seg_iota[:, None])
                 ).sum(1, dtype=_I32)                    # (P,)

    start = seg_iota * per_seg
    n_p = torch.where(per_seg > 0, per_seg, 0)
    has_above = below_per < n_p
    # quirk: if NO point clears the cutoff, nothing is dropped
    n_drop = torch.where(has_above, below_per, 0)
    s_kept = start + n_drop
    n_kept = n_p - n_drop
    k_eff = torch.clamp(n_kept, max=k_cfg)

    # LPR mean via prefix sums over the ascending-z runs
    hi = torch.clamp(s_kept + k_eff - 1, 0, n - 1).long()
    lo = torch.clamp(s_kept - 1, 0, n - 1).long()
    z_sum = csum[hi] - torch.where(s_kept > 0, csum[lo], 0.0)
    z_mean = z_sum / torch.clamp(k_eff, min=1).float()
    z_max_cut = z_mean + _f32(cfg.initial_seed_threshold, dev)

    # quirk: if no kept point exceeds the threshold the seed set is EMPTY;
    # the kept run's max z is its last element
    run_max = z_s[torch.clamp(start + n_p - 1, 0, n - 1).long()]
    any_above = run_max > z_max_cut
    seg_ok = (n_kept > 0) & any_above                   # (P,)

    sel = torch.clamp(seg_of_rank, 0, num_p - 1).long()
    seeds = (in_any & (pos >= s_kept[sel]) & (z_s <= z_max_cut[sel])
             & seg_ok[sel])
    return seeds, seg_of_rank


def _fit_partition(
    pts: torch.Tensor, seg_mask: torch.Tensor, seeds: torch.Tensor,
    cfg: SegmentationConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPF iterations for a batch of partitions (any point order).

    pts: (N,3) cloud; seg_mask, seeds: (P,N) partition membership and
    initial ground masks. Returns (labels (P,N) int32 valid only under
    seg_mask, normals (P,3), d (P,), plane_valid (P,)).
    """
    num_p = seg_mask.shape[0]
    dev = pts.device
    seg_n = seg_mask.sum(1, dtype=_I32)
    odt = _f32(cfg.orthogonal_distance_threshold, dev)

    ground = seeds
    failed = torch.zeros(num_p, dtype=torch.bool, device=dev)
    normal = torch.cat([torch.zeros((num_p, 2), device=dev),
                        torch.ones((num_p, 1), device=dev)], dim=1)
    d = torch.zeros(num_p, device=dev)
    for _ in range(cfg.number_of_iterations):
        cnt = ground.sum(1, dtype=_I32)
        failed_now = failed | (cnt < 3)
        cnt_f = torch.clamp(cnt, min=3).float()

        w = ground.float()                                     # (P,N)
        # two-pass masked moments: center on the masked mean first so the
        # covariance product does not cancel catastrophically in f32
        s1 = w @ pts                                           # (P,3)
        centroid = s1 / cnt_f[:, None]
        xc = pts[None, :, :] - centroid[:, None, :]            # (P,N,3)
        s1c = torch.einsum("pn,pni->pi", w, xc)
        s2c = torch.einsum("pni,pnj->pij", xc * w[:, :, None], xc)
        cov = ((s2c - s1c[:, :, None] * s1c[:, None, :] / cnt_f[:, None, None])
               / torch.clamp(cnt_f - 1.0, min=1.0)[:, None, None])

        n_vec = smallest_eigenvector_3x3(cov)                  # (P,3)
        failed_now = failed_now | ~torch.isfinite(n_vec).all(1)
        d_new = (n_vec * centroid).sum(1)
        dist = (pts @ n_vec.T).T - d_new[:, None]              # (P,N)
        # SIGNED comparison (ref: src/segmentation.cpp:299); ||n|| == 1
        new_ground = seg_mask & (dist < odt)

        ground = torch.where(failed_now[:, None], ground, new_ground)
        normal = torch.where(failed_now[:, None], normal, n_vec)
        d = torch.where(failed_now, d, d_new)
        failed = failed_now

    labels = torch.where(ground, SEG_GROUND, SEG_OBSTACLE).to(_I32)
    labels = torch.where(failed[:, None], SEG_OBSTACLE, labels)
    # <3-point partitions stay UNKNOWN (ref: src/segmentation.cpp:224-229)
    too_small = seg_n < 3
    labels = torch.where(too_small[:, None], SEG_UNKNOWN, labels)
    plane_valid = ~failed & ~too_small
    return labels, normal, d, plane_valid


def gpf_segment_sorted(xyz: torch.Tensor, mask: torch.Tensor,
                       cfg: SegmentationConfig) -> SortedSegmentation:
    """Segment a padded cloud; results stay in (partition, z)-sorted space.

    xyz: (N,3) float32 padded cloud; mask: (N,) bool validity.
    """
    num_p = cfg.number_of_planar_partitions
    n_pts = xyz.shape[0]
    dev = xyz.device

    # sort 1: by x — partition membership is x-rank // per_seg
    # (ref: src/segmentation.cpp:104-149); the coordinates and original
    # index ride along
    sort_key = torch.where(mask, xyz[:, 0], _BIG)
    _, sx_, sy_, sz_, order = sort_by(
        sort_key, xyz[:, 0], xyz[:, 1], xyz[:, 2],
        torch.arange(n_pts, dtype=_I32, device=dev))

    n_valid = mask.sum(dtype=_I32)
    per_seg = n_valid // num_p
    ranks = torch.arange(n_pts, dtype=_I32, device=dev)
    seg_ids = torch.where(ranks < per_seg * num_p,
                          ranks // torch.clamp(per_seg, min=1), num_p)
    seg_ids = torch.where(per_seg > 0, seg_ids, num_p)
    # tail-drop-quirk points (valid, UNKNOWN) get key num_p; padding rows
    # key num_p + 1 so valid points stay in sorted ranks [0, n_valid)
    seg_key = torch.where(ranks < n_valid, seg_ids, num_p + 1)

    # sort 2: by (partition, z), stable — every partition becomes a
    # contiguous run ascending in z (ref: src/segmentation.cpp:151-217)
    _, pz, px, py, porig = sort_by((seg_key, sz_), sx_, sy_, order)
    sp = torch.stack([px, py, pz], dim=1)

    seeds, seg_of_rank = _seed_runs(pz, per_seg, num_p, cfg)
    seg_masks = seg_of_rank[None, :] == torch.arange(
        num_p, dtype=_I32, device=dev)[:, None]
    labels_p, normals, ds, valids = _fit_partition(
        sp, seg_masks, seg_masks & seeds[None, :], cfg)

    # combine partitions: each sorted position belongs to at most one
    labels_sorted = torch.full((n_pts,), SEG_UNKNOWN, dtype=_I32, device=dev)
    for s in range(num_p):
        labels_sorted = torch.where(seg_masks[s], labels_p[s], labels_sorted)

    valid_sorted = ranks < n_valid
    return SortedSegmentation(sp, labels_sorted, porig, valid_sorted,
                              Plane(normals, ds), valids)


def gpf_segment(xyz: torch.Tensor, mask: torch.Tensor,
                cfg: SegmentationConfig) -> SegmentationResult:
    """Segment a padded cloud into GROUND/OBSTACLE/UNKNOWN, with labels in
    the ORIGINAL point order plus the fitted planes per partition."""
    ss = gpf_segment_sorted(xyz, mask, cfg)
    # ss.orig is a permutation of [0, n): unsort by sorting on it
    _, labels = sort_by(ss.orig, ss.labels)
    labels = torch.where(mask, labels, SEG_UNKNOWN)
    return SegmentationResult(labels, ss.planes, ss.plane_valid)
