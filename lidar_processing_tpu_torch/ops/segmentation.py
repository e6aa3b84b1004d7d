"""GPF ground segmentation — masked, fixed-shape, batched over partitions
and frames.

Port of ``lidar_processing_tpu/ops/segmentation.py`` (Zermas-style Ground
Plane Fitting, ref: src/segmentation.cpp:62-345): one sort by x gives the
partition ids, a second stable sort by (partition, z) makes every
partition a contiguous ascending-z run, seed selection becomes prefix
arithmetic, and every partition of every frame is fitted at once over
written-out (frame, partition) batch axes (the JAX package's vmaps).

A frame of a batch gives bit for bit what it gives alone, on the card as
on the CPU, so the f32 reductions are written so that their order does
not depend on the batch: the GPF moments are sums over a fixed pairwise
tree of elementwise adds (``_tree_sum``; a matmul or ``torch.sum`` picks
its reduction order by shape, and cuBLAS its kernel by batch count), the
signed distances ``x*nx + y*ny + z*nz`` are one product and two fused
multiply-adds (what the CPU's float32 matmul computes for an inner size
of 3), and the LPR prefix sum is a fixed-order scan of elementwise
float64 adds (``_prefix_sum``), rounded to float32 once.

Those reductions still run in a different order than XLA's, so labels of
points lying on the 0.3 m threshold may differ from the JAX package's;
that is the only place the two packages may disagree.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SegmentationConfig
from ..types import (Plane, SegmentationResult, SEG_GROUND, SEG_OBSTACLE,
                     SEG_UNKNOWN, frame_of)
from .eig3 import smallest_eigenvector_3x3
from .scan_utils import sort_by

_BIG = torch.finfo(torch.float32).max
_I32 = torch.int32


def _f32(value: float, device) -> torch.Tensor:
    """A float32 scalar made on the device (no host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a fixed pairwise tree (halves added
    elementwise, zero-padded to a power of two): the same additions in the
    same order whatever the leading shape or the device."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], width - n)], -1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis as a Hillis-Steele scan:
    ceil(log2 n) shifted elementwise adds, the same adds in the same order
    whatever the leading shape or the device (``cumsum`` picks its order by
    shape on the card)."""
    n = x.shape[-1]
    k = 1
    while k < n:
        x = torch.cat([x[..., :k], x[..., k:] + x[..., :-k]], -1)
        k *= 2
    return x


class SortedSegmentation(NamedTuple):
    """gpf output in (partition, z)-sorted space (no unsort). Per frame;
    a batch adds a leading frame axis B to every field.

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
    """Initial seed mask over each frame's (partition, z)-sorted cloud.

    Implements ref: src/segmentation.cpp:151-217 per partition run:
    partition p occupies sorted ranks [p*per_seg, (p+1)*per_seg), ascending
    in z. z_s (B, N), per_seg (B, 1). Returns (seeds (B, N) bool,
    seg_of_rank (B, N) i32 with -1 padding).
    """
    n = z_s.shape[-1]
    dev = z_s.device
    pos = torch.arange(n, dtype=_I32, device=dev)
    in_any = pos < per_seg * num_p
    seg_of_rank = torch.where(in_any, pos // torch.clamp(per_seg, min=1), -1)
    seg_of_rank = torch.where(per_seg > 0, seg_of_rank, -1)

    z_min_cut = _f32(-cfg.z_min_outlier_scale * cfg.sensor_height_m, dev)
    k_cfg = min(cfg.number_of_lower_point_representatives, n)
    csum = _prefix_sum(z_s.double()).float()

    below = (z_s <= z_min_cut) & in_any
    # per-partition count of below-cutoff points (each partition's below
    # points form the PREFIX of its ascending-z run)
    seg_iota = torch.arange(num_p, dtype=_I32, device=dev)
    below_per = (below[:, None, :]
                 & (seg_of_rank[:, None, :] == seg_iota[:, None])
                 ).sum(-1, dtype=_I32)                    # (B,P)

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
    z_sum = csum.gather(-1, hi) - torch.where(s_kept > 0,
                                              csum.gather(-1, lo), 0.0)
    z_mean = z_sum / torch.clamp(k_eff, min=1).float()
    z_max_cut = z_mean + _f32(cfg.initial_seed_threshold, dev)

    # quirk: if no kept point exceeds the threshold the seed set is EMPTY;
    # the kept run's max z is its last element
    run_max = z_s.gather(-1, torch.clamp(start + n_p - 1, 0, n - 1).long())
    any_above = run_max > z_max_cut
    seg_ok = (n_kept > 0) & any_above                   # (B,P)

    sel = torch.clamp(seg_of_rank, 0, num_p - 1).long()
    seeds = (in_any & (pos >= s_kept.gather(-1, sel))
             & (z_s <= z_max_cut.gather(-1, sel)) & seg_ok.gather(-1, sel))
    return seeds, seg_of_rank


def _fit_partition(
    pts: torch.Tensor, seg_mask: torch.Tensor, seeds: torch.Tensor,
    cfg: SegmentationConfig, total=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPF iterations for every partition of every frame (any point order).

    pts: (B,N,3) clouds; seg_mask, seeds: (B,P,N) partition membership and
    initial ground masks. `total` maps the rows' per-partition sums (B, P,
    ...) to the sums the fit uses, of the same shape: None, each row's
    own (a row is a frame); the x-band fit gives every row the sum over
    every band of the frame (a row is a band, parallel/frame_spatial.py). Returns (labels (B,N)
    int32, UNKNOWN outside every partition; normals (B,P,3), d (B,P),
    plane_valid (B,P)).
    """
    total = total or (lambda x: x)
    frames, num_p = seg_mask.shape[:2]
    dev = pts.device
    pt = pts.transpose(1, 2).contiguous()[:, None]         # (B,1,3,N)
    seg_n = total(seg_mask.sum(-1, dtype=_I32))
    odt = _f32(cfg.orthogonal_distance_threshold, dev)

    ground = seeds
    failed = torch.zeros((frames, num_p), dtype=torch.bool, device=dev)
    normal = torch.cat([torch.zeros((frames, num_p, 2), device=dev),
                        torch.ones((frames, num_p, 1), device=dev)], dim=-1)
    d = torch.zeros((frames, num_p), device=dev)
    for _ in range(cfg.number_of_iterations):
        cnt = total(ground.sum(-1, dtype=_I32))
        failed_now = failed | (cnt < 3)
        cnt_f = torch.clamp(cnt, min=3).float()

        w = ground.float()[:, :, None, :]                  # (B,P,1,N)
        # two-pass masked moments: center on the masked mean first so the
        # covariance sum does not cancel catastrophically in f32
        s1 = total(_tree_sum(w * pt))                      # (B,P,3)
        centroid = s1 / cnt_f[..., None]
        xc = pt - centroid[..., None]                      # (B,P,3,N)
        xw = xc * w
        # one tree for s1c (3) and s2c (3x3): sum w*xc_i, sum (xc_i*w)*xc_j
        s = total(_tree_sum(torch.cat(
            [xw, (xw[:, :, :, None] * xc[:, :, None]).flatten(2, 3)],
            dim=2)))
        s1c, s2c = s[..., :3], s[..., 3:].unflatten(-1, (3, 3))
        cov = ((s2c - s1c[..., :, None] * s1c[..., None, :]
                / cnt_f[..., None, None])
               / torch.clamp(cnt_f - 1.0, min=1.0)[..., None, None])

        n_vec = smallest_eigenvector_3x3(cov)              # (B,P,3)
        failed_now = failed_now | ~torch.isfinite(n_vec).all(-1)
        nc = n_vec * centroid
        d_new = nc[..., 0] + nc[..., 1] + nc[..., 2]
        nv = n_vec[..., None]                              # (B,P,3,1)
        dist = torch.addcmul(torch.addcmul(pt[:, :, 0] * nv[:, :, 0],
                                           pt[:, :, 1], nv[:, :, 1]),
                             pt[:, :, 2], nv[:, :, 2]) - d_new[..., None]
        # SIGNED comparison (ref: src/segmentation.cpp:299); ||n|| == 1
        new_ground = seg_mask & (dist < odt)

        ground = torch.where(failed_now[..., None], ground, new_ground)
        normal = torch.where(failed_now[..., None], normal, n_vec)
        d = torch.where(failed_now, d, d_new)
        failed = failed_now

    labels = torch.where(ground, SEG_GROUND, SEG_OBSTACLE).to(_I32)
    labels = torch.where(failed[..., None], SEG_OBSTACLE, labels)
    # <3-point partitions stay UNKNOWN (ref: src/segmentation.cpp:224-229)
    too_small = seg_n < 3
    labels = torch.where(too_small[..., None], SEG_UNKNOWN, labels)
    # combine partitions: each point belongs to at most one
    combined = torch.full(pts.shape[:2], SEG_UNKNOWN, dtype=_I32, device=dev)
    for p in range(num_p):
        combined = torch.where(seg_mask[:, p], labels[:, p], combined)
    return combined, normal, d, ~failed & ~too_small


def _partition_sort(xyz: torch.Tensor, mask: torch.Tensor, num_p: int):
    """The two sorts of GPF over (B, N, 3) clouds: by x (partition
    membership is x-rank // per_seg, ref: src/segmentation.cpp:104-149),
    then stably by (partition, z), so every partition is a contiguous run
    ascending in z (ref: src/segmentation.cpp:151-217). Returns (sorted
    xyz (B, N, 3), original index (B, N), per_seg (B, 1), n_valid
    (B, 1))."""
    frames, n_pts = xyz.shape[:2]
    iota = torch.arange(n_pts, dtype=_I32, device=xyz.device)
    sort_key = torch.where(mask, xyz[..., 0], _BIG)
    _, sx_, sy_, sz_, order = sort_by(
        sort_key, xyz[..., 0], xyz[..., 1], xyz[..., 2],
        iota.expand(frames, n_pts))

    n_valid = mask.sum(-1, keepdim=True, dtype=_I32)     # (B,1)
    per_seg = n_valid // num_p
    seg_ids = torch.where(iota < per_seg * num_p,
                          iota // torch.clamp(per_seg, min=1), num_p)
    seg_ids = torch.where(per_seg > 0, seg_ids, num_p)
    # tail-drop-quirk points (valid, UNKNOWN) get key num_p; padding rows
    # key num_p + 1 so valid points stay in sorted ranks [0, n_valid)
    seg_key = torch.where(iota < n_valid, seg_ids, num_p + 1)
    _, pz, px, py, porig = sort_by((seg_key, sz_), sx_, sy_, order)
    return torch.stack([px, py, pz], dim=-1), porig, per_seg, n_valid


def gpf_segment_sorted(xyz: torch.Tensor, mask: torch.Tensor,
                       cfg: SegmentationConfig) -> SortedSegmentation:
    """Segment padded clouds; results stay in (partition, z)-sorted space.

    xyz: (B,N,3) float32 padded clouds; mask: (B,N) bool validity. One
    frame without the leading B gives a result without it.
    """
    if xyz.dim() == 2:
        return frame_of(gpf_segment_sorted(xyz[None], mask[None], cfg), 0)
    num_p = cfg.number_of_planar_partitions
    dev = xyz.device
    iota = torch.arange(xyz.shape[1], dtype=_I32, device=dev)
    sp, porig, per_seg, n_valid = _partition_sort(xyz, mask, num_p)
    seeds, seg_of_rank = _seed_runs(sp[..., 2], per_seg, num_p, cfg)
    seg_masks = seg_of_rank[:, None, :] == torch.arange(
        num_p, dtype=_I32, device=dev)[:, None]          # (B,P,N)
    labels_sorted, normals, ds, valids = _fit_partition(
        sp, seg_masks, seg_masks & seeds[:, None, :], cfg)
    valid_sorted = iota < n_valid
    return SortedSegmentation(sp, labels_sorted, porig, valid_sorted,
                              Plane(normals, ds), valids)


def gpf_segment(xyz: torch.Tensor, mask: torch.Tensor,
                cfg: SegmentationConfig) -> SegmentationResult:
    """Segment padded clouds into GROUND/OBSTACLE/UNKNOWN, with labels in
    the ORIGINAL point order plus the fitted planes per partition. xyz
    (B,N,3) and mask (B,N), or one frame without the B."""
    ss = gpf_segment_sorted(xyz, mask, cfg)
    # ss.orig is a permutation of [0, n): unsort by sorting on it
    _, labels = sort_by(ss.orig, ss.labels)
    labels = torch.where(mask, labels, SEG_UNKNOWN)
    return SegmentationResult(labels, ss.planes, ss.plane_valid)
