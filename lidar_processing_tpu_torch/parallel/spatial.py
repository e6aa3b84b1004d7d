"""Spatial x-band sharding: one cloud clustered across shards, exactly.

Port of ``lidar_processing_tpu/parallel/spatial.py``. The reference scales
within a frame by partitioning space into x-bands processed serially
(ref: src/segmentation.cpp:104-149); here the bands are the shards of a
'space' mesh axis (parallel/mesh.py), and the result is EXACT: labels,
``num_clusters`` and ``overflow`` bit-identical to the single-device
``ops/stixel.py::cluster`` in every layout of ranks and shards per rank.

  1. distribute: one global stable sort assigns every point to an x-band
     of width >= the clustering radius R (so only ADJACENT bands can hold
     points of the same cluster) and scatters it to its band's padded
     buffer (every rank computes the whole distribution, then keeps its
     own bands: the JAX package's all-to-all).
  2. local clustering: each rank's bands go through ONE batched stixel
     ``cluster`` call (its two kernels launch once per table whatever
     the number of shards), with the size filter OFF: a locally small
     fragment may be a piece of a large cross-band cluster.
  3. halo exchange: each band sends its right margin (points within R of
     its right boundary, with their local component ids) to its right
     neighbour (``Mesh.shift_right``); the receiver tests d² <= R²
     between the received margin and its own left margin, its d² rounded
     as the JAX package's halo test rounds it on the CPU (``_cross_edges``),
     so a pair on the knife edge d² = R² gets the JAX band path's verdict.
     Every cross-band edge of the radius graph has both endpoints inside
     these margins.
  4. label merge: 16 min-label rounds over each boundary's bipartite
     graph leave one merge pair per margin point; the pairs of every band
     are gathered and every rank runs the same hook-to-min +
     pointer-jumping (``l[l][l]``) rounds over the global component table.
  5. merged sizes, the size filter (ref: src/clustering.cpp:113-119) on
     MERGED sizes, canonical numbering by the minimum original index,
     and the reassembly into original point order.

Every cap lives in SpatialConfig. A band over ``block_points``,
``block_clusters`` or ``halo_points``, or a boundary chain that does not
converge in 16 rounds, raises ``overflow``: never a silent truncation.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..config import ClusteringConfig, PipelineConfig, SpatialConfig
from ..ops import stixel as sx
from ..ops.scan_utils import (IMAX, compact_mask, scatter_drop, set_drop,
                              sort_by, sum_sq3, take_rows)
from ..ops.segmentation import _f32
from ..types import CLUSTER_INVALID, CLUSTER_UNDEFINED, ClusteringResult
from .mesh import Mesh

_I32 = torch.int32
_BIG = 3.4e38
_MARGIN_FILL = 1.0e9

# min-label rounds over one boundary's bipartite component graph; chains
# of more than this many distinct components zig-zagging across a single
# band boundary raise the overflow counter instead of merging silently
# wrong
_BND_ROUNDS = 16


def _block_pipeline_config(scfg: SpatialConfig,
                           pcfg: PipelineConfig) -> PipelineConfig:
    """Per-band PipelineConfig for the local stixel run."""
    return dataclasses.replace(
        pcfg,
        max_points=scfg.block_points,
        max_obstacle_points=scfg.block_points,
        max_cells=scfg.block_cells,
        max_columns=scfg.block_columns,
        max_supernodes=scfg.block_supernodes,
        max_column_pairs=scfg.block_column_pairs,
        max_sn_pairs=scfg.block_sn_pairs,
        max_edges=scfg.block_edges,
        max_live_edges=scfg.block_live_edges,
    )


def _distribute(xyz: torch.Tensor, valid: torch.Tensor, s: int, cap: int,
                r: float):
    """Assign each frame's points to x-bands and scatter them to (S, cap)
    band buffers.

    xyz (F, N, 3), valid (F, N). Returns (bxyz (F, S, cap, 3), borig
    (F, S, cap) with -1 in empty slots, bvalid (F, S, cap), x_lo (F,),
    w (F,), overflow (F,)). Band width w >= r by construction; band S - 1
    absorbs the right tail, so two points within r are always in the same
    or adjacent bands.
    """
    frames, n = valid.shape
    dev = xyz.device
    x = xyz[..., 0]
    x_lo = torch.where(valid, x, _f32(_BIG, dev)).amin(-1)
    x_hi = torch.where(valid, x, _f32(-_BIG, dev)).amax(-1)
    any_valid = valid.any(-1)
    x_lo = torch.where(any_valid, x_lo, 0.0)
    x_hi = torch.where(any_valid, x_hi, 0.0)
    w = (torch.maximum((x_hi - x_lo) / _f32(s, dev), _f32(r, dev))
         * _f32(1 + 1e-6, dev))

    band = torch.clamp(torch.floor((x - x_lo[:, None]) / w[:, None]),
                       0, s - 1).to(_I32)
    band = torch.where(valid, band, s)
    pos = torch.arange(n, dtype=_I32, device=dev).expand(frames, n)
    sband, sorig = sort_by(band, pos)            # stable in ties
    starts = torch.searchsorted(
        sband, torch.arange(s, dtype=_I32, device=dev).expand(
            frames, s).contiguous(), side="left").to(_I32)
    rank = pos - starts.gather(1, torch.clamp(sband, 0, s - 1).long())
    in_cap = (sband < s) & (rank < cap)
    slot = torch.where(in_cap, sband * cap + rank, s * cap)
    overflow = ((sband < s) & (rank >= cap)).sum(-1, dtype=_I32)

    xyz_s = take_rows(xyz, sorig)
    bxyz = torch.stack([set_drop(xyz.new_zeros(frames, s * cap), slot,
                                 xyz_s[..., a]) for a in range(3)], -1)
    borig = set_drop(torch.full((frames, s * cap), -1, dtype=_I32,
                                device=dev), slot, sorig)
    bvalid = set_drop(torch.zeros((frames, s * cap), dtype=torch.bool,
                                  device=dev), slot, in_cap)
    return (bxyz.reshape(frames, s, cap, 3), borig.reshape(frames, s, cap),
            bvalid.reshape(frames, s, cap), x_lo, w, overflow)


def _margin_pack(xyz: torch.Tensor, gid: torch.Tensor,
                 sel_mask: torch.Tensor, cap: int):
    """Compact each band's margin points into (..., cap) rows: xyz
    (1e9-filled) and global component ids (-1-filled)."""
    idx, cnt, ovf = compact_mask(sel_mask, cap)
    act = torch.arange(cap, dtype=_I32, device=xyz.device) < cnt[..., None]
    mx = torch.where(act[..., None], take_rows(xyz, idx), _MARGIN_FILL)
    mg = torch.where(act, gid.gather(-1, idx.long()), -1)
    return mx, mg, ovf


def _merge_rounds(s: int) -> int:
    return max(2, int(math.ceil(math.log2(max(s, 2)))) + 2)


def _cross_edges(rx, rg, lx, lg, r2: float) -> torch.Tensor:
    """(..., H, H) bool: received right-margin point i (of the left
    neighbour) within R of left-margin point j, both real. d² rounds as
    the JAX package's halo test (``jnp.sum(d * d, axis=2)``) does on the
    CPU, fma(z, z, fma(y, y, x·x)), found by crafted knife-edge pairs
    across a band boundary (tools/knife_cases.py); compared with R² in
    float32. The single-device exact test rounds otherwise
    (kernels/tier_min_d2.py), so a crafted pair can link across bands and
    not on one device, in the JAX package as here (ROADMAP §3)."""
    d2 = sum_sq3(*(rx[..., :, None, a] - lx[..., None, :, a]
                   for a in range(3)))
    return (d2 <= r2) & (rg >= 0)[..., :, None] & (lg >= 0)[..., None, :]


def _boundary_labels(edge, rg, lg):
    """Min-label propagation over each boundary's bipartite graph: every
    margin point converges to its boundary component's minimum gid.
    Returns (lab_r, lab_l, not converged as int32)."""
    imax = torch.full((), IMAX, dtype=_I32, device=edge.device)
    lab_r, lab_l = rg, lg
    for _ in range(_BND_ROUNDS):
        lab_r = torch.minimum(lab_r, torch.where(
            edge, lab_l[..., None, :], imax).amin(-1))
        lab_l = torch.minimum(lab_l, torch.where(
            edge, lab_r[..., :, None], imax).amin(-2))
    res_r = torch.where(edge, lab_l[..., None, :], imax).amin(-1)
    converged = (torch.minimum(lab_r, res_r) == lab_r).all(-1)
    return lab_r, lab_l, (~converged).to(_I32)


def _hook_rounds(gu, gv, gok, t_total: int, rounds: int) -> torch.Tensor:
    """(F, T) min-label union-find over the gathered merge pairs: hook
    both ends to their pair's min, then pointer-jump l[l][l]."""
    frames = gu.shape[0]
    glab = torch.arange(t_total, dtype=_I32, device=gu.device).expand(
        frames, t_total).contiguous()
    for _ in range(rounds):
        lu = glab.gather(1, torch.where(gok, gu, 0).long())
        lv = glab.gather(1, torch.where(gok, gv, 0).long())
        mn = torch.where(gok, torch.minimum(lu, lv), IMAX)
        for end in (lu, lv):
            tgt = torch.where(gok, end, t_total).long()
            glab = torch.cat([glab, glab[:, :1]], 1).scatter_reduce(
                1, tgt, mn, "amin")[:, :t_total]
        glab = glab.gather(1, glab.long())
        glab = glab.gather(1, glab.long())
    return glab


def _cluster_bands(mesh: Mesh, axis: str, xyzs: torch.Tensor,
                   valids: torch.Tensor, ccfg: ClusteringConfig,
                   pcfg: PipelineConfig, scfg: SpatialConfig):
    """Exact clustering of F frames, each split into the S x-bands of
    `axis` (this rank holding K consecutive bands of every frame).

    xyzs (F, N, 3), valids (F, N) on the mesh's device. Returns (labels
    (F, N), num_clusters (F,), overflow (F,)), the same on every rank of
    the axis.
    """
    s, k = mesh.shape[axis], mesh.local_shards(axis)
    i0 = mesh.first_shard(axis)
    cap, l_cap, h_cap = (scfg.block_points, scfg.block_clusters,
                         scfg.halo_points)
    r2 = ccfg.distance_squared
    r = math.sqrt(r2)
    t_total = s * l_cap
    frames, n = valids.shape
    dev = xyzs.device
    # local runs must not size-filter: fragments merge across bands first
    local_ccfg = dataclasses.replace(
        ccfg, min_cluster_size=1, max_cluster_size=2 ** 32 - 1)

    bx, bo_all, bv, x_lo, w, ovf_d = _distribute(xyzs, valids, s, cap, r)
    bx, bo, bv = (mesh.local(t, axis, 1) for t in (bx, bo_all, bv))

    # ---- every local band of every frame: ONE batched stixel run ---------
    res = sx.cluster(bx.reshape(frames * k, cap, 3),
                     bv.reshape(frames * k, cap), local_ccfg,
                     _block_pipeline_config(scfg, pcfg))
    lab = res.labels.reshape(frames, k, cap)
    labeled = lab >= 0
    lab_overflow = (labeled & (lab >= l_cap)).sum(-1, dtype=_I32)
    tgt = torch.where(labeled & (lab < l_cap), lab, l_cap)
    size_loc = scatter_drop(l_cap, tgt, labeled.to(_I32), 0, "sum")
    min_loc = scatter_drop(l_cap, tgt, torch.where(bo >= 0, bo, IMAX), IMAX,
                           "amin")
    band = torch.arange(i0, i0 + k, dtype=_I32, device=dev)[:, None]
    gid = torch.where(labeled, band * l_cap + torch.clamp(lab, 0, l_cap - 1),
                      -1)

    # ---- halo exchange: right margin -> right neighbour ------------------
    bandf = band.float()
    x0, ww, rf = x_lo[:, None, None], w[:, None, None], _f32(r, dev)
    x_right = x0 + (bandf + 1.0) * ww             # my right boundary
    mx, mg, ovf_r = _margin_pack(bx, gid, labeled & (bx[..., 0]
                                                     > x_right - rf), h_cap)
    rx = mesh.shift_right(mx, axis, dim=1)        # from the left neighbour
    rg = mesh.shift_right(mg, axis, dim=1)
    has_left = band[None] > 0                     # (1, K, 1)
    rx = torch.where((has_left & (rg >= 0))[..., None], rx, _MARGIN_FILL)
    rg = torch.where(has_left, rg, -1)
    x_left = x0 + bandf * ww                      # my left boundary
    lx, lg, ovf_l = _margin_pack(bx, gid, labeled & (bx[..., 0]
                                                     < x_left + rf), h_cap)

    # ---- exact cross-band edges, then one merge pair per margin point ----
    edge = _cross_edges(rx, rg, lx, lg, r2)       # (F, K, H, H)
    lab_r, lab_l, ovf_c = _boundary_labels(edge, rg, lg)
    pu = torch.cat([torch.clamp(rg, min=0), torch.clamp(lg, min=0)], -1)
    pv = torch.cat([torch.clamp(lab_r, min=0), torch.clamp(lab_l, min=0)],
                   -1)
    eact = torch.cat([rg >= 0, lg >= 0], -1)      # (F, K, 2H)

    # ---- global union-find over the gathered pairs (every rank) ---------
    gu, gv, gok = (mesh.all_gather(t, axis, dim=1).reshape(frames, -1)
                   for t in (pu, pv, eact))
    glab = _hook_rounds(gu, gv, gok, t_total, _merge_rounds(s))

    # ---- merged stats, size filter, canonical numbering -----------------
    g_size = mesh.all_gather(size_loc, axis, dim=1).reshape(frames, -1)
    g_min = mesh.all_gather(min_loc, axis, dim=1).reshape(frames, -1)
    has_pts = g_size > 0
    root_tgt = torch.where(has_pts, glab, t_total)
    comp_size = scatter_drop(t_total, root_tgt, g_size, 0, "sum")
    comp_min = scatter_drop(t_total, root_tgt, g_min, IMAX, "amin")
    ids = torch.arange(t_total, dtype=_I32, device=dev)
    max_sz = min(ccfg.max_cluster_size, 2 ** 31 - 1)
    comp_valid = (has_pts & (glab == ids)
                  & (comp_size >= ccfg.min_cluster_size)
                  & (comp_size <= max_sz))
    rank_key = torch.where(comp_valid, comp_min, IMAX)
    rorder = torch.argsort(rank_key, dim=1, stable=True)
    ranks = torch.empty_like(rank_key).scatter_(
        1, rorder, ids.expand(frames, -1).contiguous())
    num_clusters = comp_valid.sum(-1, dtype=_I32)
    root_label = torch.where(comp_valid, ranks, CLUSTER_INVALID)

    # ---- per-point labels, reassembled in original order ----------------
    pt_root = glab.gather(1, torch.clamp(gid, 0, t_total - 1).reshape(
        frames, -1).long())
    final = torch.where(labeled.reshape(frames, -1),
                        root_label.gather(1, pt_root.long()),
                        CLUSTER_UNDEFINED)
    flab = mesh.all_gather(final.reshape(frames, k, cap), axis, dim=1)
    forig = bo_all.reshape(frames, -1)
    out = set_drop(torch.full((frames, n), CLUSTER_UNDEFINED, dtype=_I32,
                              device=dev),
                   torch.where(forig >= 0, forig, n), flab.reshape(frames, -1))
    ovf = (res.overflow.reshape(frames, k) + lab_overflow + ovf_r + ovf_l
           + ovf_c)
    overflow = ovf_d + mesh.all_gather(ovf, axis, dim=1).sum(-1, dtype=_I32)
    return out, num_clusters, overflow


def _spatial_program(mesh: Mesh, axis: str, xyzs: torch.Tensor,
                     valids: torch.Tensor, cfgs: tuple):
    """cluster_spatial's program: ``_cluster_bands`` of (1, N) frames,
    configs (ccfg, pcfg, scfg)."""
    dev = mesh.device
    return _cluster_bands(mesh, axis, xyzs.to(dev), valids.to(dev), *cfgs)


def _spatial_2d_program(mesh: Mesh, axes: tuple, xyzs: torch.Tensor,
                        valids: torch.Tensor, cfgs: tuple):
    """cluster_spatial_2d's program: each rank's frames of the data axis
    (axes[0]) through ``_cluster_bands`` over the space axis (axes[1]),
    gathered over the data axis."""
    data_axis, space_axis = axes
    dev = mesh.device
    out = _cluster_bands(mesh, space_axis, mesh.local(xyzs.to(dev), data_axis),
                         mesh.local(valids.to(dev), data_axis), *cfgs)
    return tuple(mesh.all_gather(t, data_axis) for t in out)


def cluster_spatial(mesh: Mesh, xyz: torch.Tensor, valid: torch.Tensor,
                    ccfg: ClusteringConfig, pcfg: PipelineConfig,
                    scfg: SpatialConfig, axis: str = "space"
                    ) -> ClusteringResult:
    """Exact Euclidean clustering of ONE padded cloud sharded over `axis`.

    xyz (N, 3) f32, valid (N,) bool; moved to the mesh's device. Returns a
    ClusteringResult identical to ``ops.stixel.cluster(xyz, valid, ccfg,
    pcfg)`` on one device: the same labels, canonical numbering and
    size-filter semantics. On the card a captured graph per mesh layout
    and config (``Mesh.run``), the JAX package's jitted ``run``.
    """
    labels, num, overflow = mesh.run(
        ("cluster_spatial", axis), functools.partial(_spatial_program, mesh,
                                                     axis),
        (ccfg, pcfg, scfg), xyz[None], valid[None])
    return ClusteringResult(labels[0], num[0], overflow[0])


def cluster_spatial_2d(mesh: Mesh, xyzs: torch.Tensor, valids: torch.Tensor,
                       ccfg: ClusteringConfig, pcfg: PipelineConfig,
                       scfg: SpatialConfig, data_axis: str = "data",
                       space_axis: str = "space") -> ClusteringResult:
    """Exact clustering of a FRAME BATCH on a 2-D (data, space) mesh.

    xyzs (B, N, 3), valids (B, N), with B equal to the data axis' shards:
    frames shard over `data_axis` (each rank clusters its own frames),
    each frame's x-bands over `space_axis`; the result, gathered over the
    data axis, has every frame on every rank, each bit-identical to the
    single-device clustering. On the card a captured graph
    (``Mesh.run``), the JAX package's jitted ``run_2d``.
    """
    b = xyzs.shape[0]
    if b != mesh.shape[data_axis]:
        raise ValueError(f"batch {b} must equal the data axis size "
                         f"{mesh.shape[data_axis]}")
    axes = (data_axis, space_axis)
    return ClusteringResult(*mesh.run(
        ("cluster_spatial_2d", axes),
        functools.partial(_spatial_2d_program, mesh, axes),
        (ccfg, pcfg, scfg), xyzs, valids))
