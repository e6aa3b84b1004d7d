"""Exact Euclidean clustering as cell-graph connected components.

Port of ``lidar_processing_tpu/ops/clustering.py``, the JAX package's
``cellgraph`` backend: its independent exact clustering of the radius
graph, kept beside the stixel backend for cross-validation
(ref: src/clustering.cpp:47-125, src/kdtree.hpp:292-341):

  1. Points are bucketed into voxel cells of side h = R/sqrt(3) (the cell
     diagonal is R, so every cell is a clique) and sorted by cell key.
  2. Every occupied cell probes its 124 neighbours of the 5x5x5 block by
     one batched searchsorted. A pair is impossible when the AABB gap
     exceeds R, certain when the cells' first points are within R, and
     ambiguous otherwise; the ambiguous pairs (compacted to
     ``max_ambiguous_pairs`` slots) get an exact all-pairs test over up
     to ``cell_capacity`` points a cell.
  3. Min-cell-id label propagation with pointer jumping over the (M, 124)
     neighbour table, then the size filter and the canonical numbering by
     minimum original point index.

Every step runs on a leading frame axis B (the JAX package's vmap,
written out); frame b of a batch gives bit for bit what it gives alone.
As in the JAX package, this module is plain tensor code: it has no
Pallas kernel, so it has no hand-written one either. The JAX loop that
stops at a fixpoint or after 64 rounds runs all 64 rounds here (a
fixpoint stays put, so the labels are the same) and nothing waits on the
host. ``overflow`` counts every capacity violation (cells, ambiguous
pairs, coordinate range, capped cells in a negative ambiguous pair).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..config import ClusteringConfig, PipelineConfig
from ..types import (CLUSTER_INVALID, CLUSTER_UNDEFINED, ClusteringResult,
                     frame_of)
from .scan_utils import IMAX as _IMAX
from .scan_utils import (compact_mask, scatter_drop, scatter_min_rows,
                         set_drop, sort_by, sum_sq3, take, take_rows)
from .segmentation import _f32

_I32 = torch.int32
_F_BIG = 3.4e38
# cell-coordinate bit budget: 11 + 11 + 8 = 30 bits (see _pack_key)
_XB, _YB, _ZB = 11, 11, 8
_OFFSETS = [(dx, dy, dz)
            for dx in (-2, -1, 0, 1, 2)
            for dy in (-2, -1, 0, 1, 2)
            for dz in (-2, -1, 0, 1, 2)
            if (dx, dy, dz) != (0, 0, 0)]  # 124 neighbour offsets
_NO = len(_OFFSETS)


def _pack_key(cx, cy, cz):
    return (cx << (_YB + _ZB)) | (cy << _ZB) | cz


@functools.lru_cache(maxsize=None)
def _offsets(device) -> torch.Tensor:
    """(3, 124) offsets, copied to the device once (outside any timed
    step)."""
    return torch.tensor(_OFFSETS, dtype=_I32, device=device).T.contiguous()


def _limits(device) -> torch.Tensor:
    return torch.stack([torch.full((), 1 << b, dtype=_I32, device=device)
                        for b in (_XB, _YB, _ZB)])


class _CellTable(NamedTuple):
    """Per-cell table, (B, M[, 3]); slots past a frame's cell count hold
    the segment identities (starts, keys, min_orig IMAX; counts 0)."""

    keys: torch.Tensor      # sorted packed keys
    starts: torch.Tensor    # first point of the cell in the sorted cloud
    counts: torch.Tensor    # occupancy
    aabb_min: torch.Tensor  # (B, M, 3)
    aabb_max: torch.Tensor  # (B, M, 3)
    rep: torch.Tensor       # (B, M, 3) first point of the cell
    min_orig: torch.Tensor  # min original point index
    num_cells: torch.Tensor  # (B, 1)
    overflow: torch.Tensor   # (B, 1)


def _build_cells(sp, sk, sorig, svalid, max_cells: int):
    """The cell table of key-sorted points, and each point's cell slot
    (clipped to max_cells - 1, so overflowing cells merge into the last
    slot as in the JAX package)."""
    n = sp.shape[1]
    prev = torch.cat([sk.new_full((sk.shape[0], 1), _IMAX), sk[:, :-1]], 1)
    new_cell = (sk != prev) & svalid
    cell_id = torch.cumsum(new_cell, 1, dtype=_I32) - 1
    num_cells = cell_id[:, -1:] + 1
    overflow = (num_cells > max_cells).to(_I32)
    cid = torch.clamp(cell_id, 0, max_cells - 1)

    pos = torch.arange(n, dtype=_I32, device=sp.device).expand_as(sk)
    # segment minima over the slot axis: starts / keys / min_orig in one
    # int32 scatter, the AABB (max as min of the negation) in one f32
    ints = torch.stack([torch.where(svalid, pos, n),
                        torch.where(svalid, sk, _IMAX),
                        torch.where(svalid, sorig, _IMAX)], -1)
    agg_i = scatter_min_rows(max_cells, cid, ints, _IMAX)
    inf = float("inf")
    p_min = torch.where(svalid[..., None], sp, _F_BIG)
    p_neg_max = torch.where(svalid[..., None], -sp, _F_BIG)
    agg_f = scatter_min_rows(max_cells, cid, torch.cat([p_min, p_neg_max],
                                                       -1), inf)
    counts = scatter_drop(max_cells, cid, svalid.to(_I32), 0, "sum")
    starts = agg_i[..., 0]
    tbl = _CellTable(agg_i[..., 1].contiguous(), starts, counts,
                     agg_f[..., :3],
                     -agg_f[..., 3:], take_rows(sp, starts), agg_i[..., 2],
                     num_cells, overflow)
    return tbl, cid


def _classify_pairs(tbl: _CellTable, r2: float, max_cells: int):
    """For every (cell, offset) pair: the neighbour slot (B, M, 124) and
    the certain / ambiguous tables."""
    dev = tbl.keys.device
    frames = tbl.keys.shape[0]
    keys = tbl.keys
    offs = _offsets(dev)
    nx = ((keys >> (_YB + _ZB)) & ((1 << _XB) - 1))[..., None] + offs[0]
    ny = ((keys >> _ZB) & ((1 << _YB) - 1))[..., None] + offs[1]
    nz = (keys & ((1 << _ZB) - 1))[..., None] + offs[2]
    in_range = ((nx >= 0) & (nx < (1 << _XB)) & (ny >= 0) & (ny < (1 << _YB))
                & (nz >= 0) & (nz < (1 << _ZB)))
    nkey = _pack_key(torch.clamp(nx, 0, (1 << _XB) - 1),
                     torch.clamp(ny, 0, (1 << _YB) - 1),
                     torch.clamp(nz, 0, (1 << _ZB) - 1))
    slot_valid = torch.arange(max_cells, dtype=_I32,
                              device=dev) < tbl.num_cells
    # left-sided, as jnp.searchsorted(method="sort"); keys ascend
    pos = torch.searchsorted(keys, nkey.reshape(frames, -1)).to(_I32)
    pos = torch.clamp(pos, 0, max_cells - 1)
    exists = ((take(keys, pos).reshape(nkey.shape) == nkey) & in_range
              & slot_valid[..., None])
    pos = pos.reshape(nkey.shape)

    # AABB-to-AABB gap (lower bound on the min pair distance); both
    # screens' d² round as the JAX package's on the CPU, fma(z, z, fma(y,
    # y, x·x)) (found by crafted knife-edge pairs, tools/knife_cases.py)
    gap = torch.clamp(torch.maximum(
        tbl.aabb_min[:, :, None, :] - take_rows(tbl.aabb_max, pos),
        take_rows(tbl.aabb_min, pos) - tbl.aabb_max[:, :, None, :]), min=0.0)
    impossible = sum_sq3(*gap.unbind(-1)) > r2
    # first-point distance (upper bound on the min pair distance)
    dr = tbl.rep[:, :, None, :] - take_rows(tbl.rep, pos)
    near = sum_sq3(*dr.unbind(-1)) <= r2
    possible = exists & ~impossible
    return pos, possible & near, possible & ~near


def _resolve_ambiguous(sp, tbl: _CellTable, pos, ambiguous, r2: float,
                       cap: int, max_amb: int):
    """Exact min-pair-distance test for the ambiguous cell pairs: (edge
    bits (B, M, 124), overflow (B, 1))."""
    frames, m, no = ambiguous.shape
    n = sp.shape[1]
    dev = sp.device
    inf = float("inf")
    flat_amb = ambiguous.reshape(frames, m * no)
    # jnp.nonzero(size=max_amb, fill_value=0): padding points at flat
    # index 0, offset (-2,-2,-2) of the lowest-key cell, never occupied
    amb_idx, _, _ = compact_mask(flat_amb, max_amb)
    amb_real = take(flat_amb, amb_idx)
    n_amb = flat_amb.sum(1, keepdim=True, dtype=_I32)
    overflow = (n_amb > max_amb).to(_I32)
    a_cell = amb_idx // no
    b_cell = take(pos.reshape(frames, m * no), amb_idx)

    lane = torch.arange(cap, dtype=_I32, device=dev)

    def gather_block(cells, fill):
        """(3, B, A, cap) coordinate planes of each cell's first `cap`
        points; lanes past the count hold `fill` (+inf in a, -inf in b),
        so a pair with a fill lane has d² = +inf and never decides a
        verdict (the JAX package masks those pairs' d² instead; the
        verdicts are equal)."""
        first = torch.clamp(take(tbl.starts, cells), max=n)
        idx = torch.clamp(first[..., None] + lane, max=n - 1).long()
        real = lane < torch.clamp(take(tbl.counts, cells), max=cap)[..., None]
        idx = idx.reshape(frames, -1)
        return torch.stack([torch.where(
            real, sp[..., ax].gather(1, idx).reshape(real.shape), fill)
            for ax in range(3)])

    mind2 = _min_d2_rows(gather_block(a_cell, inf),
                         gather_block(b_cell, -inf))
    amb_edge = amb_real & (mind2 <= r2)

    # capped-cell accounting: only a NEGATIVE verdict on a pair where a
    # cell exceeded `cap` could have missed the qualifying point pair
    capped = (take(tbl.counts, a_cell) > cap) | (take(tbl.counts, b_cell)
                                                 > cap)
    maybe_missed = amb_real & ~amb_edge & capped
    overflow = overflow + maybe_missed.sum(1, keepdim=True, dtype=_I32)
    # colliding indices (the padding's 0) all carry False
    edge = set_drop(torch.zeros((frames, m * no), dtype=torch.bool,
                                device=dev), amb_idx, amb_edge)
    return edge.reshape(frames, m, no), overflow


def _min_d2_rows(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """(B, A) min d² over all point pairs of (3, B, A, cap) planes, a row
    of `pa` at a time, so the transients are (B, A, cap) planes and never
    (B, A, cap, cap). d² rounds as the JAX package's row scan (inside
    lax.scan) on the CPU, fma(z, z, fma(y, y, x·x)), found by crafted
    knife-edge pairs (tools/knife_cases.py)."""
    mind2 = None
    for k in range(pa.shape[-1]):
        d2 = pa[0, ..., k, None] - pb[0]
        d2.mul_(d2)
        for ax in (1, 2):
            d = pa[ax, ..., k, None] - pb[ax]
            d2.addcmul_(d, d)
        row = d2.amin(-1)
        mind2 = row if mind2 is None else torch.minimum(mind2, row)
    return mind2


def _connected_components(nbr, edge, rounds: int = 64) -> torch.Tensor:
    """Min-label propagation + pointer jumping over the cell graph: nbr
    and edge (B, M, 124); (B, M) root cell ids (each component's minimum
    cell id). All `rounds` rounds run; a fixpoint stays put."""
    frames, m, no = nbr.shape
    # int64 labels index the gathers directly (they are cell ids < M)
    labels = torch.arange(m, device=nbr.device).expand(frames, m)
    flat = nbr.reshape(frames, m * no).long()
    for _ in range(rounds):
        nl = torch.where(edge, labels.gather(1, flat).reshape(frames, m, no),
                         _IMAX)
        new = torch.minimum(labels, nl.amin(-1))
        new = new.gather(1, new)
        labels = new.gather(1, new)
    return labels.gather(1, labels).to(_I32)


def cluster(xyz: torch.Tensor, valid: torch.Tensor,
            cfg: ClusteringConfig, pcfg: PipelineConfig) -> ClusteringResult:
    """Cluster the valid points of padded clouds into compact labels.

    xyz (B, N, 3) float32 and valid (B, N) bool (e.g. the OBSTACLE mask),
    or one frame without the B. Labels come back in the ORIGINAL point
    order: ids 0..L-1 by each cluster's minimum point index,
    CLUSTER_INVALID for size-filtered clusters, CLUSTER_UNDEFINED for
    invalid or padded entries; num_clusters and overflow per frame.
    """
    if xyz.dim() == 2:
        return frame_of(cluster(xyz[None], valid[None], cfg, pcfg), 0)
    frames, n = xyz.shape[:2]
    dev = xyz.device
    m = pcfg.max_cells
    r2 = cfg.distance_squared

    # ---- cell coordinates relative to each frame's masked min corner ----
    pmin = torch.where(valid[..., None], xyz, _F_BIG).amin(1, keepdim=True)
    pmin = torch.where(torch.isfinite(pmin), pmin, 0.0)
    # a true f32 division by f32(h), as the JAX package divides; the clamp
    # keeps the int cast defined (and saturating) for any finite input
    rel = torch.floor((xyz - pmin) / _f32(math.sqrt(r2 / 3.0), dev))
    rel = torch.clamp(rel, -2.0 ** 31, 2.0 ** 31 - 128).to(_I32)
    lim = _limits(dev)
    coord_overflow = (valid & ((rel < 0) | (rel >= lim)).any(-1)).sum(
        1, keepdim=True, dtype=_I32)
    rel = torch.minimum(torch.clamp(rel, min=0), lim - 1)
    key = torch.where(valid, _pack_key(rel[..., 0], rel[..., 1],
                                       rel[..., 2]), _IMAX)

    # ---- stable sort by key; valid points first -------------------------
    iota = torch.arange(n, dtype=_I32, device=dev).expand(frames, n)
    sk, sx, sy, sz, sorig = sort_by(key, xyz[..., 0], xyz[..., 1],
                                    xyz[..., 2], iota)
    sp = torch.stack([sx, sy, sz], -1)
    svalid = sk != _IMAX

    tbl, cid = _build_cells(sp, sk, sorig, svalid, m)
    pos, certain, ambiguous = _classify_pairs(tbl, r2, m)
    edge_amb, amb_overflow = _resolve_ambiguous(
        sp, tbl, pos, ambiguous, r2, pcfg.cell_capacity,
        pcfg.max_ambiguous_pairs)
    roots = _connected_components(pos, certain | edge_amb)

    # ---- component stats, size filter, canonical numbering --------------
    slot = torch.arange(m, dtype=_I32, device=dev)
    slot_valid = slot < tbl.num_cells
    comp_size = scatter_drop(m, roots, torch.where(slot_valid, tbl.counts, 0),
                             0, "sum")
    comp_min = scatter_drop(m, roots,
                            torch.where(slot_valid, tbl.min_orig, _IMAX),
                            _IMAX, "amin")
    is_root = slot_valid & (roots == slot)
    max_sz = min(cfg.max_cluster_size, 2 ** 31 - 1)
    comp_valid = (is_root & (comp_size >= cfg.min_cluster_size)
                  & (comp_size <= max_sz))
    rank_key = torch.where(comp_valid, comp_min, _IMAX)
    rorder = torch.argsort(rank_key, dim=1, stable=True)
    ranks = torch.empty_like(rank_key).scatter_(1, rorder,
                                                slot.expand(frames, m))
    num_clusters = comp_valid.sum(1, dtype=_I32)
    root_label = torch.where(comp_valid, ranks, CLUSTER_INVALID)

    # ---- per-point labels back in original order ------------------------
    pt_label = torch.where(svalid, take(root_label, take(roots, cid)),
                           CLUSTER_UNDEFINED)
    labels = set_drop(torch.full((frames, n), CLUSTER_UNDEFINED, dtype=_I32,
                                 device=dev), sorig, pt_label)
    overflow = tbl.overflow + amb_overflow + coord_overflow
    return ClusteringResult(labels, num_clusters, overflow[:, 0])
