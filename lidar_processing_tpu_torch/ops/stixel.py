"""Exact Euclidean clustering via stixel-graph connected components.

Port of ``lidar_processing_tpu/ops/stixel.py`` (the reference's KD-tree +
BFS FEC, ref: src/clustering.cpp:47-125, as exact connected components of
the d² <= distance_squared radius graph, labels canonicalised by minimum
original point index). The algorithm and every static cap are the JAX
package's, step for step:

  1. ONE sort of all points by (xy-column, z-cell) key; cells are
     h = R/sqrt(3) cubes, so every cell is a clique of the radius graph.
  2. Intra-column links between consecutive cells, verified by batched
     block min-distance tests (kernels/min_d2.py).
  3. Cells chained by verified (i, i+1) links contract into supernodes.
  4. Inter-column candidate pairs from one sort-merge of column keys and
     12 xy offsets, expanded to supernode pairs in static tiers.
  5. AABB / representative-point prefilters, then tiered exact tests.
  6. Connected components over the supernode graph (kernels/union_find.py).
  7. Size filter, canonical renumbering by min original index, writeback.

On CUDA tensors the two kernels are the hand-written Hopper ones; on CPU
tensors their plain twins. The port keeps the JAX package's fixed-shape,
cap-and-overflow formulation: no host syncs, no data-dependent shapes.
Where JAX relies on its indexing semantics the port spells them out:
``lax.dynamic_slice`` clamps its start, gathers clamp their indices, and
``mode="drop"`` scatters write into a buffer one slot longer whose last
(dump) slot is sliced off (ops/scan_utils.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import ClusteringConfig, PipelineConfig
from ..kernels.min_d2 import min_d2_planar
from ..kernels.union_find import cc_labels
from ..types import CLUSTER_INVALID, CLUSTER_UNDEFINED, ClusteringResult
from .scan_utils import IMAX as _IMAX
from .scan_utils import (compact_mask, dynamic_slice, scatter_drop,
                         scatter_min_rows, seg_broadcast_first, set_drop,
                         sort_by, take)

_I32 = torch.int32
_F_BIG = 1.0e9

# grid dims: 2048 x 2048 xy columns, 128 z cells (covers 500 m x 500 m x
# 31 m at the default radius; out-of-range coords raise overflow)
_GX = 2048
_GY = 2048
_GZ = 128

# the symmetric half of the 5x5 xy neighborhood (24 offsets total)
_XY_OFFSETS = [(0, 1), (0, 2), (1, -2), (1, -1), (1, 0), (1, 1), (1, 2),
               (2, -2), (2, -1), (2, 0), (2, 1), (2, 2)]

# exact-test tiers: (u-side cap, v-side cap, pair slots), first-fit in
# order, every pair oriented so u is the smaller side; slots sized to the
# 154-frame KITTI maxima with >=1.15x headroom (verbatim from the JAX
# package, whose comment records the measurements)
_TIERS_INTRA = ((8, 32, 2176), (8, 96, 64), (32, 96, 896),
                (96, 96, 192), (96, 288, 96), (288, 288, 64))
_TIERS_SNP = ((8, 32, 9216), (8, 96, 1152), (32, 96, 2688),
              (96, 96, 288), (96, 288, 1280), (288, 288, 512))
_CHUNK = 288
_CHUNK_GRID = 8
_CHUNK_PAIRS_INTRA = 64
_CHUNK_PAIRS_SNP = 512
# supernode-pair expansion band caps (widths 2, 4, 8, 16)
_E_CAPS = (10240, 3840, 512, 64)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of (..., 3) in XLA's order."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[k:] followed by k fill values."""
    return torch.cat([x[k:], x.new_full((k,), fill)])


class _SortedPoints(NamedTuple):
    xyz: torch.Tensor      # (NO,3) f32 key-sorted obstacle points
    key: torch.Tensor      # (NO,) i32 cell key; IMAX padding
    orig: torch.Tensor     # (NO,) i32 original indices
    n_obst: torch.Tensor   # ()
    overflow: torch.Tensor


def _cell_keys(xyz, inside, h: float):
    """(key, coord_bad) of the h-grid cell of every point; the grid origin
    is the min corner over `inside` points."""
    pmin = torch.where(inside[:, None], xyz, 3.4e38).amin(0)
    pmin = torch.where(torch.isfinite(pmin), pmin, 0.0)
    # f32(1/h), as jnp.float32(1.0 / h): cell keys at boundaries depend on it
    inv_h = torch.full((), 1.0 / h, dtype=torch.float32, device=xyz.device)
    rel = torch.floor((xyz - pmin) * inv_h).to(_I32)
    lim = torch.stack([torch.full((), v, dtype=_I32, device=xyz.device)
                       for v in (_GX, _GY, _GZ)])
    coord_bad = inside & ((rel < 0) | (rel >= lim)).any(1)
    rel = torch.minimum(torch.clamp(rel, min=0), lim - 1)
    key = (rel[:, 0] * _GY + rel[:, 1]) * _GZ + rel[:, 2]
    return key, coord_bad


def _sort_points(xyz, valid, pcfg: PipelineConfig, h: float) -> _SortedPoints:
    n = xyz.shape[0]
    no = pcfg.max_obstacle_points
    key, coord_bad = _cell_keys(xyz, valid, h)
    key = torch.where(valid & ~coord_bad, key, _IMAX)
    sk, sx, sy, sz, sorig = sort_by(key, xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                    _iota(n, xyz.device))
    n_obst = (key != _IMAX).sum(dtype=_I32)
    overflow = (coord_bad.sum(dtype=_I32)
                + torch.clamp(n_obst - no, min=0))
    sp = torch.stack([sx[:no], sy[:no], sz[:no]], dim=1)
    return _SortedPoints(sp, sk[:no], sorig[:no],
                         torch.clamp(n_obst, max=no), overflow)


class _CellTable(NamedTuple):
    start: torch.Tensor     # (M,) first point index; NO for empty slots
    end: torch.Tensor       # (M,)
    count: torch.Tensor     # (M,)
    iz: torch.Tensor        # (M,)
    col_id: torch.Tensor    # (M,)
    aabb: torch.Tensor      # (M,6) minx..maxz
    min_orig: torch.Tensor  # (M,)
    rep: torch.Tensor       # (M,3) first point of each cell (run start row)
    key: torch.Tensor       # (M,) full grid key
    n_cells: torch.Tensor
    overflow: torch.Tensor


def _pad_to(tensors, size: int, fills):
    """First `size` entries of each tensor, padded with its fill."""
    out = []
    for t, f in zip(tensors, fills):
        if size <= t.shape[0]:
            out.append(t[:size])
        else:
            out.append(torch.cat([t, t.new_full((size - t.shape[0],), f)]))
    return out


def _build_cells(sp: _SortedPoints, pcfg: PipelineConfig
                 ) -> Tuple[_CellTable, torch.Tensor]:
    """Cell/column run structure. Returns (cells, cell_id_per_point)."""
    no = sp.key.shape[0]
    m = pcfg.max_cells
    dev = sp.key.device
    valid = sp.key != _IMAX
    prev = torch.cat([sp.key.new_full((1,), -1), sp.key[:-1]])
    new_cell = valid & (sp.key != prev)
    cell_id = torch.cumsum(new_cell, 0, dtype=_I32) - 1
    n_cells = new_cell.sum(dtype=_I32)

    # run aggregates via ONE scatter-min into the cell table: min xyz /
    # -max xyz / min orig; padding rows go to the dump slot
    pack = torch.cat([sp.xyz, -sp.xyz, sp.orig[:, None].float()], dim=1)
    agg_c = scatter_min_rows(m, torch.where(valid, cell_id, m), pack,
                             _F_BIG)                        # (M,7)

    # run-start table with payloads riding the sort
    flagged = torch.where(new_cell, _iota(no, dev), _IMAX)
    sorted5 = sort_by(flagged, sp.key, sp.xyz[:, 0], sp.xyz[:, 1],
                      sp.xyz[:, 2])
    s_pos, s_key, s_x, s_y, s_z = _pad_to(sorted5, m,
                                          (_IMAX, _IMAX, 0.0, 0.0, 0.0))
    starts = torch.clamp(s_pos, max=no)
    slot = _iota(m, dev)
    slot_valid = slot < n_cells
    # end = start of the next cell (cells are consecutive in sorted order)
    nxt = torch.cat([starts[1:], starts.new_full((1,), no)])
    end = torch.where(slot_valid,
                      torch.where(slot == n_cells - 1, sp.n_obst, nxt), no)
    start = torch.where(slot_valid, starts, no)
    count = torch.clamp(end - start, min=0)

    cell_key = torch.where(slot_valid, s_key, _IMAX)
    cell_col = torch.where(slot_valid, s_key // _GZ, _IMAX)
    rep = torch.stack([s_x, s_y, s_z], dim=1)
    aabb = torch.cat([agg_c[:, 0:3], -agg_c[:, 3:6]], dim=1)
    min_orig = torch.where(slot_valid, agg_c[:, 6].to(_I32), _IMAX)
    overflow = torch.clamp(n_cells - m, min=0)
    tbl = _CellTable(start, end, count, cell_key % _GZ, cell_col, aabb,
                     min_orig, rep, cell_key, torch.clamp(n_cells, max=m),
                     overflow)
    return tbl, cell_id


def _stacked_windows(sp_xyz, starts, counts, fill: float, cap: int,
                     sr: int):
    """Gather contiguous runs as three planar (P, cap + sr) windows.

    Rows of sr points (one row gather fetches all three coordinates) cover
    [starts, starts + min(counts, cap)); lanes outside hold `fill`.
    """
    no = sp_xyz.shape[0]
    if cap % sr or no % sr:
        raise ValueError(f"window cap {cap} / buffer {no} not a multiple "
                         f"of {sr}")
    dev = sp_xyz.device
    view = torch.cat([sp_xyz[:, a].reshape(no // sr, sr) for a in range(3)],
                     dim=1)                               # (no/sr, 3*sr)
    width = cap + sr
    nrow = width // sr
    sr0 = starts // sr
    ridx = torch.clamp(sr0[:, None] + _iota(nrow, dev)[None, :], 0,
                       no // sr - 1)
    rows = view[ridx.long()]                              # (P, nrow, 3*sr)
    off = (starts - sr0 * sr)[:, None]
    aw = _iota(width, dev)[None, :]
    ok = (aw >= off) & (aw < off + torch.clamp(counts, max=cap)[:, None])
    p = starts.shape[0]
    return tuple(
        torch.where(ok, rows[:, :, a * sr:(a + 1) * sr].reshape(p, width),
                    fill)
        for a in range(3))


def _block_min_d2(sp_xyz, u_start, u_count, v_start, v_count,
                  u_cap: int, v_cap: int):
    """Exact min pairwise d² between contiguous point runs (batched).

    The u side is fetched in 8-point rows, the v side in 32-point rows;
    the (P, Wu, Wv) block runs in kernels/min_d2.py (the Hopper kernel on
    CUDA tensors, its plain twin on CPU tensors).
    """
    pu = _stacked_windows(sp_xyz, u_start, u_count, _F_BIG, u_cap, sr=8)
    pv = _stacked_windows(sp_xyz, v_start, v_count, -_F_BIG, v_cap, sr=32)
    return min_d2_planar(*pu, *pv)


class _PairTest(NamedTuple):
    """Candidate pair records awaiting exact point-level tests."""

    u_start: torch.Tensor
    u_count: torch.Tensor
    v_start: torch.Tensor
    v_count: torch.Tensor
    slot: torch.Tensor      # destination index in the result array
    active: torch.Tensor    # bool


def _tiered_exact(sp_xyz, pt: _PairTest, r2: float, n_results: int,
                  tiers=_TIERS_SNP, chunk_pairs: int = _CHUNK_PAIRS_SNP):
    """Run tiered block tests; scatter edge verdicts into (n_results,) bool.

    Every pair is oriented (u = smaller side) and assigned to the first
    tier that fits; pairs with a side beyond _CHUNK split into _CHUNK-point
    sub-pairs whose verdicts OR into the original slot; sides beyond
    _CHUNK * _CHUNK_GRID points, and tier slot excess, count as overflow.
    Returns (verdicts, overflow).
    """
    dev = sp_xyz.device
    maxc0 = torch.maximum(pt.u_count, pt.v_count)
    big = pt.active & (maxc0 > _CHUNK)
    bidx, n_big, ovf_b = compact_mask(big, chunk_pairs)
    bidx = bidx.long()
    bmask = _iota(chunk_pairs, dev) < n_big
    gch = _iota(_CHUNK_GRID, dev) * _CHUNK
    shp = (chunk_pairs, _CHUNK_GRID, _CHUNK_GRID)

    def grid(vals, axis):
        e = vals[:, None, :] if axis else vals[:, :, None]
        return e.expand(shp).reshape(-1)

    ch_uc2 = torch.clamp(pt.u_count[bidx][:, None] - gch[None, :], 0, _CHUNK)
    ch_vc2 = torch.clamp(pt.v_count[bidx][:, None] - gch[None, :], 0, _CHUNK)
    ch = _PairTest(
        u_start=grid(pt.u_start[bidx][:, None] + gch[None, :], 0),
        u_count=grid(ch_uc2, 0),
        v_start=grid(pt.v_start[bidx][:, None] + gch[None, :], 1),
        v_count=grid(ch_vc2, 1),
        slot=grid(pt.slot[bidx][:, None].expand(ch_uc2.shape), 0),
        active=(grid(bmask[:, None].expand(ch_uc2.shape), 0)
                & (grid(ch_uc2, 0) > 0) & (grid(ch_vc2, 1) > 0)))
    us_ = torch.cat([pt.u_start, ch.u_start])
    uc_ = torch.cat([torch.where(big, 0, pt.u_count), ch.u_count])
    vs_ = torch.cat([pt.v_start, ch.v_start])
    vc_ = torch.cat([torch.where(big, 0, pt.v_count), ch.v_count])
    slot_ = torch.cat([pt.slot, ch.slot])
    act_ = torch.cat([pt.active & ~big, ch.active])

    # orient every (possibly chunked) pair: u = smaller side
    swap = uc_ > vc_
    o_us = torch.where(swap, vs_, us_)
    o_uc = torch.where(swap, vc_, uc_)
    o_vs = torch.where(swap, us_, vs_)
    o_vc = torch.where(swap, uc_, vc_)

    # ONE sort by first-fit tier id packs every tier into a contiguous run
    n_t_all = len(tiers)
    tier_id = torch.full(o_uc.shape, n_t_all, dtype=_I32, device=dev)
    for t in range(n_t_all - 1, -1, -1):
        u_cap, v_cap, _ = tiers[t]
        fits = act_ & (o_uc <= u_cap) & (o_vc <= v_cap)
        tier_id = torch.where(fits, t, tier_id)
    # inactive rows sort last, after any unassigned-but-active rows
    tier_id = torch.where(act_, tier_id, n_t_all + 1)

    # pack (start, count) per side into one operand: starts < 2^17 and
    # active counts <= 288 < 512; inactive rows clamp (masked on read)
    _, s_usuc, s_vsvc, s_slot = sort_by(
        tier_id, o_us * 512 + torch.clamp(o_uc, max=511),
        o_vs * 512 + torch.clamp(o_vc, max=511), slot_)
    n_in_tier = [(tier_id == t).sum(dtype=_I32) for t in range(n_t_all)]
    starts = [torch.zeros((), dtype=_I32, device=dev)]
    for t in range(n_t_all):
        starts.append(starts[-1] + n_in_tier[t])

    overflow = ovf_b + (big & (maxc0 > _CHUNK * _CHUNK_GRID)).sum(dtype=_I32)
    # active pairs too big for every tier
    overflow = overflow + (tier_id == n_t_all).sum(dtype=_I32)
    tgts = []
    for t, (u_cap, v_cap, slots) in enumerate(tiers):
        n_t = n_in_tier[t]
        overflow = overflow + torch.clamp(n_t - slots, min=0)
        tier_active = _iota(slots, dev) < n_t
        usuc = dynamic_slice(s_usuc, starts[t], slots)
        vsvc = dynamic_slice(s_vsvc, starts[t], slots)
        us = torch.where(tier_active, usuc >> 9, 0)
        uc = torch.where(tier_active, usuc & 511, 0)
        vs = torch.where(tier_active, vsvc >> 9, 0)
        vc = torch.where(tier_active, vsvc & 511, 0)
        mind2 = _block_min_d2(sp_xyz, us, uc, vs, vc, u_cap, v_cap)
        verdict = tier_active & (mind2 <= r2)
        slot = dynamic_slice(s_slot, starts[t], slots)
        tgts.append(torch.where(verdict, slot, n_results))
    # ONE verdict scatter for all tiers
    out = set_drop(torch.zeros(n_results, dtype=torch.bool, device=dev),
                  torch.cat(tgts), True)
    return out, overflow


class _SnTable(NamedTuple):
    start: torch.Tensor       # (S,) first point index
    count: torch.Tensor       # (S,) point count
    aabb: torch.Tensor        # (S,6)
    rep: torch.Tensor         # (S,3) first point (bottom cell's first row)
    rep2: torch.Tensor        # (S,3) TOP cell's first point
    min_orig: torch.Tensor    # (S,)
    first_cell: torch.Tensor  # (S,) first cell id
    n_sn: torch.Tensor
    overflow: torch.Tensor


def _build_supernodes(sp, cells: _CellTable, link1: torch.Tensor,
                      pcfg: PipelineConfig
                      ) -> Tuple[_SnTable, torch.Tensor]:
    """Contract link1-chained cells into supernodes.

    link1: (M,) bool — verified connection between cell i and cell i+1.
    Returns (table, sn_id_per_cell).
    """
    m = cells.start.shape[0]
    s = pcfg.max_supernodes
    no = sp.key.shape[0]
    dev = link1.device
    slot_valid = _iota(m, dev) < cells.n_cells
    prev_link = torch.cat([link1.new_zeros(1), link1[:-1]])
    new_sn = slot_valid & ~prev_link
    new_sn = torch.cat([slot_valid[:1], new_sn[1:]])
    sn_of_cell = torch.cumsum(new_sn, 0, dtype=_I32) - 1
    n_sn = new_sn.sum(dtype=_I32)

    # per-supernode aggregates via ONE scatter-min over the cell table
    pack = torch.cat([cells.aabb[:, 0:3], -cells.aabb[:, 3:6],
                      cells.min_orig[:, None].float()], dim=1)
    agg_s = scatter_min_rows(s, torch.where(slot_valid, sn_of_cell, s),
                             pack, _F_BIG)                # (S,7)

    # run-start table with payloads (first cell's point start + rep)
    flagged = torch.where(new_sn, _iota(m, dev), _IMAX)
    sorted5 = sort_by(flagged, cells.start, cells.rep[:, 0],
                      cells.rep[:, 1], cells.rep[:, 2])
    f_pos, f_start, f_rx, f_ry, f_rz = _pad_to(sorted5, s,
                                               (_IMAX, no, 0.0, 0.0, 0.0))
    first_cell = torch.clamp(f_pos, max=m)
    sidx = _iota(s, dev)
    sn_valid = sidx < n_sn
    nxt_first = torch.cat([first_cell[1:], first_cell.new_full((1,), m)])
    last_cell = torch.where(sidx == n_sn - 1, cells.n_cells, nxt_first) - 1
    lc = torch.clamp(last_cell, 0, m - 1).long()

    start = torch.where(sn_valid, f_start, no)
    end = torch.where(sn_valid, cells.end[lc], no)
    count = torch.clamp(end - start, min=0)
    aabb = torch.cat([agg_s[:, 0:3], -agg_s[:, 3:6]], dim=1)
    min_orig = torch.where(sn_valid, agg_s[:, 6].to(_I32), _IMAX)
    rep = torch.stack([f_rx, f_ry, f_rz], dim=1)
    # second rep at the supernode's TOP cell (z-top probe)
    rep2 = cells.rep[lc]
    overflow = torch.clamp(n_sn - s, min=0)
    tbl = _SnTable(start, count, aabb, rep, rep2, min_orig, first_cell,
                   torch.clamp(n_sn, max=s), overflow)
    return tbl, sn_of_cell


def _column_pairs(col_key, n_cols, col_info, pcfg: PipelineConfig):
    """Sort-merge the 12-offset probes against occupied column keys.

    Returns (u_info, v_info, n_pairs, overflow): the `col_info` payloads
    of both sides of every pair of occupied columns whose xy cells are
    5x5-window neighbors. The merge key is column_key * 2 + is_probe, so
    one sort both merges and orders each host before its probes.
    """
    c = col_key.shape[0]
    cp = pcfg.max_column_pairs
    dev = col_key.device
    col_valid = _iota(c, dev) < n_cols
    ix = col_key // _GY
    iy = col_key % _GY

    probe_keys = []
    for dx, dy in _XY_OFFSETS:
        nx2, ny2 = ix + dx, iy + dy
        ok = col_valid & (nx2 >= 0) & (nx2 < _GX) & (ny2 >= 0) & (ny2 < _GY)
        probe_keys.append(torch.where(ok, (nx2 * _GY + ny2) * 2 + 1, _IMAX))
    keys = torch.cat([torch.where(col_valid, col_key * 2, _IMAX),
                      *probe_keys])
    infos = col_info.repeat(len(_XY_OFFSETS) + 1)
    sk2, si2 = sort_by(keys, infos)
    # a probe hits when its equal-column run starts with a host; the
    # host's info is broadcast over the run
    kcol = sk2 >> 1
    is_host = (sk2 != _IMAX) & ((sk2 & 1) == 0)
    hit = (~is_host & (sk2 != _IMAX)
           & seg_broadcast_first(is_host, kcol))
    hinfo_bcast = seg_broadcast_first(torch.where(is_host, si2, 0), kcol)

    _, ui_s, vi_s = sort_by((~hit).to(_I32), si2,
                            torch.where(hit, hinfo_bcast, 0))
    n_pairs = hit.sum(dtype=_I32)
    ovf = torch.clamp(n_pairs - cp, min=0)
    n_pairs = torch.clamp(n_pairs, max=cp)
    live = _iota(cp, dev) < n_pairs
    u_info = torch.where(live, ui_s[:cp], 0)
    v_info = torch.where(live, vi_s[:cp], 0)
    return u_info, v_info, n_pairs, ovf


def cluster(xyz: torch.Tensor, valid: torch.Tensor,
            cfg: ClusteringConfig, pcfg: PipelineConfig) -> ClusteringResult:
    """Cluster valid points of a padded cloud (see module docstring)."""
    n = xyz.shape[0]
    h = math.sqrt(cfg.distance_squared / 3.0)
    sp = _sort_points(xyz, valid, pcfg, h)
    pt_label, num_clusters, overflow = _cluster_core(sp, cfg, pcfg)
    pt_valid = sp.key != _IMAX
    out = set_drop(torch.full((n,), CLUSTER_UNDEFINED, dtype=_I32,
                             device=xyz.device),
                  torch.where(pt_valid, sp.orig, n), pt_label)
    return ClusteringResult(out, num_clusters, overflow)


class FusedClusterOut(NamedTuple):
    """cluster_fused output: clustering + segmentation labels in original
    order, plus the cell-key-sorted obstacle arrays for the hull stage."""

    result: ClusteringResult      # cluster labels in ORIGINAL point order
    seg_labels: torch.Tensor      # (N,) i32 seg labels in ORIGINAL order
    sorted_xyz: torch.Tensor      # (NO,3) cell-key-sorted obstacle points
    sorted_label: torch.Tensor    # (NO,) cluster label per sorted row
    sorted_orig: torch.Tensor     # (NO,) original index per sorted row


def _sort_points_full(xyz, obstacle, point_valid, orig, seg_labels,
                      pcfg: PipelineConfig, h: float):
    """_sort_points variant that keeps the FULL permutation.

    Obstacle points sort first (by cell key), then remaining valid points
    (key IMAX - 1), then padding (IMAX). orig (< 2^17) and the 2-bit seg
    label pack into one operand (orig * 4 + seg).
    Returns (sp, key_full, orig4_full, seg_full).
    """
    no = pcfg.max_obstacle_points
    key, coord_bad = _cell_keys(xyz, obstacle, h)
    rest = torch.where(point_valid, _IMAX - 1, _IMAX).to(_I32)
    key = torch.where(obstacle & ~coord_bad, key, rest)
    orig4 = orig * 4 + seg_labels
    sk, sx, sy, sz, so4 = sort_by(key, xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                  orig4)
    n_obst = (key < _IMAX - 1).sum(dtype=_I32)
    overflow = (coord_bad.sum(dtype=_I32)
                + torch.clamp(n_obst - no, min=0))
    slice_key = torch.where(_iota(no, xyz.device) < n_obst, sk[:no], _IMAX)
    sp = _SortedPoints(torch.stack([sx[:no], sy[:no], sz[:no]], dim=1),
                       slice_key, so4[:no] >> 2,
                       torch.clamp(n_obst, max=no), overflow)
    return sp, sk, so4, so4 & 3


def cluster_fused(xyz_s, obstacle_s, point_valid_s, orig_s, seg_labels_s,
                  cfg: ClusteringConfig, pcfg: PipelineConfig
                  ) -> FusedClusterOut:
    """Fused clustering over a pre-sorted segmented cloud.

    Inputs live in gpf_segment_sorted's (partition, z) space; orig_s
    carries the original index. Both stages' labels return to original
    order with ONE sort on the packed orig*4+seg key, and the
    cell-key-sorted obstacle arrays feed the hull stage directly.
    """
    n = xyz_s.shape[0]
    no = pcfg.max_obstacle_points
    h = math.sqrt(cfg.distance_squared / 3.0)
    sp, key_full, orig_full, _ = _sort_points_full(
        xyz_s, obstacle_s, point_valid_s, orig_s, seg_labels_s, pcfg, h)
    pt_label, num_clusters, overflow = _cluster_core(sp, cfg, pcfg)

    pt_valid = sp.key != _IMAX
    cl_plus2 = torch.cat([torch.where(pt_valid, pt_label + 2, 0),
                          pt_label.new_zeros(n - no)])
    cl_plus2 = torch.where(key_full != _IMAX, cl_plus2, 0)
    # orig_full = orig*4+seg is strictly increasing in orig: sorting on it
    # unsorts and delivers the seg labels in its low bits
    so4, out_cl = sort_by(orig_full, cl_plus2)
    seg_out = so4 & 3
    cl_out = torch.where(out_cl == 0, CLUSTER_UNDEFINED, out_cl - 2)
    return FusedClusterOut(
        ClusteringResult(cl_out, num_clusters, overflow), seg_out,
        sp.xyz, torch.where(pt_valid, pt_label, CLUSTER_UNDEFINED), sp.orig)


def _pair_gap_d2(u_aabb, v_aabb):
    gap = torch.clamp(torch.maximum(u_aabb[:, 0:3] - v_aabb[:, 3:6],
                                    v_aabb[:, 0:3] - u_aabb[:, 3:6]), min=0.0)
    return _sum3(gap * gap)


def _d2(a, b):
    d = a - b
    return _sum3(d * d)


def _cluster_core(sp: _SortedPoints, cfg: ClusteringConfig,
                  pcfg: PipelineConfig):
    """Shared clustering core over a sorted obstacle buffer.

    Returns (pt_label (NO,) labels per sorted row, num_clusters, overflow).
    """
    r2 = cfg.distance_squared
    m = pcfg.max_cells
    s_cap = pcfg.max_supernodes
    dev = sp.key.device

    cells, cell_id_pt = _build_cells(sp, pcfg)
    overflow = sp.overflow + cells.overflow

    # ---- intra-column candidate links (dense shifted comparisons) --------
    slot_valid = _iota(m, dev) < cells.n_cells
    intra_link, intra_tests = {}, []
    for k in (1, 2):
        same_col = cells.col_id == _shift(cells.col_id, k, _IMAX)
        diz = _shift(cells.iz, k, 0) - cells.iz
        cand = (slot_valid & _shift(slot_valid, k, False) & same_col
                & (diz >= 1) & (diz <= 2))
        impossible = _pair_gap_d2(cells.aabb,
                                  torch.roll(cells.aabb, -k, 0)) > r2
        certain = _d2(cells.rep, torch.roll(cells.rep, -k, 0)) <= r2
        intra_link[k] = cand & ~impossible & certain
        intra_tests.append(cand & ~impossible & ~certain)

    # ---- exact tests of the ambiguous intra-column pairs ----------------
    # results layout: [0, M) link1 candidates, [M, 2M) link2 candidates
    pt = _PairTest(
        u_start=torch.cat([cells.start, cells.start]),
        u_count=torch.cat([cells.count, cells.count]),
        v_start=torch.cat([torch.roll(cells.start, -1),
                           torch.roll(cells.start, -2)]),
        v_count=torch.cat([torch.roll(cells.count, -1),
                           torch.roll(cells.count, -2)]),
        slot=_iota(2 * m, dev),
        active=torch.cat(intra_tests))
    intra_verdict, ovf_t = _tiered_exact(
        sp.xyz, pt, r2, 2 * m, tiers=_TIERS_INTRA,
        chunk_pairs=_CHUNK_PAIRS_INTRA)
    overflow = overflow + ovf_t
    link1 = intra_link[1] | intra_verdict[:m]
    link2 = intra_link[2] | intra_verdict[m:2 * m]

    # ---- supernodes ------------------------------------------------------
    sn, sn_of_cell = _build_supernodes(sp, cells, link1, pcfg)
    overflow = overflow + sn.overflow

    # link2 edges crossing a supernode boundary
    sn_p2 = torch.roll(sn_of_cell, -2)
    link2_edge = link2 & (sn_p2 != sn_of_cell)
    e2_u = torch.where(link2_edge, sn_of_cell, 0)
    e2_v = torch.where(link2_edge, sn_p2, 0)

    # ---- column table + pair generation ---------------------------------
    c_cap = pcfg.max_columns
    prev_col_c = torch.cat([cells.col_id.new_full((1,), -1),
                            cells.col_id[:-1]])
    new_col_c = slot_valid & (cells.col_id != prev_col_c)
    n_cols = new_col_c.sum(dtype=_I32)
    flagged_c = torch.where(new_col_c, _iota(m, dev), _IMAX)
    c_pos, c_key, c_sn = _pad_to(
        sort_by(flagged_c, cells.key, sn_of_cell), c_cap,
        (_IMAX, _IMAX, _IMAX))
    col_first_cell = torch.clamp(c_pos, max=m)
    cidx = _iota(c_cap, dev)
    col_valid = cidx < n_cols
    col_key = torch.where(col_valid, c_key // _GZ, _IMAX)
    col_first_sn = torch.where(col_valid, c_sn, 0)
    nxt_col_first = torch.cat([col_first_cell[1:],
                               col_first_cell.new_full((1,), m)])
    col_last_cell = torch.where(cidx == n_cols - 1, cells.n_cells,
                                nxt_col_first) - 1
    col_last_sn = torch.where(col_valid,
                              take(sn_of_cell, col_last_cell), -1)
    col_sn_count = torch.where(col_valid, col_last_sn - col_first_sn + 1, 0)
    overflow = overflow + torch.clamp(n_cols - c_cap, min=0)
    overflow = overflow + (col_sn_count > 16).sum(dtype=_I32)

    # packed per-column payload (first_sn * 32 + min(count, 31)), carried
    # through the pair merge sorts
    col_info = col_first_sn * 32 + torch.clamp(col_sn_count, max=31)
    pa, pb, n_cpairs, ovf_cp = _column_pairs(
        col_key, n_cols, col_info, pcfg)
    overflow = overflow + ovf_cp

    # ---- expand column pairs to supernode pairs -------------------------
    cp = pcfg.max_column_pairs
    snp = pcfg.max_sn_pairs
    cp_valid = _iota(cp, dev) < n_cpairs
    cA = torch.where(cp_valid, pa % 32, 0)
    cB = torch.where(cp_valid, pb % 32, 0)
    # primary slot: first supernode of each column
    prim_u, prim_v = pa // 32, pb // 32
    prim_ok = cp_valid & (cA >= 1) & (cB >= 1)

    # four-level multi-supernode expansion: ONE sort packs the pairs into
    # class bands (one per expansion width), each read by a dynamic slice
    mx = torch.maximum(cA, cB)
    cls = torch.where(mx <= 8, 3, torch.full_like(mx, 4))
    cls = torch.where(mx <= 4, 2, cls)
    cls = torch.where(mx == 2, 1, cls)
    cls = torch.where(mx <= 1, 5, cls)
    cls = torch.where(cp_valid, cls, 6)
    ck, spa, spb = sort_by(cls, pa, pb)
    n_cls = [(ck == k).sum(dtype=_I32) for k in (1, 2, 3, 4)]
    offs = [torch.zeros((), dtype=_I32, device=dev)]
    for k in range(4):
        offs.append(offs[-1] + n_cls[k])
    pad_sl = spa.new_zeros(max(_E_CAPS))
    spa_p = torch.cat([spa, pad_sl])
    spb_p = torch.cat([spb, pad_sl])

    def expand_band(band, width):
        cap = _E_CAPS[band]
        a = dynamic_slice(spa_p, offs[band], cap)
        b = dynamic_slice(spb_p, offs[band], cap)
        nb = n_cls[band]
        act = _iota(cap, dev) < torch.clamp(nb, max=cap)
        muA, mcA = a // 32, torch.where(act, a % 32, 0)
        muB, mcB = b // 32, torch.where(act, b % 32, 0)
        g = _iota(width, dev)
        shp = (cap, width, width)
        eu = (muA[:, None, None] + g[None, :, None]).expand(shp).reshape(-1)
        ev = (muB[:, None, None] + g[None, None, :]).expand(shp).reshape(-1)
        ca = torch.clamp(mcA, max=width)[:, None, None]
        cb = torch.clamp(mcB, max=width)[:, None, None]
        eok = ((g[None, :, None] < ca) & (g[None, None, :] < cb)
               & ((g[None, :, None] > 0) | (g[None, None, :] > 0))
               ).reshape(-1)
        return eu, ev, eok, torch.clamp(nb - cap, min=0)

    bands = [expand_band(b, w) for b, w in enumerate((2, 4, 8, 16))]
    for *_, ovf in bands:
        overflow = overflow + ovf
    # assemble the supernode pair list, valid pairs packed to the front by
    # ONE sort (a single packed int32 key when supernode ids fit 15 bits)
    all_u = torch.cat([prim_u] + [b[0] for b in bands])
    all_v = torch.cat([prim_v] + [b[1] for b in bands])
    all_ok = torch.cat([prim_ok] + [b[2] for b in bands])
    n_snp = all_ok.sum(dtype=_I32)
    overflow = overflow + torch.clamp(n_snp - snp, min=0)
    n_snp = torch.clamp(n_snp, max=snp)
    snp_valid = _iota(snp, dev) < n_snp
    if s_cap <= (1 << 15):
        key = torch.where(all_ok, all_u * (1 << 15) + all_v, 1 << 30)
        skey = torch.sort(key).values[:snp]
        pu = torch.where(snp_valid, skey >> 15, 0)
        pv = torch.where(snp_valid, skey & ((1 << 15) - 1), 0)
    else:
        _, su_, sv_ = sort_by((~all_ok).to(_I32), all_u, all_v)
        pu = torch.where(snp_valid, su_[:snp], 0)
        pv = torch.where(snp_valid, sv_[:snp], 0)

    # ---- classify supernode pairs ---------------------------------------
    # one row gather per side: [aabb(6), rep(3), rep2(3), start, count]
    sn_rows = torch.cat([sn.aabb, sn.rep, sn.rep2,
                         sn.start[:, None].float(),
                         sn.count[:, None].float()], dim=1)  # (S,14)
    ru = take(sn_rows, pu)
    rv = take(sn_rows, pv)
    impossible = _pair_gap_d2(ru[:, 0:6], rv[:, 0:6]) > r2
    # 4 rep-pair probes (bottom/top x bottom/top): any hit connects the
    # pair for certain without a block test
    certain = ((_d2(ru[:, 6:9], rv[:, 6:9]) <= r2)
               | (_d2(ru[:, 6:9], rv[:, 9:12]) <= r2)
               | (_d2(ru[:, 9:12], rv[:, 6:9]) <= r2)
               | (_d2(ru[:, 9:12], rv[:, 9:12]) <= r2))
    ambiguous = snp_valid & ~impossible & ~certain
    pair_certain = snp_valid & ~impossible & certain

    pt2 = _PairTest(
        u_start=ru[:, 12].to(_I32), u_count=ru[:, 13].to(_I32),
        v_start=rv[:, 12].to(_I32), v_count=rv[:, 13].to(_I32),
        slot=_iota(snp, dev), active=ambiguous)
    snp_verdict, ovf_t2 = _tiered_exact(sp.xyz, pt2, r2, snp,
                                           tiers=_TIERS_SNP)
    overflow = overflow + ovf_t2
    snp_edge = pair_certain | snp_verdict

    # ---- edge list, compacted by one sort --------------------------------
    e_u0 = torch.cat([torch.where(snp_edge, pu, 0), e2_u])
    e_v0 = torch.cat([torch.where(snp_edge, pv, 0), e2_v])
    e_ok0 = torch.cat([snp_edge, link2_edge])
    n_edges = e_ok0.sum(dtype=_I32)
    ec = min(pcfg.max_edges, e_u0.shape[0])
    overflow = overflow + torch.clamp(n_edges - ec, min=0)
    n_edges = torch.clamp(n_edges, max=ec)
    e_ok = _iota(ec, dev) < n_edges
    if s_cap <= (1 << 15):
        ekey = torch.where(e_ok0, e_u0 * (1 << 15) + e_v0, 1 << 30)
        sek = torch.sort(ekey).values[:ec]
        e_u = torch.where(e_ok, sek >> 15, 0)
        e_v = torch.where(e_ok, sek & ((1 << 15) - 1), 0)
    else:
        _, se_u, se_v = sort_by((~e_ok0).to(_I32),
                                torch.where(e_ok0, e_u0, 0),
                                torch.where(e_ok0, e_v0, 0))
        e_u = torch.where(e_ok, se_u[:ec], 0)
        e_v = torch.where(e_ok, se_v[:ec], 0)

    # ---- connected components on the supernode graph --------------------
    sn_valid_mask = _iota(s_cap, dev) < sn.n_sn
    labels = cc_labels(e_u, e_v, n_edges, s_cap)

    # ---- stats, size filter, canonical numbering ------------------------
    tgt = torch.where(sn_valid_mask, labels, s_cap)
    comp_size = scatter_drop(s_cap, tgt,
                            torch.where(sn_valid_mask, sn.count, 0), 0, "sum")
    comp_min = scatter_drop(s_cap, tgt, sn.min_orig, _IMAX, "amin")
    sidx = _iota(s_cap, dev)
    is_root = sn_valid_mask & (labels == sidx)
    max_sz = min(cfg.max_cluster_size, 2 ** 31 - 1)
    comp_valid = (is_root & (comp_size >= cfg.min_cluster_size)
                  & (comp_size <= max_sz))

    rank_key = torch.where(comp_valid, comp_min, _IMAX)
    rorder = torch.argsort(rank_key, stable=True)
    ranks = torch.empty_like(sidx).scatter_(0, rorder, sidx)
    num_clusters = comp_valid.sum(dtype=_I32)
    root_label = torch.where(comp_valid, ranks, CLUSTER_INVALID)

    # ---- per-point labels over the sorted buffer ------------------------
    # cell labels land on each cell's RUN START, then a segmented
    # broadcast spreads them over the cell's points
    sn_label = root_label[labels.long()]                        # (S,)
    cell_label = take(sn_label, sn_of_cell)                    # (M,)
    pt_valid = sp.key != _IMAX
    seed_lab = set_drop(torch.full((sp.key.shape[0],), CLUSTER_UNDEFINED,
                                  dtype=_I32, device=dev),
                       cells.start, cell_label)   # empty slots: dropped
    pt_label = torch.where(pt_valid,
                           seg_broadcast_first(seed_lab, cell_id_pt),
                           CLUSTER_UNDEFINED)
    return pt_label, num_clusters, overflow
