"""Exact Euclidean clustering via stixel-graph connected components.

Port of ``lidar_processing_tpu/ops/stixel.py`` (the reference's KD-tree +
BFS FEC, ref: src/clustering.cpp:47-125, as exact connected components of
the d² <= distance_squared radius graph, labels canonicalised by minimum
original point index). The algorithm and every static cap are the JAX
package's, step for step:

  1. ONE sort of all points by (xy-column, z-cell) key; cells are
     h = R/sqrt(3) cubes, so every cell is a clique of the radius graph.
  2. Intra-column links between consecutive cells, verified by batched
     block min-distance tests (kernels/tier_min_d2.py).
  3. Cells chained by verified (i, i+1) links contract into supernodes.
  4. Inter-column candidate pairs from one sort-merge of column keys and
     12 xy offsets, expanded to supernode pairs in static tiers.
  5. AABB / representative-point prefilters, then tiered exact tests.
  6. Connected components over the supernode graph (kernels/union_find.py).
  7. Size filter, canonical renumbering by min original index, writeback.

Every stage runs on a leading frame axis B (the JAX package's vmap over
frames, written out): tables are (B, slots[, width]), every sort, gather,
scatter, roll and count works along the slot axis of each frame, and a
per-frame scalar (a count, an overflow counter) is a (B, 1) column that
broadcasts against its frame's row. Frame b of a batch gives bit for bit
what it gives alone; the per-frame entry points are the batch of one.

On CUDA tensors the two kernels are the hand-written Hopper ones (one
tier_min_d2 launch per tier table, one union_find launch, each for all B
frames); on CPU tensors their plain twins. The port keeps the JAX
package's fixed-shape, cap-and-overflow formulation: no host syncs, no
data-dependent shapes. Where JAX relies on its indexing semantics the port
spells them out: ``lax.dynamic_slice`` clamps its start, gathers clamp
their indices, and ``mode="drop"`` scatters write into a row one slot
longer whose last (dump) slot is sliced off (ops/scan_utils.py).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..config import ClusteringConfig, PipelineConfig
# _stacked_windows is re-exported: the probes' tests compare the pair
# kernel with the clustering path's window gather under this name
from ..kernels.tier_min_d2 import (_stacked_windows, tier_min_d2,  # noqa: F401
                                   tier_slices, tier_windows)
from ..kernels.union_find import cc_labels
from ..types import (CLUSTER_INVALID, CLUSTER_UNDEFINED, ClusteringResult,
                     frame_of)
from .scan_utils import IMAX as _IMAX
from .scan_utils import (compact_mask, dynamic_slice, scatter_drop,
                         scatter_min_rows, seg_broadcast_first, set_drop,
                         sort_by, sum_sq3, take, take_rows)

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


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Each frame's count of True as a (B, 1) int32 column."""
    return mask.sum(-1, keepdim=True, dtype=_I32)


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Each row's x[k:] followed by k fill values."""
    return torch.cat([x[:, k:], x.new_full((x.shape[0], k), fill)], 1)


def _before(x: torch.Tensor, fill) -> torch.Tensor:
    """One fill value followed by each row's x[:-1] (the previous slot's)."""
    return torch.cat([x.new_full((x.shape[0], 1), fill), x[:, :-1]], 1)


def _roll(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each frame's slots rolled back by k (slot i gets slot i + k): the
    slot axis, never the frame axis."""
    return torch.roll(x, -k, 1)


class _SortedPoints(NamedTuple):
    xyz: torch.Tensor      # (B,NO,3) f32 key-sorted obstacle points
    key: torch.Tensor      # (B,NO) i32 cell key; IMAX padding
    orig: torch.Tensor     # (B,NO) i32 original indices
    n_obst: torch.Tensor   # (B,1)
    overflow: torch.Tensor


def _cell_keys(xyz, inside, h: float):
    """(key, coord_bad) of the h-grid cell of every point; each frame's
    grid origin is the min corner over its `inside` points."""
    pmin = torch.where(inside[..., None], xyz, 3.4e38).amin(1, keepdim=True)
    pmin = torch.where(torch.isfinite(pmin), pmin, 0.0)
    # f32(1/h), as jnp.float32(1.0 / h): cell keys at boundaries depend on it
    inv_h = torch.full((), 1.0 / h, dtype=torch.float32, device=xyz.device)
    rel = torch.floor((xyz - pmin) * inv_h).to(_I32)
    lim = torch.stack([torch.full((), v, dtype=_I32, device=xyz.device)
                       for v in (_GX, _GY, _GZ)])
    coord_bad = inside & ((rel < 0) | (rel >= lim)).any(-1)
    rel = torch.minimum(torch.clamp(rel, min=0), lim - 1)
    key = (rel[..., 0] * _GY + rel[..., 1]) * _GZ + rel[..., 2]
    return key, coord_bad


def _sort_points(xyz, valid, pcfg: PipelineConfig, h: float) -> _SortedPoints:
    frames, n = xyz.shape[:2]
    no = pcfg.max_obstacle_points
    key, coord_bad = _cell_keys(xyz, valid, h)
    key = torch.where(valid & ~coord_bad, key, _IMAX)
    sk, sx, sy, sz, sorig = sort_by(key, xyz[..., 0], xyz[..., 1],
                                    xyz[..., 2],
                                    _iota(n, xyz.device).expand(frames, n))
    n_obst = _count(key != _IMAX)
    overflow = _count(coord_bad) + torch.clamp(n_obst - no, min=0)
    sp = torch.stack([sx[:, :no], sy[:, :no], sz[:, :no]], dim=-1)
    return _SortedPoints(sp, sk[:, :no], sorig[:, :no],
                         torch.clamp(n_obst, max=no), overflow)


class _CellTable(NamedTuple):
    start: torch.Tensor     # (B,M) first point index; NO for empty slots
    end: torch.Tensor       # (B,M)
    count: torch.Tensor     # (B,M)
    iz: torch.Tensor        # (B,M)
    col_id: torch.Tensor    # (B,M)
    aabb: torch.Tensor      # (B,M,6) minx..maxz
    min_orig: torch.Tensor  # (B,M)
    rep: torch.Tensor       # (B,M,3) first point of each cell (run start)
    key: torch.Tensor       # (B,M) full grid key
    n_cells: torch.Tensor   # (B,1)
    overflow: torch.Tensor  # (B,1)


def _pad_to(tensors, size: int, fills):
    """Each row's first `size` entries of each tensor, padded with its
    fill."""
    out = []
    for t, f in zip(tensors, fills):
        if size <= t.shape[-1]:
            out.append(t[..., :size])
        else:
            out.append(torch.cat([t, t.new_full(
                (*t.shape[:-1], size - t.shape[-1]), f)], -1))
    return out


def _build_cells(sp: _SortedPoints, pcfg: PipelineConfig
                 ) -> Tuple[_CellTable, torch.Tensor]:
    """Cell/column run structure. Returns (cells, cell_id_per_point)."""
    no = sp.key.shape[1]
    m = pcfg.max_cells
    dev = sp.key.device
    valid = sp.key != _IMAX
    new_cell = valid & (sp.key != _before(sp.key, -1))
    cell_id = torch.cumsum(new_cell, 1, dtype=_I32) - 1
    n_cells = _count(new_cell)

    # run aggregates via ONE scatter-min into the cell table: min xyz /
    # -max xyz / min orig; padding rows go to the dump slot
    pack = torch.cat([sp.xyz, -sp.xyz, sp.orig[..., None].float()], dim=-1)
    agg_c = scatter_min_rows(m, torch.where(valid, cell_id, m), pack,
                             _F_BIG)                        # (B,M,7)

    # run-start table with payloads riding the sort
    flagged = torch.where(new_cell, _iota(no, dev), _IMAX)
    sorted5 = sort_by(flagged, sp.key, sp.xyz[..., 0], sp.xyz[..., 1],
                      sp.xyz[..., 2])
    s_pos, s_key, s_x, s_y, s_z = _pad_to(sorted5, m,
                                          (_IMAX, _IMAX, 0.0, 0.0, 0.0))
    starts = torch.clamp(s_pos, max=no)
    slot = _iota(m, dev)
    slot_valid = slot < n_cells
    # end = start of the next cell (cells are consecutive in sorted order)
    end = torch.where(slot_valid,
                      torch.where(slot == n_cells - 1, sp.n_obst,
                                  _shift(starts, 1, no)), no)
    start = torch.where(slot_valid, starts, no)
    count = torch.clamp(end - start, min=0)

    cell_key = torch.where(slot_valid, s_key, _IMAX)
    cell_col = torch.where(slot_valid, s_key // _GZ, _IMAX)
    rep = torch.stack([s_x, s_y, s_z], dim=-1)
    aabb = torch.cat([agg_c[..., 0:3], -agg_c[..., 3:6]], dim=-1)
    min_orig = torch.where(slot_valid, agg_c[..., 6].to(_I32), _IMAX)
    overflow = torch.clamp(n_cells - m, min=0)
    tbl = _CellTable(start, end, count, cell_key % _GZ, cell_col, aabb,
                     min_orig, rep, cell_key, torch.clamp(n_cells, max=m),
                     overflow)
    return tbl, cell_id


class _PairTest(NamedTuple):
    """Candidate pair records awaiting exact point-level tests, (B, P)
    each."""

    u_start: torch.Tensor
    u_count: torch.Tensor
    v_start: torch.Tensor
    v_count: torch.Tensor
    slot: torch.Tensor      # destination index in the result array
    active: torch.Tensor    # bool


def _tiered_exact(sp_xyz, pt: _PairTest, r2: float, n_results: int,
                  tiers=_TIERS_SNP, chunk_pairs: int = _CHUNK_PAIRS_SNP,
                  debug: bool = False, counts=None):
    """Run tiered block tests; scatter edge verdicts into (B, n_results)
    bool.

    Every pair is oriented (u = smaller side) and assigned to the first
    tier that fits; pairs with a side beyond _CHUNK split into _CHUNK-point
    sub-pairs whose verdicts OR into the original slot; sides beyond
    _CHUNK * _CHUNK_GRID points, and tier slot excess, count as overflow.
    Returns (verdicts, overflow (B, 1), dbg): with `debug`, dbg holds each
    frame's per-tier pair counts + the chunked-pair count ("tiers"), and
    checksums of the tiers' window starts ("tier_idx") and windows
    ("windows"), as the JAX package's dict; without it dbg is None and
    none of that is launched. `counts`, an int64 (B, 2+) view or None,
    gains each frame's tested pairs (column 0: the tier tables' pair
    counts) and the tested pairs that link (column 1).
    """
    dev = sp_xyz.device
    frames = sp_xyz.shape[0]
    maxc0 = torch.maximum(pt.u_count, pt.v_count)
    big = pt.active & (maxc0 > _CHUNK)
    bidx, n_big, ovf_b = compact_mask(big, chunk_pairs)
    bidx = bidx.long()
    bmask = _iota(chunk_pairs, dev) < n_big[:, None]
    gch = _iota(_CHUNK_GRID, dev) * _CHUNK
    shp = (frames, chunk_pairs, _CHUNK_GRID, _CHUNK_GRID)

    def grid(vals, axis):
        e = vals[:, :, None, :] if axis else vals[:, :, :, None]
        return e.expand(shp).reshape(frames, -1)

    def at_big(x):
        return x.gather(1, bidx)

    ch_uc2 = torch.clamp(at_big(pt.u_count)[..., None] - gch, 0, _CHUNK)
    ch_vc2 = torch.clamp(at_big(pt.v_count)[..., None] - gch, 0, _CHUNK)
    ch = _PairTest(
        u_start=grid(at_big(pt.u_start)[..., None] + gch, 0),
        u_count=grid(ch_uc2, 0),
        v_start=grid(at_big(pt.v_start)[..., None] + gch, 1),
        v_count=grid(ch_vc2, 1),
        slot=grid(at_big(pt.slot)[..., None].expand(ch_uc2.shape), 0),
        active=(grid(bmask[..., None].expand(ch_uc2.shape), 0)
                & (grid(ch_uc2, 0) > 0) & (grid(ch_vc2, 1) > 0)))
    us_ = torch.cat([pt.u_start, ch.u_start], 1)
    uc_ = torch.cat([torch.where(big, 0, pt.u_count), ch.u_count], 1)
    vs_ = torch.cat([pt.v_start, ch.v_start], 1)
    vc_ = torch.cat([torch.where(big, 0, pt.v_count), ch.v_count], 1)
    slot_ = torch.cat([pt.slot, ch.slot], 1)
    act_ = torch.cat([pt.active & ~big, ch.active], 1)

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
    n_in_tier = (tier_id[:, None, :] == _iota(n_t_all, dev)[:, None]
                 ).sum(-1, dtype=_I32)                       # (B,T)
    starts = torch.cumsum(n_in_tier, 1, dtype=_I32) - n_in_tier

    overflow = (ovf_b[:, None] + _count(big & (maxc0 > _CHUNK * _CHUNK_GRID))
                # active pairs too big for every tier
                + _count(tier_id == n_t_all))
    # every tier's slots of every frame in one launch, then the verdicts
    # over all of them: slot k of tier t is active below n_in_tier[t] and
    # reads the pair record at the dynamic slice's clamped start + k
    mind2 = tier_min_d2(sp_xyz, s_usuc, s_vsvc, starts, n_in_tier, tiers)
    lay = _tier_layout(tiers, s_usuc.shape[1], dev)
    overflow = overflow + torch.clamp(n_in_tier - lay.slots, min=0).sum(
        -1, keepdim=True, dtype=_I32)
    lo = torch.minimum(torch.clamp(starts, min=0), lay.lo_max)
    verdict = (lay.k < n_in_tier[:, lay.tier]) & (mind2 <= r2)
    src = lo[:, lay.tier] + lay.k
    if counts is not None:
        counts[:, 0].add_(n_in_tier.sum(-1))
        counts[:, 1].add_(verdict.sum(-1))
    # ONE verdict scatter for all tiers
    out = set_drop(torch.zeros((frames, n_results), dtype=torch.bool,
                               device=dev),
                   torch.where(verdict, s_slot.gather(1, src.long()),
                               n_results), True)
    if not debug:
        return out, overflow, None
    slices = tier_slices(s_usuc, s_vsvc, starts, n_in_tier, tiers)
    wins = [sum(w.flatten(1).sum(1) for w in side)
            for pair in tier_windows(sp_xyz, slices, tiers) for side in pair]
    dbg = {"tiers": torch.cat([n_in_tier, n_big[:, None]], 1),
           "tier_idx": sum(us.sum(-1, dtype=_I32) + vs.sum(-1, dtype=_I32)
                           for us, _, vs, _ in slices),
           "windows": sum(wins)}
    return out, overflow, dbg


class _TierLayout(NamedTuple):
    """The static shape of a tier table's concatenated slots."""

    slots: torch.Tensor    # (T,) slots per tier
    lo_max: torch.Tensor   # (T,) largest slice start: L - slots
    tier: torch.Tensor     # (sum slots,) int64 tier of each slot
    k: torch.Tensor        # (sum slots,) slot index within its tier


@functools.lru_cache(maxsize=None)
def _tier_layout(tiers, length: int, device) -> _TierLayout:
    """Built once per (table, descriptor count, device): the one host to
    device copy happens on the first call, outside any timed step."""
    slots = [s for *_, s in tiers]
    tier = [t for t, s in enumerate(slots) for _ in range(s)]
    k = [i for s in slots for i in range(s)]
    return _TierLayout(
        torch.tensor(slots, dtype=_I32, device=device),
        torch.tensor([length - s for s in slots], dtype=_I32, device=device),
        torch.tensor(tier, dtype=torch.int64, device=device),
        torch.tensor(k, dtype=_I32, device=device))


class _SnTable(NamedTuple):
    start: torch.Tensor       # (B,S) first point index
    count: torch.Tensor       # (B,S) point count
    aabb: torch.Tensor        # (B,S,6)
    rep: torch.Tensor         # (B,S,3) first point (bottom cell's first row)
    rep2: torch.Tensor        # (B,S,3) TOP cell's first point
    min_orig: torch.Tensor    # (B,S)
    first_cell: torch.Tensor  # (B,S) first cell id
    n_sn: torch.Tensor        # (B,1)
    overflow: torch.Tensor    # (B,1)


def _build_supernodes(sp, cells: _CellTable, link1: torch.Tensor,
                      pcfg: PipelineConfig
                      ) -> Tuple[_SnTable, torch.Tensor]:
    """Contract link1-chained cells into supernodes.

    link1: (B,M) bool — verified connection between cell i and cell i+1.
    Returns (table, sn_id_per_cell).
    """
    m = cells.start.shape[1]
    s = pcfg.max_supernodes
    no = sp.key.shape[1]
    dev = link1.device
    slot_valid = _iota(m, dev) < cells.n_cells
    new_sn = slot_valid & ~_before(link1, False)
    new_sn = torch.cat([slot_valid[:, :1], new_sn[:, 1:]], 1)
    sn_of_cell = torch.cumsum(new_sn, 1, dtype=_I32) - 1
    n_sn = _count(new_sn)

    # per-supernode aggregates via ONE scatter-min over the cell table
    pack = torch.cat([cells.aabb[..., 0:3], -cells.aabb[..., 3:6],
                      cells.min_orig[..., None].float()], dim=-1)
    agg_s = scatter_min_rows(s, torch.where(slot_valid, sn_of_cell, s),
                             pack, _F_BIG)                # (B,S,7)

    # run-start table with payloads (first cell's point start + rep)
    flagged = torch.where(new_sn, _iota(m, dev), _IMAX)
    sorted5 = sort_by(flagged, cells.start, cells.rep[..., 0],
                      cells.rep[..., 1], cells.rep[..., 2])
    f_pos, f_start, f_rx, f_ry, f_rz = _pad_to(sorted5, s,
                                               (_IMAX, no, 0.0, 0.0, 0.0))
    first_cell = torch.clamp(f_pos, max=m)
    sidx = _iota(s, dev)
    sn_valid = sidx < n_sn
    last_cell = torch.where(sidx == n_sn - 1, cells.n_cells,
                            _shift(first_cell, 1, m)) - 1
    lc = torch.clamp(last_cell, 0, m - 1).long()

    start = torch.where(sn_valid, f_start, no)
    end = torch.where(sn_valid, cells.end.gather(1, lc), no)
    count = torch.clamp(end - start, min=0)
    aabb = torch.cat([agg_s[..., 0:3], -agg_s[..., 3:6]], dim=-1)
    min_orig = torch.where(sn_valid, agg_s[..., 6].to(_I32), _IMAX)
    rep = torch.stack([f_rx, f_ry, f_rz], dim=-1)
    # second rep at the supernode's TOP cell (z-top probe)
    rep2 = take_rows(cells.rep, lc)
    overflow = torch.clamp(n_sn - s, min=0)
    tbl = _SnTable(start, count, aabb, rep, rep2, min_orig, first_cell,
                   torch.clamp(n_sn, max=s), overflow)
    return tbl, sn_of_cell


def _column_pairs(col_key, n_cols, col_info, pcfg: PipelineConfig,
                  slots: bool = False):
    """Sort-merge the 12-offset probes against occupied column keys.

    Returns (u_info, v_info, n_pairs, overflow, u_col, v_col): the
    `col_info` payloads of both sides of every pair of occupied columns
    whose xy cells are 5x5-window neighbors, and, with `slots`, the two
    sides' column-table slots (else None; only cluster_debug asks). The
    merge key is column_key * 2 + is_probe, so one sort both merges and
    orders each host before its probes.
    """
    frames, c = col_key.shape
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
                      *probe_keys], 1)
    copies = len(_XY_OFFSETS) + 1
    infos = col_info.repeat(1, copies)
    tags = ((_iota(c, dev).repeat(copies).expand(frames, -1),) if slots
            else ())
    sk2, si2, *st2 = sort_by(keys, infos, *tags)
    # a probe hits when its equal-column run starts with a host; the
    # host's info is broadcast over the run
    kcol = sk2 >> 1
    is_host = (sk2 != _IMAX) & ((sk2 & 1) == 0)
    hit = (~is_host & (sk2 != _IMAX)
           & seg_broadcast_first(is_host, kcol))
    hinfo_bcast = seg_broadcast_first(torch.where(is_host, si2, 0), kcol)

    if slots:   # each host's slot, broadcast over its run like its info
        host_bcast = seg_broadcast_first(
            torch.where(is_host, st2[0], _IMAX), kcol)
        st2 = [st2[0], torch.where(hit, host_bcast, 0)]
    _, ui_s, vi_s, *cols = sort_by((~hit).to(_I32), si2,
                                   torch.where(hit, hinfo_bcast, 0), *st2)
    n_pairs = _count(hit)
    ovf = torch.clamp(n_pairs - cp, min=0)
    n_pairs = torch.clamp(n_pairs, max=cp)
    live = _iota(cp, dev) < n_pairs
    u_info, v_info, *cols = (torch.where(live, a[:, :cp], 0)
                             for a in (ui_s, vi_s, *cols))
    u_col, v_col = cols if slots else (None, None)
    return u_info, v_info, n_pairs, ovf, u_col, v_col


def _cluster_impl(xyz, valid, cfg: ClusteringConfig, pcfg: PipelineConfig,
                  debug: bool):
    frames, n = xyz.shape[:2]
    h = math.sqrt(cfg.distance_squared / 3.0)
    sp = _sort_points(xyz, valid, pcfg, h)
    pt_label, num_clusters, overflow, dbg = _cluster_core(sp, cfg, pcfg,
                                                          debug)
    pt_valid = sp.key != _IMAX
    out = set_drop(torch.full((frames, n), CLUSTER_UNDEFINED, dtype=_I32,
                              device=xyz.device),
                   torch.where(pt_valid, sp.orig, n), pt_label)
    return ClusteringResult(out, num_clusters[:, 0], overflow[:, 0]), dbg


def cluster(xyz: torch.Tensor, valid: torch.Tensor,
            cfg: ClusteringConfig, pcfg: PipelineConfig) -> ClusteringResult:
    """Cluster valid points of padded clouds (see module docstring): xyz
    (B, N, 3) and valid (B, N), or one frame without the B."""
    if xyz.dim() == 2:
        return frame_of(cluster(xyz[None], valid[None], cfg, pcfg), 0)
    return _cluster_impl(xyz, valid, cfg, pcfg, debug=False)[0]


def cluster_debug(xyz: torch.Tensor, valid: torch.Tensor,
                  cfg: ClusteringConfig, pcfg: PipelineConfig
                  ) -> Tuple[ClusteringResult, Dict[str, object]]:
    """cluster() plus the dict of internal arrays the JAX package's
    ``cluster_debug`` returns, key for key (for tests and the probes: its
    e_u / e_v / n_edges are a real frame's union-find input, and sn, pu,
    pv, impossible, certain its supernode pair tests). One frame gives the
    JAX package's per-frame dict; a batch, every entry with a leading B."""
    if xyz.dim() == 2:
        return frame_of(cluster_debug(xyz[None], valid[None], cfg, pcfg), 0)
    return _cluster_impl(xyz, valid, cfg, pcfg, debug=True)


class FusedClusterOut(NamedTuple):
    """cluster_fused output: clustering + segmentation labels in original
    order, plus the cell-key-sorted obstacle arrays for the hull stage.
    Per frame; a batch adds a leading B to every leaf."""

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
    sk, sx, sy, sz, so4 = sort_by(key, xyz[..., 0], xyz[..., 1],
                                  xyz[..., 2], orig4)
    n_obst = _count(key < _IMAX - 1)
    overflow = (_count(coord_bad) + torch.clamp(n_obst - no, min=0))
    slice_key = torch.where(_iota(no, xyz.device) < n_obst, sk[:, :no],
                            _IMAX)
    sp = _SortedPoints(torch.stack([sx[:, :no], sy[:, :no], sz[:, :no]],
                                   dim=-1),
                       slice_key, so4[:, :no] >> 2,
                       torch.clamp(n_obst, max=no), overflow)
    return sp, sk, so4, so4 & 3


def cluster_fused(xyz_s, obstacle_s, point_valid_s, orig_s, seg_labels_s,
                  cfg: ClusteringConfig, pcfg: PipelineConfig,
                  counts=None) -> FusedClusterOut:
    """Fused clustering over pre-sorted segmented clouds.

    Inputs live in gpf_segment_sorted's (partition, z) space, (B, N[, 3])
    or one frame without the B; orig_s carries the original index. Both
    stages' labels return to original order with ONE sort on the packed
    orig*4+seg key, and the cell-key-sorted obstacle arrays feed the hull
    stage directly. `counts`: as ``_cluster_core``'s.
    """
    if xyz_s.dim() == 2:
        return frame_of(cluster_fused(
            xyz_s[None], obstacle_s[None], point_valid_s[None], orig_s[None],
            seg_labels_s[None], cfg, pcfg,
            None if counts is None else counts[None]), 0)
    frames, n = xyz_s.shape[:2]
    no = pcfg.max_obstacle_points
    h = math.sqrt(cfg.distance_squared / 3.0)
    sp, key_full, orig_full, _ = _sort_points_full(
        xyz_s, obstacle_s, point_valid_s, orig_s, seg_labels_s, pcfg, h)
    pt_label, num_clusters, overflow, _ = _cluster_core(sp, cfg, pcfg,
                                                        counts=counts)

    pt_valid = sp.key != _IMAX
    cl_plus2 = torch.cat([torch.where(pt_valid, pt_label + 2, 0),
                          pt_label.new_zeros((frames, n - no))], 1)
    cl_plus2 = torch.where(key_full != _IMAX, cl_plus2, 0)
    # orig_full = orig*4+seg is strictly increasing in orig: sorting on it
    # unsorts and delivers the seg labels in its low bits
    so4, out_cl = sort_by(orig_full, cl_plus2)
    seg_out = so4 & 3
    cl_out = torch.where(out_cl == 0, CLUSTER_UNDEFINED, out_cl - 2)
    return FusedClusterOut(
        ClusteringResult(cl_out, num_clusters[:, 0], overflow[:, 0]),
        seg_out, sp.xyz, torch.where(pt_valid, pt_label, CLUSTER_UNDEFINED),
        sp.orig)


# The screens' d² round as the JAX package's on the CPU does (found by
# crafted knife-edge pairs through its jitted `cluster`, the shipped caps;
# tools/knife_cases.py): the cell-pair and supernode-pair AABB gaps and rep
# probes all as fma(z, z, fma(y, y, x·x)) (`sum_sq3`). At other caps XLA
# picks other fusions for the k = 1 cell rep screen (unfused at max_cells
# <= 16384, both rep screens at >= 32768; ROADMAP §3): the port keeps one
# rounding. The exact test is kernels/tier_min_d2.py's.
def _pair_gap_d2(u_aabb, v_aabb):
    gap = torch.clamp(torch.maximum(u_aabb[..., 0:3] - v_aabb[..., 3:6],
                                    v_aabb[..., 0:3] - u_aabb[..., 3:6]),
                      min=0.0)
    return sum_sq3(*gap.unbind(-1))


def _d2(a, b):
    return sum_sq3(*(a - b).unbind(-1))


def _frame_scalars(table):
    """A table's (B, 1) count and overflow columns as (B,), so that one
    frame of the debug dict holds 0-d scalars as the JAX package's does."""
    names = [f for f in ("n_obst", "n_cells", "n_sn", "overflow")
             if f in table._fields]
    return table._replace(**{f: getattr(table, f)[:, 0] for f in names})


def _cluster_core(sp: _SortedPoints, cfg: ClusteringConfig,
                  pcfg: PipelineConfig, debug: bool = False, counts=None):
    """Shared clustering core over sorted obstacle buffers.

    Returns (pt_label (B,NO) labels per sorted row, num_clusters (B,1),
    overflow (B,1), debug dict or None). The dict and the reductions only
    it needs are built when `debug` asks: in eager PyTorch each would be a
    launch on the main path (XLA dead-code-eliminated them in the JAX
    package). `counts`, an int64 (B, 3) view or None, gains the pairs both
    tier tables test, those that link, and the live edges union_find
    takes: a few reductions, launched only when it is given.
    """
    r2 = cfg.distance_squared
    m = pcfg.max_cells
    s_cap = pcfg.max_supernodes
    dev = sp.key.device
    frames = sp.key.shape[0]

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
        impossible = _pair_gap_d2(cells.aabb, _roll(cells.aabb, k)) > r2
        certain = _d2(cells.rep, _roll(cells.rep, k)) <= r2
        intra_link[k] = cand & ~impossible & certain
        intra_tests.append(cand & ~impossible & ~certain)

    # ---- exact tests of the ambiguous intra-column pairs ----------------
    # results layout: [0, M) link1 candidates, [M, 2M) link2 candidates
    pt = _PairTest(
        u_start=torch.cat([cells.start, cells.start], 1),
        u_count=torch.cat([cells.count, cells.count], 1),
        v_start=torch.cat([_roll(cells.start, 1), _roll(cells.start, 2)], 1),
        v_count=torch.cat([_roll(cells.count, 1), _roll(cells.count, 2)], 1),
        slot=_iota(2 * m, dev).expand(frames, -1),
        active=torch.cat(intra_tests, 1))
    intra_verdict, ovf_t, dbg_t1 = _tiered_exact(
        sp.xyz, pt, r2, 2 * m, tiers=_TIERS_INTRA,
        chunk_pairs=_CHUNK_PAIRS_INTRA, debug=debug, counts=counts)
    overflow = overflow + ovf_t
    link1 = intra_link[1] | intra_verdict[:, :m]
    link2 = intra_link[2] | intra_verdict[:, m:2 * m]

    # ---- supernodes ------------------------------------------------------
    sn, sn_of_cell = _build_supernodes(sp, cells, link1, pcfg)
    overflow = overflow + sn.overflow

    # link2 edges crossing a supernode boundary
    sn_p2 = _roll(sn_of_cell, 2)
    link2_edge = link2 & (sn_p2 != sn_of_cell)
    e2_u = torch.where(link2_edge, sn_of_cell, 0)
    e2_v = torch.where(link2_edge, sn_p2, 0)

    # ---- column table + pair generation ---------------------------------
    c_cap = pcfg.max_columns
    new_col_c = slot_valid & (cells.col_id != _before(cells.col_id, -1))
    n_cols = _count(new_col_c)
    flagged_c = torch.where(new_col_c, _iota(m, dev), _IMAX)
    c_pos, c_key, c_sn = _pad_to(
        sort_by(flagged_c, cells.key, sn_of_cell), c_cap,
        (_IMAX, _IMAX, _IMAX))
    col_first_cell = torch.clamp(c_pos, max=m)
    cidx = _iota(c_cap, dev)
    col_valid = cidx < n_cols
    col_key = torch.where(col_valid, c_key // _GZ, _IMAX)
    col_first_sn = torch.where(col_valid, c_sn, 0)
    col_last_cell = torch.where(cidx == n_cols - 1, cells.n_cells,
                                _shift(col_first_cell, 1, m)) - 1
    col_last_sn = torch.where(col_valid,
                              take(sn_of_cell, col_last_cell), -1)
    col_sn_count = torch.where(col_valid, col_last_sn - col_first_sn + 1, 0)
    overflow = overflow + torch.clamp(n_cols - c_cap, min=0)
    overflow = overflow + _count(col_sn_count > 16)

    # packed per-column payload (first_sn * 32 + min(count, 31)), carried
    # through the pair merge sorts
    col_info = col_first_sn * 32 + torch.clamp(col_sn_count, max=31)
    pa, pb, n_cpairs, ovf_cp, u_col, v_col = _column_pairs(
        col_key, n_cols, col_info, pcfg, slots=debug)
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
    n_cls = [_count(ck == k) for k in (1, 2, 3, 4)]
    offs = [torch.zeros((frames, 1), dtype=_I32, device=dev)]
    for k in range(4):
        offs.append(offs[-1] + n_cls[k])
    pad_sl = spa.new_zeros((frames, max(_E_CAPS)))
    spa_p = torch.cat([spa, pad_sl], 1)
    spb_p = torch.cat([spb, pad_sl], 1)

    def expand_band(band, width):
        cap = _E_CAPS[band]
        a = dynamic_slice(spa_p, offs[band], cap)
        b = dynamic_slice(spb_p, offs[band], cap)
        nb = n_cls[band]
        act = _iota(cap, dev) < torch.clamp(nb, max=cap)
        muA, mcA = a // 32, torch.where(act, a % 32, 0)
        muB, mcB = b // 32, torch.where(act, b % 32, 0)
        g = _iota(width, dev)
        shp = (frames, cap, width, width)
        eu = (muA[:, :, None, None] + g[:, None]).expand(shp).reshape(
            frames, -1)
        ev = (muB[:, :, None, None] + g).expand(shp).reshape(frames, -1)
        ca = torch.clamp(mcA, max=width)[:, :, None, None]
        cb = torch.clamp(mcB, max=width)[:, :, None, None]
        eok = ((g[:, None] < ca) & (g < cb)
               & ((g[:, None] > 0) | (g > 0))).reshape(frames, -1)
        return eu, ev, eok, torch.clamp(nb - cap, min=0)

    bands = [expand_band(b, w) for b, w in enumerate((2, 4, 8, 16))]
    for *_, ovf in bands:
        overflow = overflow + ovf
    # assemble the supernode pair list, valid pairs packed to the front by
    # ONE sort (a single packed int32 key when supernode ids fit 15 bits)
    all_u = torch.cat([prim_u] + [b[0] for b in bands], 1)
    all_v = torch.cat([prim_v] + [b[1] for b in bands], 1)
    all_ok = torch.cat([prim_ok] + [b[2] for b in bands], 1)
    n_snp = _count(all_ok)
    overflow = overflow + torch.clamp(n_snp - snp, min=0)
    n_snp = torch.clamp(n_snp, max=snp)
    snp_valid = _iota(snp, dev) < n_snp
    if s_cap <= (1 << 15):
        key = torch.where(all_ok, all_u * (1 << 15) + all_v, 1 << 30)
        skey = torch.sort(key, dim=1).values[:, :snp]
        pu = torch.where(snp_valid, skey >> 15, 0)
        pv = torch.where(snp_valid, skey & ((1 << 15) - 1), 0)
    else:
        _, su_, sv_ = sort_by((~all_ok).to(_I32), all_u, all_v)
        pu = torch.where(snp_valid, su_[:, :snp], 0)
        pv = torch.where(snp_valid, sv_[:, :snp], 0)

    # ---- classify supernode pairs ---------------------------------------
    # one row gather per side: [aabb(6), rep(3), rep2(3), start, count]
    sn_rows = torch.cat([sn.aabb, sn.rep, sn.rep2,
                         sn.start[..., None].float(),
                         sn.count[..., None].float()], dim=-1)  # (B,S,14)
    ru = take_rows(sn_rows, pu)
    rv = take_rows(sn_rows, pv)
    impossible = _pair_gap_d2(ru[..., 0:6], rv[..., 0:6]) > r2
    # 4 rep-pair probes (bottom/top x bottom/top): any hit connects the
    # pair for certain without a block test
    certain = ((_d2(ru[..., 6:9], rv[..., 6:9]) <= r2)
               | (_d2(ru[..., 6:9], rv[..., 9:12]) <= r2)
               | (_d2(ru[..., 9:12], rv[..., 6:9]) <= r2)
               | (_d2(ru[..., 9:12], rv[..., 9:12]) <= r2))
    ambiguous = snp_valid & ~impossible & ~certain
    pair_certain = snp_valid & ~impossible & certain

    pt2 = _PairTest(
        u_start=ru[..., 12].to(_I32), u_count=ru[..., 13].to(_I32),
        v_start=rv[..., 12].to(_I32), v_count=rv[..., 13].to(_I32),
        slot=_iota(snp, dev).expand(frames, -1), active=ambiguous)
    snp_verdict, ovf_t2, dbg_t2 = _tiered_exact(
        sp.xyz, pt2, r2, snp, tiers=_TIERS_SNP, debug=debug, counts=counts)
    overflow = overflow + ovf_t2
    snp_edge = pair_certain | snp_verdict

    # ---- edge list, compacted by one sort --------------------------------
    e_u0 = torch.cat([torch.where(snp_edge, pu, 0), e2_u], 1)
    e_v0 = torch.cat([torch.where(snp_edge, pv, 0), e2_v], 1)
    e_ok0 = torch.cat([snp_edge, link2_edge], 1)
    n_edges = _count(e_ok0)
    ec = min(pcfg.max_edges, e_u0.shape[1])
    overflow = overflow + torch.clamp(n_edges - ec, min=0)
    n_edges = torch.clamp(n_edges, max=ec)
    e_ok = _iota(ec, dev) < n_edges
    if s_cap <= (1 << 15):
        ekey = torch.where(e_ok0, e_u0 * (1 << 15) + e_v0, 1 << 30)
        sek = torch.sort(ekey, dim=1).values[:, :ec]
        e_u = torch.where(e_ok, sek >> 15, 0)
        e_v = torch.where(e_ok, sek & ((1 << 15) - 1), 0)
    else:
        _, se_u, se_v = sort_by((~e_ok0).to(_I32),
                                torch.where(e_ok0, e_u0, 0),
                                torch.where(e_ok0, e_v0, 0))
        e_u = torch.where(e_ok, se_u[:, :ec], 0)
        e_v = torch.where(e_ok, se_v[:, :ec], 0)

    # ---- connected components on the supernode graphs, one launch -------
    sn_valid_mask = _iota(s_cap, dev) < sn.n_sn
    labels = cc_labels(e_u, e_v, n_edges[:, 0], s_cap)
    if counts is not None:
        counts[:, 2] = n_edges[:, 0]

    # ---- stats, size filter, canonical numbering ------------------------
    tgt = torch.where(sn_valid_mask, labels, s_cap)
    comp_size = scatter_drop(s_cap, tgt,
                             torch.where(sn_valid_mask, sn.count, 0), 0,
                             "sum")
    comp_min = scatter_drop(s_cap, tgt, sn.min_orig, _IMAX, "amin")
    sidx = _iota(s_cap, dev)
    is_root = sn_valid_mask & (labels == sidx)
    max_sz = min(cfg.max_cluster_size, 2 ** 31 - 1)
    comp_valid = (is_root & (comp_size >= cfg.min_cluster_size)
                  & (comp_size <= max_sz))

    rank_key = torch.where(comp_valid, comp_min, _IMAX)
    rorder = torch.argsort(rank_key, dim=1, stable=True)
    ranks = torch.empty_like(rank_key).scatter_(1, rorder,
                                                sidx.expand(frames, -1))
    num_clusters = _count(comp_valid)
    root_label = torch.where(comp_valid, ranks, CLUSTER_INVALID)

    # ---- per-point labels over the sorted buffer ------------------------
    # cell labels land on each cell's RUN START, then a segmented
    # broadcast spreads them over the cell's points
    sn_label = root_label.gather(1, labels.long())              # (B,S)
    cell_label = take(sn_label, sn_of_cell)                     # (B,M)
    pt_valid = sp.key != _IMAX
    seed_lab = set_drop(torch.full(sp.key.shape, CLUSTER_UNDEFINED,
                                   dtype=_I32, device=dev),
                        cells.start, cell_label)   # empty slots: dropped
    pt_label = torch.where(pt_valid,
                           seg_broadcast_first(seed_lab, cell_id_pt),
                           CLUSTER_UNDEFINED)
    if not debug:
        return pt_label, num_clusters, overflow, None
    dbg = dict(
        sp=_frame_scalars(sp), cells=_frame_scalars(cells),
        cell_id_pt=cell_id_pt, link1=link1, link2=link2,
        intra_tests1=intra_tests[0], intra_tests2=intra_tests[1],
        sn=_frame_scalars(sn), sn_of_cell=sn_of_cell,
        col_first_sn=col_first_sn, col_sn_count=col_sn_count, u_col=u_col,
        v_col=v_col, n_cpairs=n_cpairs[:, 0], pu=pu, pv=pv,
        n_snp=n_snp[:, 0], n_cls=torch.cat(n_cls, 1),
        n_edges=n_edges[:, 0], impossible=impossible, certain=certain,
        snp_edge=snp_edge, e_u=e_u, e_v=e_v, e_ok=e_ok, labels=labels,
        tiers1=dbg_t1["tiers"], tiers2=dbg_t2["tiers"],
        snp_classify=(impossible.sum(-1, dtype=_I32),
                      certain.sum(-1, dtype=_I32)),
        snp_tier_idx=dbg_t2["tier_idx"], snp_windows=dbg_t2["windows"])
    return pt_label, num_clusters, overflow, dbg
