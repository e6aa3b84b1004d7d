"""Cluster gathering and batched convex hulls on the device.

Port of ``lidar_processing_tpu/ops/hull.py``: one sort by cluster label
makes every cluster a contiguous run of the sorted cloud (the reference's
per-point scatter into per-cluster clouds, ref: src/processor.cpp:180-200,
becomes a slice), and small-cluster convex hulls run for all clusters at
once as a dense successor table walked for ``max_out`` steps
(ref: src/polygon_simplification.cpp:96-115, '<20 points => convex').
The JAX package's vmap over clusters is a written-out batch dimension,
chunked over clusters so the (C, P, P, P) orientation transients stay
small on the card and in the CPU tests.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..types import PolygonBatch
from .scan_utils import run_starts, sort_by

_I32 = torch.int32
_SR = 32              # row width for aligned window gathers
_HULL_CHUNK = 128     # clusters per successor-table batch


class LabelRuns(NamedTuple):
    """Label-sorted cloud + per-cluster run table.

    sorted_xyz: (N, 3) f32 — points ordered by cluster id (within a
                cluster, original point order); non-cluster points last.
    sorted_key: (N,) i32 — cluster id per sorted row (num_slots for
                non-cluster rows).
    starts:     (C,) i32 — run start per cluster id.
    counts:     (C,) i32 — run length per cluster id.
    num:        ()  i32 — number of clusters present.
    overflow:   ()  i32 — clusters beyond the C-slot table, plus 1 when
                the ids are not compact.
    """

    sorted_xyz: torch.Tensor
    sorted_key: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    num: torch.Tensor
    overflow: torch.Tensor


def label_runs_presorted(xyz: torch.Tensor, labels: torch.Tensor,
                         orig: torch.Tensor, num_slots: int,
                         orig_bound: int = 0) -> LabelRuns:
    """Sort a compacted labeled buffer into contiguous per-cluster runs.

    `orig` restores the within-cluster original point order (secondary
    key); label and orig pack into ONE int32 key when the ranges allow.
    """
    n = xyz.shape[0]
    dev = xyz.device
    valid = (labels >= 0) & (labels < num_slots)
    key = torch.where(valid, labels, num_slots)
    shift = max(17, ((orig_bound or 4 * n) - 1).bit_length())
    if (num_slots + 1) << shift <= (1 << 31):
        packed = key * (1 << shift) + orig
        pk, sx_, sy_, sz_ = sort_by(packed, xyz[:, 0], xyz[:, 1], xyz[:, 2])
        skey = pk >> shift
    else:
        skey, _, sx_, sy_, sz_ = sort_by((key, orig), xyz[:, 0], xyz[:, 1],
                                         xyz[:, 2])
    sorted_xyz = torch.stack([sx_, sy_, sz_], dim=1)
    num = torch.where(valid, labels, -1).amax() + 1
    num = torch.clamp(num, max=num_slots)
    overflow = (labels >= num_slots).sum(dtype=_I32)
    # cluster ids are COMPACT (0..num-1, each with >= 1 point), so starts
    # come from one run_starts sort and counts from start differences
    n_lab = valid.sum(dtype=_I32)
    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    new_run = (skey != prev) & (skey < num_slots)
    # compactness guard: a gappy caller would silently shift every later
    # start — fail loudly through the overflow counter instead
    n_runs = new_run.sum(dtype=_I32)
    starts_raw = run_starts(new_run, num_slots)
    slot = torch.arange(num_slots, dtype=_I32, device=dev)
    slot_valid = slot < num
    nxt = torch.cat([starts_raw[1:], starts_raw.new_full((1,), n)])
    end = torch.where(slot == num - 1, n_lab, nxt)
    starts = torch.where(slot_valid, starts_raw, n)
    counts = torch.where(slot_valid, torch.clamp(end - starts_raw, min=0), 0)
    overflow = overflow + (n_runs != num).to(_I32)
    return LabelRuns(sorted_xyz, skey, starts, counts, num, overflow)


def gather_runs(sorted_xyz: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, max_points: int) -> torch.Tensor:
    """Gather contiguous runs into a front-packed (C, max_points, 3) batch
    (whole 32-point rows, then a local realignment)."""
    n = sorted_xyz.shape[0]
    if n % _SR:
        raise ValueError(f"sorted buffer of {n} rows is not a multiple of "
                         f"{_SR}")
    dev = sorted_xyz.device
    c = starts.shape[0]
    srows = sorted_xyz.reshape(n // _SR, _SR, 3)
    nrow = max_points // _SR + 1
    sr0 = starts // _SR
    ridx = torch.clamp(sr0[:, None] + torch.arange(nrow, dtype=_I32,
                                                   device=dev)[None, :],
                       0, n // _SR - 1)
    wide = srows[ridx.long()].reshape(c, nrow * _SR, 3)
    off = (starts - sr0 * _SR)[:, None]
    lane = torch.arange(max_points, dtype=_I32, device=dev)[None, :] + off
    pts = torch.take_along_dim(wide, lane.long()[..., None].expand(-1, -1, 3),
                               dim=1)
    keep = (torch.arange(max_points, dtype=_I32, device=dev)[None, :]
            < torch.clamp(counts, max=max_points)[:, None])
    return torch.where(keep[..., None], pts, 0.0)


def _convex_hull_small(xy: torch.Tensor, count: torch.Tensor, max_out: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strictly-convex CCW hulls of a batch of padded point sets.

    xy: (B, P, 2), count: (B,). Gift wrapping as a dense successor table:
    for every potential current vertex c, the next CCW hull vertex is the
    q with no alive k strictly right of c->q (farthest-on-ray tie-break
    skips collinear interiors); the walk from the lowest (y, then x) point
    then emits up to max_out vertices. Returns (vertex indices (B, max_out)
    with -1 padding, vertex counts (B,)).
    """
    b, p = xy.shape[:2]
    dev = xy.device
    idx = torch.arange(p, dtype=_I32, device=dev)
    alive = idx[None, :] < count[:, None]                    # (B,P)
    big = 3.4e38

    # start: lowest (y, then x) point — guaranteed hull vertex
    ykey = torch.where(alive, xy[..., 1], big)
    min_y = ykey.amin(1)
    cand = alive & (xy[..., 1] == min_y[:, None])
    start = torch.argmin(torch.where(cand, xy[..., 0], big), dim=1).to(_I32)

    d = xy[:, None, :, :] - xy[:, :, None, :]          # (B, P cur, P other, 2)
    dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]        # (B,P,P)
    cross = (d[:, :, :, None, 0] * d[:, :, None, :, 1]
             - d[:, :, :, None, 1] * d[:, :, None, :, 0])  # (B,cur,q,k)
    # the tolerance scales with |d_q||d_k|: collinear pairs produce
    # O(eps*|dq||dk|) noise of either sign
    tol = 1e-5 * torch.sqrt(torch.clamp(
        dist2[:, :, :, None] * dist2[:, :, None, :], min=1e-30))
    self_or_dead = (~alive)[:, None, :] | (idx[None, :] == idx[:, None])[None]
    bad = (cross < -tol) & (~self_or_dead)[:, :, None, :]
    strictly_right_none = ~(bad & (~self_or_dead)[:, :, :, None]).any(3)
    score = torch.where(strictly_right_none & ~self_or_dead, dist2, -1.0)
    succ = torch.argmax(score, dim=2).to(_I32)               # (B,P)
    has_next_tab = score.amax(2) > 0.0                       # (B,P)

    # walk the successor chain (the sequential gift-wrap's state machine)
    verts = []
    cur, done = start, count < 1
    n_emitted = torch.zeros(b, dtype=_I32, device=dev)
    for _ in range(max_out):
        out = torch.where(done, -1, cur)
        verts.append(out)
        n_emitted = n_emitted + (out >= 0).to(_I32)
        c = cur.long()[:, None]
        nxt = succ.gather(1, c)[:, 0]
        has_next = has_next_tab.gather(1, c)[:, 0]
        done = done | ~has_next | (nxt == start)
        cur = torch.where(has_next, nxt, cur)
    return torch.stack(verts, dim=1), n_emitted


def convex_hulls_batched(xy: torch.Tensor, counts: torch.Tensor,
                         max_out: int) -> PolygonBatch:
    """CCW convex hulls for a batch of padded clusters.

    xy: (C, P, 2); counts: (C,). Returns a PolygonBatch with up to max_out
    vertices per hull (indices resolved to coordinates). Runs
    _HULL_CHUNK clusters at a time: the successor table's (P, P, P)
    transients grow cubically in P.
    """
    p = xy.shape[1]
    idx_parts, n_parts = [], []
    for lo in range(0, xy.shape[0], _HULL_CHUNK):
        vi, n = _convex_hull_small(xy[lo:lo + _HULL_CHUNK],
                                   counts[lo:lo + _HULL_CHUNK], max_out)
        idx_parts.append(vi)
        n_parts.append(n)
    verts_idx = torch.cat(idx_parts)
    coords = torch.take_along_dim(
        xy, torch.clamp(verts_idx, 0, p - 1).long()[..., None].expand(
            -1, -1, 2), dim=1)
    coords = torch.where((verts_idx >= 0)[..., None], coords, 0.0)
    return PolygonBatch(coords, torch.cat(n_parts))
