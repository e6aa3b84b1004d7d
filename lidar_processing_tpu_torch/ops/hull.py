"""Cluster gathering and batched convex hulls on the device.

Port of ``lidar_processing_tpu/ops/hull.py``: one sort by cluster label
makes every cluster a contiguous run of the sorted cloud (the reference's
per-point scatter into per-cluster clouds, ref: src/processor.cpp:180-200,
becomes a slice; ``label_runs`` for full clouds, ``label_runs_presorted``
for the stixel path's compacted buffers), and small-cluster convex hulls
run for all clusters at once as a dense successor table walked for
``max_out`` steps
(ref: src/polygon_simplification.cpp:96-115, '<20 points => convex').
The JAX package's vmaps over frames and clusters are written-out batch
dimensions: the successor tables are built a chunk of clusters at a time
(every frame of the batch in each chunk) so the (B, C, P, P, P)
orientation transients stay bounded on the card and in the CPU tests,
then one walk runs over every cluster of every frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..types import PolygonBatch, frame_of
from .scan_utils import run_starts, sort_by, take_rows

_I32 = torch.int32
_SR = 32              # row width for aligned window gathers
_HULL_CHUNK = 128     # clusters of each frame per successor-table batch


class LabelRuns(NamedTuple):
    """Label-sorted cloud + per-cluster run table (per frame; a batch adds
    a leading frame axis B to every field).

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


def label_runs(xyz: torch.Tensor, labels: torch.Tensor,
               num_slots: int) -> LabelRuns:
    """Sort labeled clouds by label into contiguous per-cluster runs (the
    stage-by-stage path of the cellgraph backend).

    xyz (B, N, 3) and labels (B, N), or one frame without the B. One
    stable sort on the label key carries x, y and z; starts and counts
    come from one searchsorted of the slot ids over the sorted keys.
    """
    if xyz.dim() == 2:
        return frame_of(label_runs(xyz[None], labels[None], num_slots), 0)
    frames = xyz.shape[0]
    valid = (labels >= 0) & (labels < num_slots)
    key = torch.where(valid, labels, num_slots)
    skey, sx_, sy_, sz_ = sort_by(key, xyz[..., 0], xyz[..., 1], xyz[..., 2])
    slots = torch.arange(num_slots + 1, dtype=_I32,
                         device=xyz.device).expand(frames, -1).contiguous()
    edges = torch.searchsorted(skey, slots).to(_I32)
    starts = edges[:, :num_slots]
    num = torch.where(labels >= 0, labels, -1).amax(1) + 1
    return LabelRuns(torch.stack([sx_, sy_, sz_], dim=-1), skey, starts,
                     edges[:, 1:] - starts, torch.clamp(num, max=num_slots),
                     (labels >= num_slots).sum(1, dtype=_I32))


def label_runs_presorted(xyz: torch.Tensor, labels: torch.Tensor,
                         orig: torch.Tensor, num_slots: int,
                         orig_bound: int = 0) -> LabelRuns:
    """Sort compacted labeled buffers into contiguous per-cluster runs.

    xyz (B, N, 3), labels and orig (B, N), or one frame without the B.
    `orig` restores the within-cluster original point order (secondary
    key); label and orig pack into ONE int32 key when the ranges allow.
    """
    if xyz.dim() == 2:
        return frame_of(label_runs_presorted(xyz[None], labels[None],
                                             orig[None], num_slots,
                                             orig_bound), 0)
    n = xyz.shape[1]
    dev = xyz.device
    valid = (labels >= 0) & (labels < num_slots)
    key = torch.where(valid, labels, num_slots)
    shift = max(17, ((orig_bound or 4 * n) - 1).bit_length())
    if (num_slots + 1) << shift <= (1 << 31):
        packed = key * (1 << shift) + orig
        pk, sx_, sy_, sz_ = sort_by(packed, xyz[..., 0], xyz[..., 1],
                                    xyz[..., 2])
        skey = pk >> shift
    else:
        skey, _, sx_, sy_, sz_ = sort_by((key, orig), xyz[..., 0],
                                         xyz[..., 1], xyz[..., 2])
    sorted_xyz = torch.stack([sx_, sy_, sz_], dim=-1)
    num = torch.where(valid, labels, -1).amax(1, keepdim=True) + 1
    num = torch.clamp(num, max=num_slots)                     # (B,1)
    overflow = (labels >= num_slots).sum(1, dtype=_I32)
    # cluster ids are COMPACT (0..num-1, each with >= 1 point), so starts
    # come from one run_starts sort and counts from start differences
    n_lab = valid.sum(1, keepdim=True, dtype=_I32)
    prev = torch.cat([skey.new_full((skey.shape[0], 1), -1), skey[:, :-1]],
                     1)
    new_run = (skey != prev) & (skey < num_slots)
    # compactness guard: a gappy caller would silently shift every later
    # start — fail loudly through the overflow counter instead
    n_runs = new_run.sum(1, keepdim=True, dtype=_I32)
    starts_raw = run_starts(new_run, num_slots)
    slot = torch.arange(num_slots, dtype=_I32, device=dev)
    slot_valid = slot < num
    nxt = torch.cat([starts_raw[:, 1:],
                     starts_raw.new_full((starts_raw.shape[0], 1), n)], 1)
    end = torch.where(slot == num - 1, n_lab, nxt)
    starts = torch.where(slot_valid, starts_raw, n)
    counts = torch.where(slot_valid, torch.clamp(end - starts_raw, min=0), 0)
    overflow = overflow + (n_runs != num)[:, 0].to(_I32)
    return LabelRuns(sorted_xyz, skey, starts, counts, num[:, 0], overflow)


def gather_runs(sorted_xyz: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, max_points: int) -> torch.Tensor:
    """Gather contiguous runs into a front-packed (..., C, max_points, 3)
    batch (whole 32-point rows, then a local realignment): sorted_xyz
    (..., N, 3), starts and counts (..., C)."""
    n = sorted_xyz.shape[-2]
    if n % _SR:
        raise ValueError(f"sorted buffer of {n} rows is not a multiple of "
                         f"{_SR}")
    dev = sorted_xyz.device
    srows = sorted_xyz.reshape(*sorted_xyz.shape[:-2], n // _SR, _SR * 3)
    nrow = max_points // _SR + 1
    sr0 = starts // _SR
    ridx = torch.clamp(sr0[..., None] + torch.arange(nrow, dtype=_I32,
                                                     device=dev),
                       0, n // _SR - 1)
    wide = take_rows(srows, ridx).reshape(*starts.shape, nrow * _SR, 3)
    off = (starts - sr0 * _SR)[..., None]
    lane = torch.arange(max_points, dtype=_I32, device=dev) + off
    pts = torch.take_along_dim(
        wide, lane.long()[..., None].expand(*lane.shape, 3), dim=-2)
    keep = (torch.arange(max_points, dtype=_I32, device=dev)
            < torch.clamp(counts, max=max_points)[..., None])
    return torch.where(keep[..., None], pts, 0.0)


def _successors(xy: torch.Tensor, count: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gift wrapping's dense successor table for a batch of padded point
    sets.

    xy: (K, P, 2), count: (K,). For every potential current vertex c, the
    next CCW hull vertex is the q with no alive k strictly right of c->q
    (farthest-on-ray tie-break skips collinear interiors). Returns (start
    (K,): the lowest (y, then x) point, a guaranteed hull vertex; succ
    (K, P); has_next (K, P)).
    """
    p = xy.shape[1]
    dev = xy.device
    idx = torch.arange(p, dtype=_I32, device=dev)
    alive = idx[None, :] < count[:, None]                    # (K,P)
    big = 3.4e38

    ykey = torch.where(alive, xy[..., 1], big)
    min_y = ykey.amin(1)
    cand = alive & (xy[..., 1] == min_y[:, None])
    start = torch.argmin(torch.where(cand, xy[..., 0], big), dim=1).to(_I32)

    d = xy[:, None, :, :] - xy[:, :, None, :]          # (K, P cur, P other, 2)
    dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]        # (K,P,P)
    cross = (d[:, :, :, None, 0] * d[:, :, None, :, 1]
             - d[:, :, :, None, 1] * d[:, :, None, :, 0])  # (K,cur,q,k)
    # the tolerance scales with |d_q||d_k|: collinear pairs produce
    # O(eps*|dq||dk|) noise of either sign
    tol = 1e-5 * torch.sqrt(torch.clamp(
        dist2[:, :, :, None] * dist2[:, :, None, :], min=1e-30))
    self_or_dead = (~alive)[:, None, :] | (idx[None, :] == idx[:, None])[None]
    bad = (cross < -tol) & (~self_or_dead)[:, :, None, :]
    strictly_right_none = ~(bad & (~self_or_dead)[:, :, :, None]).any(3)
    score = torch.where(strictly_right_none & ~self_or_dead, dist2, -1.0)
    succ = torch.argmax(score, dim=2).to(_I32)               # (K,P)
    has_next = score.amax(2) > 0.0                           # (K,P)
    return start, succ, has_next


def _walk(start: torch.Tensor, succ: torch.Tensor, has_next_tab: torch.Tensor,
          count: torch.Tensor, max_out: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk each successor chain from its start (the sequential
    gift-wrap's state machine) for up to max_out vertices. Returns (vertex
    indices (K, max_out) with -1 padding, vertex counts (K,))."""
    verts = []
    cur, done = start, count < 1
    n_emitted = torch.zeros_like(count, dtype=_I32)
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
    """CCW convex hulls (strictly convex) for batches of padded clusters.

    xy: (..., C, P, 2); counts: (..., C). Returns a PolygonBatch with up
    to max_out vertices per hull (indices resolved to coordinates) and the
    same leading axes. The successor tables are built _HULL_CHUNK clusters
    of each frame at a time (their (P, P, P) transients grow cubically in
    P); the walk then runs once over every cluster.
    """
    lead, (c, p) = xy.shape[:-3], xy.shape[-3:-1]
    xyf = xy.reshape(-1, c, p, 2)
    cf = counts.reshape(-1, c)
    parts = [_successors(xyf[:, lo:lo + _HULL_CHUNK].reshape(-1, p, 2),
                         cf[:, lo:lo + _HULL_CHUNK].reshape(-1))
             for lo in range(0, c, _HULL_CHUNK)]
    # back to (frames, C) order: chunk k holds clusters [128k, 128k + 128)
    start, succ, has_next = (
        torch.cat([part[i].reshape(xyf.shape[0], -1, *part[i].shape[1:])
                   for part in parts], 1).reshape(-1, *parts[0][i].shape[1:])
        for i in range(3))
    verts_idx, n_out = _walk(start, succ, has_next, cf.reshape(-1), max_out)
    verts_idx = verts_idx.reshape(*lead, c, max_out)
    coords = torch.take_along_dim(
        xy, torch.clamp(verts_idx, 0, p - 1).long()[..., None].expand(
            *verts_idx.shape, 2), dim=-2)
    coords = torch.where((verts_idx >= 0)[..., None], coords, 0.0)
    return PolygonBatch(coords, n_out.reshape(*lead, c))
