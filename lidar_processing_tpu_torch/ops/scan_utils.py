"""Sort and run primitives shared by the port's ops, and the sum of three
squares that every clustering distance screen shares (``sum_sq3``).

Port of ``lidar_processing_tpu/ops/scan_utils.py`` plus the one sort
helper every op uses in place of ``lax.sort``. All int results are int32,
as in the JAX package (packed sort keys depend on it).

Every primitive works along the LAST axis (rows of ``take_rows``: the
second to last) and treats any leading axes as a batch: a (B, N) input is
B independent rows, each giving what the (N,) row gives alone, so the
frame batch of the batched step is one call (the JAX package's vmap
written out). Per-row arguments (a slice start, a count) have the
leading shape, with or without a trailing axis of 1. A dropping scatter
gets one dump slot per row, so a dropped index of row b never lands in
row b + 1. The segmented scans ``seg_scan_min`` / ``seg_scan_max`` keep
the JAX package's signature instead: axis 0, elementwise in trailing dims.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

IMAX = 2 ** 31 - 1


def sum_sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
            ) -> torch.Tensor:
    """x² + y² + z² rounded as XLA's CPU compile rounds the JAX package's
    ``jnp.sum(v * v, axis)`` over three components: x·x, then two fused
    multiply-adds, fma(z, z, fma(y, y, x·x)). ``addcmul`` is that fused
    multiply-add, on the CPU and on the card."""
    return torch.addcmul(torch.addcmul(x * x, y, y), z, z)


def sort_by(keys: Union[torch.Tensor, Tuple[torch.Tensor, ...]],
            *payload: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Stable lexicographic sort of each row, returning every operand
    permuted.

    The counterpart of ``lax.sort((*keys, *payload), num_keys=len(keys))``:
    ``keys`` is one tensor or a tuple (most significant first), sorted with
    stable passes from the least significant key up, so ties keep input
    order as lax.sort's stable sort does. Float keys compare as ``key +
    0.0``, so -0.0 ties with 0.0 as in lax.sort; the returned keys are the
    original values. Every operand has the same shape.
    """
    keys = keys if isinstance(keys, tuple) else (keys,)
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key.gather(-1, perm)
        if k.is_floating_point():
            k = k + 0.0
        order = torch.sort(k, dim=-1, stable=True).indices
        perm = order if perm is None else perm.gather(-1, order)
    return tuple(t.gather(-1, perm) for t in keys + payload)


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _per_row(value: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row scalar as a (..., 1) column against x (..., L)."""
    return value.reshape(*x.shape[:-1], 1)


def _first_slots(sorted_pos: torch.Tensor, count: int) -> torch.Tensor:
    """The first `count` entries of each sorted position row, IMAX-padded."""
    n = sorted_pos.shape[-1]
    if count <= n:
        return sorted_pos[..., :count]
    return torch.cat([sorted_pos, sorted_pos.new_full(
        (*sorted_pos.shape[:-1], count - n), IMAX)], -1)


def run_starts(new_run: torch.Tensor, num_runs: int) -> torch.Tensor:
    """Each run's start position as a (..., num_runs) table.

    new_run: (..., N) bool marking run starts. Slots beyond a row's real
    run count hold N. The table is indexed by implicit run id == the rank
    of the flagged position (``cumsum(new_run) - 1``): the k-th run's start
    is the k-th smallest flagged position, so ONE sort builds it.
    """
    n = new_run.shape[-1]
    flagged = torch.where(new_run, _positions(n, new_run.device), IMAX)
    take = _first_slots(torch.sort(flagged, dim=-1).values, num_runs)
    return torch.clamp(take, max=n)


def compact_mask(mask: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack each row's indices where mask is True into a (capacity,) row.

    Returns (indices (..., capacity), count (...), overflow (...)), int32.
    Overflowing entries are dropped; slots beyond the count hold 0.
    """
    n = mask.shape[-1]
    flagged = torch.where(mask, _positions(n, mask.device), IMAX)
    take = _first_slots(torch.sort(flagged, dim=-1).values, capacity)
    count = mask.sum(-1, dtype=torch.int32)
    idx = torch.where(_positions(capacity, mask.device) < count[..., None],
                      take, 0)
    overflow = torch.clamp(count - capacity, min=0)
    return idx, torch.clamp(count, max=capacity), overflow


def seg_broadcast_first(values: torch.Tensor,
                        seg_ids: torch.Tensor) -> torch.Tensor:
    """Propagate each run's FIRST value over its run of equal seg_ids.

    The run-start position is a cummax of flagged starts, then one gather
    (the JAX package uses an associative scan for the same result).
    """
    n = seg_ids.shape[-1]
    if n == 0:
        return values
    new = torch.cat([torch.ones_like(seg_ids[..., :1], dtype=torch.bool),
                     seg_ids[..., 1:] != seg_ids[..., :-1]], -1)
    pos = torch.arange(n, device=seg_ids.device)
    start = torch.where(new, pos, 0).cummax(-1).values
    return values.gather(-1, start)


def _seg_scan(values: torch.Tensor, seg_ids: torch.Tensor, op,
              reverse: bool) -> torch.Tensor:
    """Running `op` within each run of equal sorted seg_ids along axis 0:
    a log-step scan of shifted ``where(seg equal, op(a, b), b)`` combines
    (exact for min and max, whose result does not depend on order)."""
    ids = seg_ids.reshape(seg_ids.shape + (1,) * (values.dim()
                                                  - seg_ids.dim()))
    ids = ids.expand(values.shape)
    if reverse:
        values, ids = values.flip(0), ids.flip(0)
    n, k = values.shape[0], 1
    while k < n:
        same = ids[k:] == ids[:-k]
        values = torch.cat([values[:k], torch.where(
            same, op(values[:-k], values[k:]), values[k:])], 0)
        k *= 2
    return values.flip(0) if reverse else values


def seg_scan_min(values: torch.Tensor, seg_ids: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """Running min within each run of equal (sorted) seg_ids.

    values: (N, ...) — scanned along axis 0, elementwise in trailing dims
    (the JAX package's signature; seg_ids (N,) or values' shape). With
    reverse=True each element sees the min over the rest of its run, so
    the value at a run START is the aggregate over the whole run.
    """
    return _seg_scan(values, seg_ids, torch.minimum, reverse)


def seg_scan_max(values: torch.Tensor, seg_ids: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """seg_scan_min with max."""
    return _seg_scan(values, seg_ids, torch.maximum, reverse)


# ---- JAX indexing semantics, spelled out ---------------------------------
# (torch raises on out-of-range indices where JAX clamps or drops them)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] per row with indices clamped into range, as a JAX gather
    does: x (..., S), idx (..., K) -> (..., K)."""
    return x.gather(-1, torch.clamp(idx, 0, x.shape[-1] - 1).long())


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x per batch entry, indices clamped: x (..., S, K), idx
    (..., *I) with the same leading axes -> (..., *I, K)."""
    lead = x.shape[:-2]
    flat = torch.clamp(idx, 0, x.shape[-2] - 1).long().reshape(*lead, -1)
    out = x.gather(-2, flat[..., None].expand(*flat.shape, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def dynamic_slice(x: torch.Tensor, start: torch.Tensor, size: int
                  ) -> torch.Tensor:
    """lax.dynamic_slice of each row for a start >= 0: the start clamps so
    the slice fits (a gather, so the start stays on the device). x
    (..., L), start (...) -> (..., size)."""
    lo = torch.clamp(_per_row(start, x), 0, x.shape[-1] - size)
    return x.gather(-1, (lo + _positions(size, x.device)).long())


def scatter_min_rows(rows: int, idx: torch.Tensor, vals: torch.Tensor,
                     fill: float) -> torch.Tensor:
    """(..., rows, K) table of per-target minima of vals (..., n, K);
    indices >= rows are dropped (each row's dump slot)."""
    k = vals.shape[-1]
    buf = torch.full((*vals.shape[:-2], rows + 1, k), fill,
                     dtype=vals.dtype, device=vals.device)
    tgt = torch.clamp(idx, max=rows).long()[..., None].expand(*idx.shape, k)
    return buf.scatter_reduce(-2, tgt, vals, "amin")[..., :rows, :]


def scatter_drop(size: int, idx: torch.Tensor, vals: torch.Tensor,
                 fill, reduce: str) -> torch.Tensor:
    """(..., size) scatter-reduce ("sum"/"amin"/"amax") of each row with
    dropped out-of-range indices."""
    buf = torch.full((*vals.shape[:-1], size + 1), fill, dtype=vals.dtype,
                     device=vals.device)
    tgt = torch.clamp(idx, max=size).long()
    return buf.scatter_reduce(-1, tgt, vals, reduce)[..., :size]


def set_drop(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """buf.at[idx].set(vals, mode="drop") per row for non-negative idx; a
    scalar `vals` is filled on the device (a host scalar would be copied
    over). Where two indices of a row collide, their values are equal."""
    size = buf.shape[-1]
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(idx.shape, vals, dtype=buf.dtype, device=buf.device)
    out = torch.cat([buf, buf[..., :1]], -1)
    out.scatter_(-1, torch.clamp(idx, max=size).long(), vals)
    return out[..., :size]
