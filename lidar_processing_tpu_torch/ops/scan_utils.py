"""Sort and run primitives shared by the port's ops.

Port of ``lidar_processing_tpu/ops/scan_utils.py`` plus the one sort
helper every op uses in place of ``lax.sort``. All int results are int32,
as in the JAX package (packed sort keys depend on it).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

IMAX = 2 ** 31 - 1


def sort_by(keys: Union[torch.Tensor, Tuple[torch.Tensor, ...]],
            *payload: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Stable lexicographic sort, returning every operand permuted.

    The counterpart of ``lax.sort((*keys, *payload), num_keys=len(keys))``:
    ``keys`` is one tensor or a tuple (most significant first), sorted with
    stable passes from the least significant key up, so ties keep input
    order as lax.sort's stable sort does. Float keys compare as ``key +
    0.0``, so -0.0 ties with 0.0 as in lax.sort; the returned keys are the
    original values.
    """
    keys = keys if isinstance(keys, tuple) else (keys,)
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        if k.is_floating_point():
            k = k + 0.0
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return tuple(t[perm] for t in keys + payload)


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _first_slots(sorted_pos: torch.Tensor, count: int) -> torch.Tensor:
    """The first `count` entries of a sorted position list, IMAX-padded."""
    n = sorted_pos.shape[0]
    if count <= n:
        return sorted_pos[:count]
    return torch.cat([sorted_pos, sorted_pos.new_full((count - n,), IMAX)])


def run_starts(new_run: torch.Tensor, num_runs: int) -> torch.Tensor:
    """Each run's start position as a (num_runs,) table.

    new_run: (N,) bool marking run starts. Slots beyond the real run count
    hold N. The table is indexed by implicit run id == the rank of the
    flagged position (``cumsum(new_run) - 1``): the k-th run's start is
    the k-th smallest flagged position, so ONE sort builds it.
    """
    n = new_run.shape[0]
    flagged = torch.where(new_run, _positions(n, new_run.device), IMAX)
    take = _first_slots(torch.sort(flagged).values, num_runs)
    return torch.clamp(take, max=n)


def compact_mask(mask: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the indices where mask is True into a (capacity,) buffer.

    Returns (indices, count, overflow) with 0-d int32 count/overflow.
    Overflowing entries are dropped; slots beyond the count hold 0.
    """
    n = mask.shape[0]
    flagged = torch.where(mask, _positions(n, mask.device), IMAX)
    take = _first_slots(torch.sort(flagged).values, capacity)
    count = mask.sum(dtype=torch.int32)
    idx = torch.where(_positions(capacity, mask.device) < count, take, 0)
    overflow = torch.clamp(count - capacity, min=0)
    return idx, torch.clamp(count, max=capacity), overflow


def seg_broadcast_first(values: torch.Tensor,
                        seg_ids: torch.Tensor) -> torch.Tensor:
    """Propagate each run's FIRST value over its run of equal seg_ids.

    The run-start position is a cummax of flagged starts, then one gather
    (the JAX package uses an associative scan for the same result).
    """
    n = seg_ids.shape[0]
    if n == 0:
        return values
    new = torch.cat([torch.ones_like(seg_ids[:1], dtype=torch.bool),
                     seg_ids[1:] != seg_ids[:-1]])
    pos = torch.arange(n, device=seg_ids.device)
    start = torch.where(new, pos, 0).cummax(0).values
    return values[start]


# ---- JAX indexing semantics, spelled out ---------------------------------
# (torch raises on out-of-range indices where JAX clamps or drops them)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with indices clamped into range, as a JAX gather does."""
    return x[torch.clamp(idx, 0, x.shape[0] - 1).long()]


def dynamic_slice(x: torch.Tensor, start: torch.Tensor, size: int
                  ) -> torch.Tensor:
    """lax.dynamic_slice for a start >= 0: the start clamps so the slice
    fits (a gather, so the start stays on the device)."""
    lo = torch.clamp(start, 0, x.shape[0] - size)
    return x[(lo + _positions(size, x.device)).long()]


def scatter_min_rows(rows: int, idx: torch.Tensor, vals: torch.Tensor,
                     fill: float) -> torch.Tensor:
    """(rows, K) table of per-target minima of vals (n, K); indices >= rows
    are dropped (dump slot)."""
    k = vals.shape[1]
    buf = torch.full((rows + 1, k), fill, dtype=vals.dtype,
                     device=vals.device)
    tgt = torch.clamp(idx, max=rows).long()[:, None].expand(-1, k)
    return buf.scatter_reduce(0, tgt, vals, "amin")[:rows]


def scatter_drop(size: int, idx: torch.Tensor, vals: torch.Tensor,
                 fill, reduce: str) -> torch.Tensor:
    """(size,) scatter-reduce ("sum"/"amin"/"amax") with dropped
    out-of-range indices."""
    buf = torch.full((size + 1,), fill, dtype=vals.dtype, device=vals.device)
    tgt = torch.clamp(idx, max=size).long()
    return buf.scatter_reduce(0, tgt, vals, reduce)[:size]


def set_drop(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """buf.at[idx].set(vals, mode="drop") for non-negative idx; a scalar
    `vals` is filled on the device (a host scalar would be copied over)."""
    size = buf.shape[0]
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(idx.shape, vals, dtype=buf.dtype, device=buf.device)
    out = torch.cat([buf, buf[:1]])
    out[torch.clamp(idx, max=size).long()] = vals
    return out[:size]
