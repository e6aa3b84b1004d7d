"""The three micro-probes of tools/probe_mosaic2.py: CUDA kernels + twins.

Port of its Pallas kernels, each computing what the Mosaic probe computes:

  A ``gather_sum(idx, val)``   -> (1, 1) int32, sum of val[idx[i]];
  B ``slice_sum(off, planes)`` -> (1, 1) f32, sum over i of the two rows
                                  [off[i], off[i] + 2) of a (R, W) array;
  C ``tile_scale(x)``          -> (n/128, 128) f32, 2 * x.

On CUDA tensors each launches its kernel in csrc/probe_mosaic2.cu (one
launch a call, through ``_build.launch``) and counts the launch; on CPU
tensors it runs its plain twin. A and C equal their twins exactly. B sums
in its own fixed order (the head of csrc/probe_mosaic2.cu;
tools/probe_mosaic2.py::slice_sum_order_model computes it): the same bits
on every call with the same inputs and grid, and within 1e-5 of the sum
of |terms| of the twin.

A is one cluster of 8 blocks reducing through distributed shared memory
(or, with ``design="atomic"``, block sums added atomically into a zeroed
output); C float4 loads and stores; B ``slice_sum_grid(device, n)``
blocks of 16-byte row reads whose last block to finish adds the block
sums in a fixed order, in the same launch.
"""

from __future__ import annotations

import torch

from . import _build

_LANES = 128
GATHER_DESIGNS = {"cluster": 0, "atomic": 1}
# slice_sum's kernel constants (csrc/probe_mosaic2.cu kSlice*)
SLICE_WARPS = 8           # warps a block
SLICE_TERMS = 4           # terms a warp has in flight
SLICE_CHUNKS = 6          # chunks of 32 items a term loads at once
SLICE_BLOCKS_PER_SM = 2
# (device index, raw stream) -> slice_sum's workspace: a ticket, then room
# for the block sums of the largest grid. A workspace is bound to its
# stream: two calls in flight on two streams would share the ticket, so
# each stream gets its own, made at its first call and kept for the life
# of the process.
_SLICE_WORKSPACES: dict = {}
_SLICE_MAX_GRIDS: dict = {}


def gather_sum_ref(idx, val) -> torch.Tensor:
    take = val[torch.clamp(idx, 0, val.shape[0] - 1).long()]
    return take.sum(dtype=torch.int32).reshape(1, 1)


def gather_sum(idx, val, design: str = "cluster") -> torch.Tensor:
    """A: (1, 1) int32 sum of val[idx[i]] (indices clamped), one kernel
    launch a call; idx 16-byte aligned (it is read as int4)."""
    if not idx.is_cuda:
        return gather_sum_ref(idx, val)
    dev = _build.checked("gather_sum", ("idx", idx, torch.int32, 1),
                         ("val", val, torch.int32, 1))
    n_val = val.shape[0]
    if n_val == 0:
        raise ValueError("gather_sum: val is empty")
    ptr = idx.data_ptr()
    if ptr % 16:
        raise ValueError("gather_sum: idx must be 16-byte aligned")
    out = idx.new_empty((1, 1))
    _build.launch(gather_sum, "gather_sum_launch", dev, ptr, val.data_ptr(),
                  idx.shape[0], n_val, out.data_ptr(), GATHER_DESIGNS[design])
    return out


def slice_sum_ref(off, planes) -> torch.Tensor:
    r = torch.clamp(off, 0, planes.shape[0] - 2).long()
    rows = planes[r[:, None] + torch.arange(2, device=planes.device)]
    return rows.sum().reshape(1, 1)


def _slice_max_grid(index: int) -> int:
    """SLICE_BLOCKS_PER_SM blocks an SM of card `index` (its
    multiprocessor count, read once a card)."""
    grid = _SLICE_MAX_GRIDS.get(index)
    if grid is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        grid = _SLICE_MAX_GRIDS[index] = SLICE_BLOCKS_PER_SM * sms
    return grid


def slice_sum_grid(device, n: int) -> int:
    """Blocks of a slice_sum launch of `n` terms on `device`: one warp a
    term, at most SLICE_BLOCKS_PER_SM blocks an SM, at least one block."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return _slice_grid(index, n)


def _slice_grid(index: int, n: int) -> int:
    return max(1, min(_slice_max_grid(index), -(-n // SLICE_WARPS)))


def _slice_workspace(device, stream: int) -> torch.Tensor:
    ws = torch.zeros(1 + _slice_max_grid(device.index), dtype=torch.int32,
                     device=device)
    _SLICE_WORKSPACES[(device.index, stream)] = ws
    return ws


def slice_sum(off, planes) -> torch.Tensor:
    """B: (1, 1) f32 sum of planes[off[i]:off[i] + 2, :] over i (row
    offsets clamped into [0, R - 2]); R >= 2, W >= 1, any n (0.0 at
    n = 0). One kernel launch a call, which allocates only the output;
    planes 16-byte aligned (its rows are read as float4 where W % 4 == 0)."""
    if not off.is_cuda:
        return slice_sum_ref(off, planes)
    dev = _build.checked("slice_sum", ("off", off, torch.int32, 1),
                         ("planes", planes, torch.float32, 2))
    rows, width = planes.shape
    if rows < 2 or width < 1:
        raise ValueError(f"slice_sum: planes must be (R >= 2, W >= 1), got "
                         f"({rows}, {width})")
    ptr = planes.data_ptr()
    if ptr % 16:
        raise ValueError("slice_sum: planes must be 16-byte aligned")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ws = _SLICE_WORKSPACES.get((dev.index, stream))
    if ws is None:
        ws = _slice_workspace(dev, stream)
    out = planes.new_empty((1, 1))
    n = off.shape[0]
    _build.launch(slice_sum, "slice_sum_launch", dev, off.data_ptr(), ptr,
                  n, rows, width, _slice_grid(dev.index, n), ws.data_ptr(),
                  out.data_ptr(), stream=stream)
    return out


def tile_scale_ref(x) -> torch.Tensor:
    return (x * 2.0).reshape(-1, _LANES)


def tile_scale(x) -> torch.Tensor:
    """C: 2 * x as (n/128, 128) f32 tiles; n a multiple of 128, x 16-byte
    aligned (it is read as float4)."""
    n = x.shape[0]
    if n % _LANES:
        raise ValueError(f"tile_scale: n={n} is not a multiple of {_LANES}")
    if not x.is_cuda:
        return tile_scale_ref(x)
    dev = _build.checked("tile_scale", ("x", x, torch.float32, 1))
    ptr = x.data_ptr()
    if ptr % 16:
        raise ValueError("tile_scale: x must be 16-byte aligned")
    out = x.new_empty((n // _LANES, _LANES))
    _build.launch(tile_scale, "tile_scale_launch", dev, ptr, out.data_ptr(),
                  n)
    return out


gather_sum.launches = 0
slice_sum.launches = 0
tile_scale.launches = 0
