"""The three micro-probes of tools/probe_mosaic2.py: CUDA kernels + twins.

Port of its Pallas kernels, each computing what the Mosaic probe computes:

  A ``gather_sum(idx, val)``   -> (1, 1) int32, sum of val[idx[i]];
  B ``slice_sum(off, planes)`` -> (1, 1) f32, sum over i of the two rows
                                  [off[i], off[i] + 2) of a (R, W) array;
  C ``tile_scale(x)``          -> (n/128, 128) f32, 2 * x.

On CUDA tensors each launches its kernel in csrc/probe_mosaic2.cu and
counts the launch; on CPU tensors it runs its plain twin. A and C equal
their twins exactly; B sums in another order (f32).

A and C are the redesigned versions: A one launch a call (one cluster of
8 blocks reducing through distributed shared memory, or, with
``design="atomic"``, block sums added atomically into a zeroed output),
C float4 loads and stores; both through ``_build.launch``'s short host
path. ``gather_sum_v0`` and ``tile_scale_v0`` keep the first port's
kernels and wrappers, through ``_build.launch_v0``, so that one process
can time old against new.
"""

from __future__ import annotations

import torch

from . import _build

_PARTIALS = 256      # csrc/probe_mosaic2.cu kMaxBlocks
_LANES = 128
GATHER_DESIGNS = {"cluster": 0, "atomic": 1}


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


def gather_sum_v0(idx, val) -> torch.Tensor:
    """A as the first port had it: two kernels a call and a partials
    buffer allocated by the wrapper; through ``_build.launch_v0``."""
    if not idx.is_cuda:
        return gather_sum_ref(idx, val)
    dev = _build.checked("gather_sum_v0", ("idx", idx, torch.int32, 1),
                         ("val", val, torch.int32, 1))
    if val.shape[0] == 0:
        raise ValueError("gather_sum_v0: val is empty")
    part = torch.empty((_PARTIALS,), dtype=torch.int32, device=dev)
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    _build.launch_v0(gather_sum_v0, "gather_sum_v0_launch", dev,
                     idx.data_ptr(), val.data_ptr(), idx.shape[0],
                     val.shape[0], part.data_ptr(), out.data_ptr())
    return out


def slice_sum_ref(off, planes) -> torch.Tensor:
    r = torch.clamp(off, 0, planes.shape[0] - 2).long()
    rows = planes[r[:, None] + torch.arange(2, device=planes.device)]
    return rows.sum().reshape(1, 1)


def slice_sum(off, planes) -> torch.Tensor:
    """B: (1, 1) f32 sum of planes[off[i]:off[i] + 2, :] over i (row
    offsets clamped into [0, R - 2])."""
    if not off.is_cuda:
        return slice_sum_ref(off, planes)
    dev = _build.checked("slice_sum", ("off", off, torch.int32, 1),
                         ("planes", planes, torch.float32, 2))
    if planes.shape[0] < 2:
        raise ValueError("slice_sum: planes needs at least 2 rows")
    part = torch.empty((_PARTIALS,), dtype=torch.float32, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    _build.launch(slice_sum, "slice_sum_launch", dev, off.data_ptr(),
                  planes.data_ptr(), off.shape[0], planes.shape[0],
                  planes.shape[1], part.data_ptr(), out.data_ptr())
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


def tile_scale_v0(x) -> torch.Tensor:
    """C as the first port had it: a grid-stride scalar loop, through
    ``_build.launch_v0``."""
    if x.shape[0] % _LANES:
        raise ValueError(f"tile_scale_v0: n={x.shape[0]} is not a multiple "
                         f"of {_LANES}")
    if not x.is_cuda:
        return tile_scale_ref(x)
    dev = _build.checked("tile_scale_v0", ("x", x, torch.float32, 1))
    out = torch.empty((x.shape[0] // _LANES, _LANES), dtype=torch.float32,
                      device=dev)
    _build.launch_v0(tile_scale_v0, "tile_scale_v0_launch", dev,
                     x.data_ptr(), out.data_ptr(), x.shape[0])
    return out


gather_sum.launches = 0
gather_sum_v0.launches = 0
slice_sum.launches = 0
tile_scale.launches = 0
tile_scale_v0.launches = 0
