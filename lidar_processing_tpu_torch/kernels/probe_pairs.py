"""Per-pair min squared distance between two point runs: CUDA kernel + twin.

Port of the Pallas kernels of ``tools/probe_mosaic.py`` and
``tools/probe_mosaic3.py``: for pair p, the min of d² between the run
[us, us + uc) and the run [vs, vs + vc) of one point array, with u runs
capped at 8 points and v runs at 48 or 96. The points come in the
caller's own row layout, read in place: a contiguous f32 (R, 3·L) tensor
whose point k has axis a at ``points[k // L, a * L + k % L]`` (L = 8:
probe_mosaic's stacked view; L = 128: probe_mosaic3's rows; L = n, R = 1:
a (3, n) planar tensor seen as (1, 3n)); indices clamp into the R·L
points, padding rows included.

On CUDA tensors ``pair_min_d2_v48`` / ``pair_min_d2_v96`` launch
csrc/probe_pairs.cu (one warp per pair, the trimmed window: the real
points plus one fill row and one fill column; one launch a call) and
count the launch; on CPU tensors they run the twin: the layout's
x/y/z planes (``row_planes``), then ``pair_min_d2_ref``, the windows
gathered with the ±1e9 fills ``kernels/tier_min_d2.py::_stacked_windows``
uses, then ``min_d2_planar_ref``. Both evaluate d² as fma(dz, dz, fma(dx,
dx, dy·dy)), so they agree bit for bit.

``mosaic_pairs`` and ``mosaic3_pairs`` are the JAX probes' calls, on their
own layouts.
"""

from __future__ import annotations

import torch

from . import _build
from .min_d2 import min_d2_planar_ref

U_CAP = 8
_F_BIG = 1.0e9
_I32_MAX = 2**31 - 1


def gather_windows(plane, start, count, cap: int, fill: float):
    """(P, cap) window of plane[start + k] for k < min(count, cap), with
    indices clamped into the plane and `fill` beyond the run."""
    k = torch.arange(cap, dtype=torch.int32, device=plane.device)
    idx = torch.clamp(start[:, None] + k[None, :], 0, plane.shape[0] - 1)
    ok = k[None, :] < torch.clamp(count, max=cap)[:, None]
    return torch.where(ok, plane[idx.long()], fill)


def pair_min_d2_ref(x, y, z, us, uc, vs, vc, v_cap: int) -> torch.Tensor:
    """Plain twin on x/y/z planes: gather both windows, then
    min_d2_planar_ref."""
    pu = [gather_windows(a, us, uc, U_CAP, _F_BIG) for a in (x, y, z)]
    pv = [gather_windows(a, vs, vc, v_cap, -_F_BIG) for a in (x, y, z)]
    return min_d2_planar_ref(*pu, *pv)


def row_planes(rows: torch.Tensor, lanes: int):
    """x, y, z planes (contiguous) of a (R, 3 * lanes) row layout whose
    row r holds points [r * lanes, (r + 1) * lanes) plane after plane."""
    p = rows.reshape(rows.shape[0], 3, lanes).transpose(0, 1).reshape(3, -1)
    return p[0], p[1], p[2]


def _check_layout(name: str, points, lanes: int) -> None:
    if points.dim() != 2 or lanes <= 0 or points.shape[0] == 0 or (
            points.shape[1] != 3 * lanes):
        raise ValueError(f"{name}: points must be (R, 3 * lanes) with R > 0, "
                         f"got {tuple(points.shape)} for lanes={lanes}")
    if points.shape[0] * lanes > _I32_MAX:
        raise ValueError(f"{name}: more than 2**31 - 1 points")


def _launch(fn, v_cap: int, points, lanes: int, us, uc, vs, vc):
    name = fn.__name__
    dev = _build.checked(name, ("points", points, torch.float32, 2),
                         *((what, t, torch.int32, 1) for what, t in
                           (("us", us), ("uc", uc), ("vs", vs), ("vc", vc))))
    _check_layout(name, points, lanes)
    p = us.shape[0]
    if uc.shape[0] != p or vs.shape[0] != p or vc.shape[0] != p:
        raise ValueError(f"{name}: us/uc/vs/vc must all be (P,)")
    out = points.new_empty((p,))
    _build.launch(fn, f"pair_min_d2_v{v_cap}_launch", dev,
                  points.data_ptr(), points.shape[0], lanes, us.data_ptr(),
                  uc.data_ptr(), vs.data_ptr(), vc.data_ptr(),
                  out.data_ptr(), p)
    return out


def _twin(name: str, v_cap: int, points, lanes: int, us, uc, vs, vc):
    _check_layout(name, points, lanes)
    return pair_min_d2_ref(*row_planes(points, lanes), us, uc, vs, vc, v_cap)


def pair_min_d2_v48(points, lanes: int, us, uc, vs, vc) -> torch.Tensor:
    """(P,) f32 min d² per pair; u runs <= 8, v runs <= 48 points of the
    (R, 3 * lanes) layout `points`."""
    if not points.is_cuda:
        return _twin("pair_min_d2_v48", 48, points, lanes, us, uc, vs, vc)
    return _launch(pair_min_d2_v48, 48, points, lanes, us, uc, vs, vc)


def pair_min_d2_v96(points, lanes: int, us, uc, vs, vc) -> torch.Tensor:
    """(P,) f32 min d² per pair; u runs <= 8, v runs <= 96 points of the
    (R, 3 * lanes) layout `points`."""
    if not points.is_cuda:
        return _twin("pair_min_d2_v96", 96, points, lanes, us, uc, vs, vc)
    return _launch(pair_min_d2_v96, 96, points, lanes, us, uc, vs, vc)


pair_min_d2_v48.launches = 0
pair_min_d2_v96.launches = 0


def planar(xyz: torch.Tensor) -> torch.Tensor:
    """An (n, 3) point array as the planar layout (1, 3n), lanes = n."""
    return xyz.T.contiguous().reshape(1, -1)


def mosaic_pairs(stacked, us, uc, vs, vc) -> torch.Tensor:
    """tools/probe_mosaic.py's kernel: stacked is the (n/8, 24) view."""
    return pair_min_d2_v48(stacked, 8, us, uc, vs, vc)


def mosaic3_pairs(us, uc, vs, vc, planes) -> torch.Tensor:
    """tools/probe_mosaic3.py's kernel: planes is (n/128 + pad, 384)."""
    return pair_min_d2_v96(planes, 128, us, uc, vs, vc)
