"""Per-pair min squared distance between two point runs: CUDA kernel + twin.

Port of the Pallas kernels of ``tools/probe_mosaic.py`` and
``tools/probe_mosaic3.py``: for pair p, the min of d² between the run
[us, us + uc) and the run [vs, vs + vc) of one point array, read in place,
with u runs capped at 8 points and v runs at 48 or 96. On CUDA tensors
``pair_min_d2_v48`` / ``pair_min_d2_v96`` launch csrc/probe_pairs.cu (one
warp per pair, no window tensor) and count the launch; on CPU tensors they
run the twin ``pair_min_d2_ref``: the windows gathered with the ±1e9
fills ``kernels/tier_min_d2.py::_stacked_windows`` uses, then
``min_d2_planar_ref``. Both evaluate d² as fma(dz, dz, fma(dx, dx,
dy·dy)), so they agree bit for bit.

``mosaic_pairs`` and ``mosaic3_pairs`` take the JAX probes' own layouts
((n/8, 24) stacked rows, (n/128 + pad, 384) planar rows) and turn them into
the x/y/z planes the kernel reads.
"""

from __future__ import annotations

import torch

from . import _build
from .min_d2 import min_d2_planar_ref

U_CAP = 8
_F_BIG = 1.0e9


def gather_windows(plane, start, count, cap: int, fill: float):
    """(P, cap) window of plane[start + k] for k < min(count, cap), with
    indices clamped into the plane and `fill` beyond the run."""
    k = torch.arange(cap, dtype=torch.int32, device=plane.device)
    idx = torch.clamp(start[:, None] + k[None, :], 0, plane.shape[0] - 1)
    ok = k[None, :] < torch.clamp(count, max=cap)[:, None]
    return torch.where(ok, plane[idx.long()], fill)


def pair_min_d2_ref(x, y, z, us, uc, vs, vc, v_cap: int) -> torch.Tensor:
    """Plain twin: gather both windows, then min_d2_planar_ref."""
    pu = [gather_windows(a, us, uc, U_CAP, _F_BIG) for a in (x, y, z)]
    pv = [gather_windows(a, vs, vc, v_cap, -_F_BIG) for a in (x, y, z)]
    return min_d2_planar_ref(*pu, *pv)


def _launch(fn, v_cap: int, x, y, z, us, uc, vs, vc):
    name = fn.__name__
    _build.checked(name, *((what, t, torch.float32, 1)
                           for what, t in (("x", x), ("y", y), ("z", z))),
                   *((what, t, torch.int32, 1) for what, t in
                     (("us", us), ("uc", uc), ("vs", vs), ("vc", vc))))
    n, p = x.shape[0], us.shape[0]
    if n == 0 or y.shape[0] != n or z.shape[0] != n:
        raise ValueError(f"{name}: x/y/z must be (n,) planes, n > 0")
    if any(t.shape[0] != p for t in (uc, vs, vc)):
        raise ValueError(f"{name}: us/uc/vs/vc must all be (P,)")
    out = torch.empty((p,), dtype=torch.float32, device=x.device)
    _build.launch(fn, f"pair_min_d2_v{v_cap}_launch", x.device,
                  x.data_ptr(), y.data_ptr(), z.data_ptr(), n,
                  *(t.data_ptr() for t in (us, uc, vs, vc)), out.data_ptr(),
                  p)
    return out


def pair_min_d2_v48(x, y, z, us, uc, vs, vc) -> torch.Tensor:
    """(P,) f32 min d² per pair; u runs <= 8, v runs <= 48 points."""
    if not x.is_cuda:
        return pair_min_d2_ref(x, y, z, us, uc, vs, vc, 48)
    return _launch(pair_min_d2_v48, 48, x, y, z, us, uc, vs, vc)


def pair_min_d2_v96(x, y, z, us, uc, vs, vc) -> torch.Tensor:
    """(P,) f32 min d² per pair; u runs <= 8, v runs <= 96 points."""
    if not x.is_cuda:
        return pair_min_d2_ref(x, y, z, us, uc, vs, vc, 96)
    return _launch(pair_min_d2_v96, 96, x, y, z, us, uc, vs, vc)


pair_min_d2_v48.launches = 0
pair_min_d2_v96.launches = 0


def row_planes(rows: torch.Tensor, lanes: int):
    """x, y, z planes (contiguous) of a (R, 3 * lanes) row layout whose
    row r holds points [r * lanes, (r + 1) * lanes) plane after plane."""
    p = rows.reshape(rows.shape[0], 3, lanes).transpose(0, 1).reshape(3, -1)
    return p[0], p[1], p[2]


def mosaic_pairs(stacked, us, uc, vs, vc) -> torch.Tensor:
    """tools/probe_mosaic.py's kernel: stacked is the (n/8, 24) view."""
    return pair_min_d2_v48(*row_planes(stacked, 8), us, uc, vs, vc)


def mosaic3_pairs(us, uc, vs, vc, planes) -> torch.Tensor:
    """tools/probe_mosaic3.py's kernel: planes is (n/128 + pad, 384)."""
    return pair_min_d2_v96(*row_planes(planes, 128), us, uc, vs, vc)
