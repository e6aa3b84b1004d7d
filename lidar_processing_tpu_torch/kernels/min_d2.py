"""Batched min pairwise squared distance between runs: CUDA kernel + twin.

Port of ``lidar_processing_tpu/kernels/min_d2.py``. The clustering exact
tests (ops/stixel.py) reduce to: for P pairs of point windows u (P, Wu)
and v (P, Wv), given as planar x/y/z coordinate planes, compute
min over (i, j) of ||u_i - v_j||^2. On a CUDA tensor ``min_d2_planar``
launches the hand-written Hopper kernel (csrc/min_d2.cu); on a CPU tensor
it runs the plain PyTorch twin ``min_d2_planar_ref``. Both evaluate
d² = dx² + dy² + dz² unfused in that order, so they agree bit for bit;
the JAX package's own tolerance (<= 4 ULP) exists only for FMA
contraction on its side.
"""

from __future__ import annotations

import torch

from . import _build

# twin temporaries: (chunk, Wu, Wv) f32 blocks of at most ~64 MB
_REF_BLOCK_ELEMS = 16 * 1024 * 1024


def min_d2_planar_ref(ux, uy, uz, vx, vy, vz) -> torch.Tensor:
    """Plain PyTorch twin: the broadcast formulation of the JAX package's
    ``min_d2_planar_xla``, chunked over P to bound the (P, Wu, Wv)
    temporaries. Same op order as the kernel (in place, two temporaries
    per chunk)."""
    p, wu = ux.shape
    wv = vx.shape[1]
    chunk = max(1, _REF_BLOCK_ELEMS // max(wu * wv, 1))
    out = torch.empty((p,), dtype=torch.float32, device=ux.device)
    for lo in range(0, p, chunk):
        sl = slice(lo, lo + chunk)
        d2 = ux[sl, :, None] - vx[sl, None, :]
        d2.mul_(d2)
        d = uy[sl, :, None] - vy[sl, None, :]
        d2.add_(d.mul_(d))
        torch.sub(uz[sl, :, None], vz[sl, None, :], out=d)
        d2.add_(d.mul_(d))
        out[sl] = d2.flatten(1).amin(dim=1)
    return out


def _check(planes, p, w, side):
    for t in planes:
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"min_d2_planar: {side} planes must be 2-D "
                             f"float32, got {t.dtype} {tuple(t.shape)}")
        if tuple(t.shape) != (p, w):
            raise ValueError(f"min_d2_planar: {side} plane shape "
                             f"{tuple(t.shape)} != {(p, w)}")
        if not t.is_contiguous():
            raise ValueError("min_d2_planar: planes must be contiguous")


def min_d2_planar(ux, uy, uz, vx, vy, vz) -> torch.Tensor:
    """min_{i,j} ((ux[p,i]-vx[p,j])² + …) per pair p -> (P,) f32.

    All six inputs (P, W*) f32 with masked lanes pre-filled so that
    u-fill − v-fill is huge (the caller uses +1e9 / −1e9). A CUDA input
    launches csrc/min_d2.cu (and counts the launch in
    ``min_d2_planar.launches``); a CPU input runs the twin.
    """
    planes = (ux, uy, uz, vx, vy, vz)
    if not ux.is_cuda:
        return min_d2_planar_ref(*planes)
    if any(t.device != ux.device for t in planes):
        raise ValueError("min_d2_planar: all planes must be on one device")
    p, wu = ux.shape
    wv = vx.shape[1]
    _check(planes[:3], p, wu, "u")
    _check(planes[3:], p, wv, "v")
    out = torch.empty((p,), dtype=torch.float32, device=ux.device)
    if p == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(ux.device):
        stream = torch.cuda.current_stream(ux.device).cuda_stream
        rc = lib.min_d2_planar_launch(
            *(t.data_ptr() for t in planes), out.data_ptr(), p, wu, wv,
            stream)
    _build.check(rc, "min_d2_planar")
    min_d2_planar.launches += 1
    return out


min_d2_planar.launches = 0
