"""Closed-form symmetric 3x3 eigen-analysis, batched over leading dims.

Port of ``lidar_processing_tpu/ops/eig3.py``: the trigonometric closed
form (Cardano / Eberly-style) in place of the reference's Eigen::JacobiSVD
(ref: src/segmentation.cpp:87-99), with the same upward sign
canonicalisation (n_z >= 0, falling back to the largest-magnitude
component positive). The 3x3 determinant is the explicit cofactor sum
jnp.linalg.det uses for 3x3 inputs.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _det3(a: torch.Tensor) -> torch.Tensor:
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division, as XLA computes it (torch on CUDA turns
    `tensor / python_scalar` into a multiply by the reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _eye(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=a.dtype, device=a.device)


def smallest_eigenvalue_3x3(a: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of symmetric (...,3,3) matrices (trig form)."""
    q = _div(a.diagonal(dim1=-2, dim2=-1).sum(-1), 3.0)
    b = a - q[..., None, None] * _eye(a)
    p2 = (b * b).sum(dim=(-2, -1))
    p = torch.sqrt(torch.clamp(_div(p2, 6.0), min=0.0))
    safe_p = torch.clamp(p, min=_EPS)
    bn = b / safe_p[..., None, None]
    r = torch.clamp(_div(_det3(bn), 2.0), -1.0, 1.0)
    phi = _div(torch.arccos(r), 3.0)
    # eigenvalues are q + 2p*cos(phi + 2k*pi/3); k=0 gives the largest.
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = q + 2.0 * p * torch.cos(phi - 2.0 * math.pi / 3.0)
    lam_min = torch.minimum(lam_min, lam_mid)  # guard ordering edge cases
    return torch.where(p2 < _EPS, q, lam_min)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0] + v[..., 1] + v[..., 2]


def smallest_eigenvector_3x3(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for the smallest eigenvalue of symmetric (...,3,3)
    matrices, canonicalised upward.

    Recovered as the largest cross product of two rows of (A - lam*I);
    degenerate (isotropic) inputs return +e_z.
    """
    lam = smallest_eigenvalue_3x3(a)
    m = a - lam[..., None, None] * _eye(a)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)  # (...,3,3)
    norms = _sum3(cands * cands)                               # (...,3)
    best = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(
        cands, best[..., None, None].expand(*best.shape, 1, 3),
        dim=-2)[..., 0, :]
    degenerate = norms.amax(-1) < _EPS
    ez = torch.cat([torch.zeros_like(v[..., :2]),
                    torch.ones_like(v[..., 2:])], dim=-1)
    v = torch.where(degenerate[..., None], ez, v)
    norm = torch.sqrt(_sum3(v * v))[..., None]
    v = v / torch.clamp(norm, min=_EPS)

    # canonical sign: upward; tie-break on largest-magnitude component
    vz = v[..., 2]
    kmax = torch.argmax(v.abs(), dim=-1)
    vmax = torch.take_along_dim(v, kmax[..., None], dim=-1)[..., 0]
    flip = torch.where(vz != 0.0, vz < 0.0, vmax < 0.0)
    return torch.where(flip[..., None], -v, v)
