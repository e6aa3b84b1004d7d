"""The exact-test pass of one stixel tier table: CUDA kernel + twin.

The clustering exact tests (ops/stixel.py::_tiered_exact) sort their pair
records by tier into two packed descriptor arrays, ``s_usuc`` and
``s_vsvc`` (start * 512 + count per side), and count the pairs of each
tier. Tier t = (u_cap, v_cap, slots) then reads its ``slots`` descriptors
from ``starts[t]`` (clamped as ``lax.dynamic_slice`` clamps it), keeps the
first ``n_in_tier[t]`` of them, and computes for each slot the min d²
between the u run's first u_cap points and the v run's first v_cap points.

Every argument may carry a leading frame axis B (the batched step's
frames): each frame's slots are computed from its own points, descriptors,
starts and counts, exactly as a call for that frame alone.

On a CUDA tensor ``tier_min_d2`` launches csrc/tier_min_d2.cu: ONE launch
for every tier of the table and every frame, reading the runs in place from
the (B, NO, 3) point buffer, and counts it in ``tier_min_d2.launches``. On
a CPU tensor it runs the twin ``tier_min_d2_ref``, the computation of the
JAX package tier by tier: dynamic slices, unpacking, ``_stacked_windows``
on both sides and ``min_d2_planar_ref``. Both evaluate d² as fma(dz, dz,
fma(dx, dx, dy·dy)), the rounding of the JAX package's exact test inside
its jitted ``cluster`` on the CPU, and the kernel counts an empty side as
one ±1e9 fill point, as the windows' fill lanes are; so they agree bit
for bit, inactive slots included.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.scan_utils import dynamic_slice, take_rows
from . import _build
from .min_d2 import min_d2_planar_ref

F_BIG = 1.0e9
U_ROW = 8    # points per row gather on the u side
V_ROW = 32   # and on the v side
MAX_TIERS = 8  # the kernel's tier table
MAX_RUN = 288  # the widest run a tier may cap (block-per-pair staging)
MAX_FRAMES = 65535  # frames of one launch (gridDim.y)
_I32 = torch.int32


def _stacked_windows(sp_xyz, starts, counts, fill: float, cap: int,
                     sr: int):
    """Gather contiguous runs as three planar (..., P, cap + sr) windows.

    sp_xyz (..., NO, 3); starts, counts (..., P). Rows of sr points (one
    row gather fetches all three coordinates) cover
    [starts, starts + min(counts, cap)); lanes outside hold `fill`.
    """
    no = sp_xyz.shape[-2]
    if cap % sr or no % sr:
        raise ValueError(f"window cap {cap} / buffer {no} not a multiple "
                         f"of {sr}")
    dev = sp_xyz.device
    lead = sp_xyz.shape[:-2]
    view = torch.cat([sp_xyz[..., a].reshape(*lead, no // sr, sr)
                      for a in range(3)], dim=-1)     # (..., no/sr, 3*sr)
    width = cap + sr
    nrow = width // sr
    sr0 = starts // sr
    ridx = torch.clamp(sr0[..., None]
                       + torch.arange(nrow, dtype=_I32, device=dev),
                       0, no // sr - 1)
    rows = take_rows(view, ridx)                      # (..., P, nrow, 3*sr)
    off = (starts - sr0 * sr)[..., None]
    aw = torch.arange(width, dtype=_I32, device=dev)
    ok = (aw >= off) & (aw < off + torch.clamp(counts, max=cap)[..., None])
    return tuple(
        torch.where(ok, rows[..., a * sr:(a + 1) * sr].reshape(
            *starts.shape, width), fill)
        for a in range(3))


def tier_slices(s_usuc, s_vsvc, starts, n_in_tier, tiers):
    """Per tier, the (us, uc, vs, vc) of its slots as the tier pass reads
    them: the dynamic slice at starts[..., t], unpacked, with (0, 0) on
    both sides of every slot at or past n_in_tier[..., t]."""
    out = []
    for t, (_, _, slots) in enumerate(tiers):
        active = (torch.arange(slots, dtype=_I32, device=s_usuc.device)
                  < n_in_tier[..., t:t + 1])
        usuc = dynamic_slice(s_usuc, starts[..., t], slots)
        vsvc = dynamic_slice(s_vsvc, starts[..., t], slots)
        out.append(tuple(torch.where(active, a, 0) for a in
                         (usuc >> 9, usuc & 511, vsvc >> 9, vsvc & 511)))
    return out


def tier_windows(sp_xyz, slices, tiers):
    """Per tier, its (u windows, v windows): +1e9 fills on u in 8-point
    rows, -1e9 fills on v in 32-point rows."""
    return [(_stacked_windows(sp_xyz, us, uc, F_BIG, u_cap, U_ROW),
             _stacked_windows(sp_xyz, vs, vc, -F_BIG, v_cap, V_ROW))
            for (us, uc, vs, vc), (u_cap, v_cap, _) in zip(slices, tiers)]


def tier_min_d2_ref(sp_xyz, s_usuc, s_vsvc, starts, n_in_tier, tiers
                    ) -> torch.Tensor:
    """Plain twin: min_d2_planar_ref over each tier's windows (every
    frame's slots as rows of one call), the tiers' results concatenated.
    A slot with no point on either side (every slot past n_in_tier) holds
    only fill lanes, so its d² is the fills' d², computed once; only the
    other rows go through min_d2_planar_ref (selecting them syncs)."""
    slices = tier_slices(s_usuc, s_vsvc, starts, n_in_tier, tiers)
    fills = (F_BIG,) * 3 + (-F_BIG,) * 3
    empty = min_d2_planar_ref(*(torch.full((1, 1), f, dtype=torch.float32,
                                           device=sp_xyz.device)
                                for f in fills))
    out = []
    for (_, uc, _, vc), (pu, pv) in zip(slices,
                                        tier_windows(sp_xyz, slices, tiers)):
        live = ((uc != 0) | (vc != 0)).flatten().nonzero()[:, 0]
        d2 = empty.expand(uc.numel()).clone()
        d2[live] = min_d2_planar_ref(*(w.reshape(-1, w.shape[-1])[live]
                                       for w in pu + pv))
        out.append(d2.reshape(uc.shape))
    return torch.cat(out, dim=-1)


def tier_min_d2(sp_xyz, s_usuc, s_vsvc, starts, n_in_tier, tiers
                ) -> torch.Tensor:
    """(B, sum of the tiers' slots) f32: each slot's min d², tier by tier.

    sp_xyz (B, NO, 3) f32 with NO a multiple of 32; s_usuc, s_vsvc (B, L)
    i32 packed descriptors; starts, n_in_tier (B, T) i32 on the same
    device, read there (never synced to the host); tiers: T (u_cap, v_cap,
    slots) triples with slots <= L. Without the leading B (one frame) the
    result has none either.
    """
    if not sp_xyz.is_cuda:
        return tier_min_d2_ref(sp_xyz, s_usuc, s_vsvc, starts, n_in_tier,
                               tiers)
    if sp_xyz.dim() == 2:
        return tier_min_d2(sp_xyz[None], s_usuc[None], s_vsvc[None],
                           starts[None], n_in_tier[None], tiers)[0]
    name = "tier_min_d2"
    dev = _build.checked(name, ("sp_xyz", sp_xyz, torch.float32, 3),
                         ("s_usuc", s_usuc, _I32, 2),
                         ("s_vsvc", s_vsvc, _I32, 2),
                         ("starts", starts, _I32, 2),
                         ("n_in_tier", n_in_tier, _I32, 2))
    frames, no = sp_xyz.shape[:2]
    length, n_t = s_usuc.shape[1], len(tiers)
    if sp_xyz.shape[2] != 3 or no == 0 or no % V_ROW:
        raise ValueError(f"{name}: sp_xyz must be (B, NO, 3) with NO a "
                         f"positive multiple of {V_ROW}")
    if not 0 < frames <= MAX_FRAMES:
        raise ValueError(f"{name}: 1-{MAX_FRAMES} frames a launch, got "
                         f"{frames}")
    if s_usuc.shape[0] != frames or s_vsvc.shape != s_usuc.shape \
            or starts.shape != (frames, n_t) \
            or n_in_tier.shape != (frames, n_t):
        raise ValueError(f"{name}: s_usuc/s_vsvc must be (B, L), starts "
                         f"and n_in_tier (B, {n_t}), with B = {frames}")
    flat = [int(v) for tier in tiers for v in tier]
    if not 0 < n_t <= MAX_TIERS or any(
            not 0 < s <= length or not 0 <= min(u, v) <= max(u, v) <= MAX_RUN
            for u, v, s in tiers):
        raise ValueError(f"{name}: tiers must be 1-{MAX_TIERS} (u_cap, "
                         f"v_cap, slots) with caps <= {MAX_RUN} and "
                         f"0 < slots <= {length}")
    out = torch.empty((frames, sum(s for *_, s in tiers)),
                      dtype=torch.float32, device=dev)
    table = (ctypes.c_int * len(flat))(*flat)
    _build.launch(tier_min_d2, "tier_min_d2_launch", dev, sp_xyz.data_ptr(),
                  no, s_usuc.data_ptr(), s_vsvc.data_ptr(), length,
                  starts.data_ptr(), n_in_tier.data_ptr(), out.data_ptr(),
                  ctypes.addressof(table), n_t, frames)
    return out


tier_min_d2.launches = 0
