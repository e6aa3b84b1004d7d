"""Probe: the pair kernel on a 128-lane planar layout, on the card.

Port of tools/probe_mosaic3.py: 8192 pairs of runs (u <= 8, v <= 96
points) of a 65536-point cloud stored as (n/128 + 16, 384) planar rows,
through csrc/probe_pairs.cu (``kernels.probe_pairs.mosaic3_pairs``; the
TPU's roll realignment has no counterpart), checked against numpy as the
JAX probe checks it and timed with CUDA events.

    python -m lidar_processing_tpu_torch.tools.probe_mosaic3
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.probe_pairs import mosaic3_pairs
from ._common import clock, resolve_device, time_ms
from .probe_mosaic import numpy_min_d2

LANES = 128


def make_inputs(n: int = 65536, n_pairs: int = 8192, seed: int = 0):
    """(xyz, planes, us, uc, vs, vc): the JAX probe's draws."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3)).astype(np.float32) * 10
    planes = np.concatenate(
        [xyz[:, a].reshape(-1, LANES) for a in range(3)], axis=1)
    planes = np.concatenate(
        [planes, np.zeros((16, 3 * LANES), np.float32)], axis=0)
    us = rng.integers(0, n - 256, n_pairs).astype(np.int32)
    uc = rng.integers(1, 9, n_pairs).astype(np.int32)
    vs = rng.integers(0, n - 256, n_pairs).astype(np.int32)
    vc = rng.integers(1, 97, n_pairs).astype(np.int32)
    return xyz, planes, us, uc, vs, vc


def main(device=None, n: int = 65536, n_pairs: int = 8192,
         reps: int = 30) -> dict:
    """Run, check (np.allclose rtol = atol = 1e-5; raises if not), time;
    returns {"correct", "ms", "got"}."""
    dev = resolve_device(device)
    xyz, planes, us, uc, vs, vc = make_inputs(n, n_pairs)
    args = [torch.from_numpy(a).to(dev) for a in (us, uc, vs, vc, planes)]
    got = mosaic3_pairs(*args).cpu().numpy()
    want = numpy_min_d2(xyz, us, uc, vs, vc)
    ok = bool(np.allclose(got, want, rtol=1e-5, atol=1e-5))
    print("correct:", ok, flush=True)
    if not ok:
        bad = np.nonzero(~np.isclose(got, want, rtol=1e-5, atol=1e-5))[0]
        raise AssertionError(f"{len(bad)} bad; first: {bad[:5]} "
                             f"{got[bad[:5]]} vs {want[bad[:5]]}")
    ms = time_ms(lambda: mosaic3_pairs(*args), dev, reps)
    print(f"C mini pair kernel x{n_pairs}: {ms * 1e3:.1f} us -> "
          f"{ms * 1e6 / n_pairs:.0f} ns/pair ({clock(dev)})", flush=True)
    return {"correct": ok, "ms": ms, "got": got}


if __name__ == "__main__":
    main()
