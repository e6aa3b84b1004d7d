"""Probe: the mini pair-verdict kernel (runs read in place), on the card.

Port of tools/probe_mosaic.py: 512 pairs of runs (u <= 8, v <= 48 points)
of a 4096-point cloud given as the (n/8, 24) stacked view, through
csrc/probe_pairs.cu (``kernels.probe_pairs.mosaic_pairs``), checked
against numpy as the JAX probe checks it and timed with CUDA events.

    python -m lidar_processing_tpu_torch.tools.probe_mosaic
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.probe_pairs import mosaic_pairs
from ._common import clock, resolve_device, time_ms


def make_inputs(n: int = 4096, n_pairs: int = 512, seed: int = 0):
    """(xyz, stacked, us, uc, vs, vc): the JAX probe's draws."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    stacked = np.concatenate([xyz[:, a].reshape(-1, 8) for a in range(3)],
                             axis=1)                      # (n//8, 24)
    us = rng.integers(0, n - 64, n_pairs).astype(np.int32)
    uc = rng.integers(1, 9, n_pairs).astype(np.int32)
    vs = rng.integers(0, n - 128, n_pairs).astype(np.int32)
    vc = rng.integers(1, 49, n_pairs).astype(np.int32)
    return xyz, stacked, us, uc, vs, vc


def numpy_min_d2(xyz, us, uc, vs, vc) -> np.ndarray:
    """The JAX probes' numpy check: min d² between the two runs."""
    want = np.empty(len(us), np.float32)
    for i in range(len(us)):
        u = xyz[us[i]:us[i] + uc[i]]
        v = xyz[vs[i]:vs[i] + vc[i]]
        d = u[:, None, :] - v[None, :, :]
        want[i] = (d * d).sum(-1).min()
    return want


def main(device=None, n: int = 4096, n_pairs: int = 512,
         reps: int = 50) -> dict:
    """Run, check (np.allclose rtol 1e-5; raises if not), time; returns
    {"correct", "ms", "got"}."""
    dev = resolve_device(device)
    xyz, stacked, us, uc, vs, vc = make_inputs(n, n_pairs)
    args = [torch.from_numpy(a).to(dev) for a in (stacked, us, uc, vs, vc)]
    got = mosaic_pairs(*args).cpu().numpy()
    want = numpy_min_d2(xyz, us, uc, vs, vc)
    ok = bool(np.allclose(got, want, rtol=1e-5))
    print("correct:", ok, flush=True)
    if not ok:
        bad = np.nonzero(~np.isclose(got, want, rtol=1e-5))[0][:5]
        raise AssertionError(f"mismatch at {bad}: {got[bad]} vs {want[bad]}")
    ms = time_ms(lambda: mosaic_pairs(*args), dev, reps)
    print(f"{n_pairs} pairs: {ms * 1e3:.1f} us -> "
          f"{ms * 1e6 / n_pairs:.0f} ns/pair ({clock(dev)})", flush=True)
    return {"correct": ok, "ms": ms, "got": got}


if __name__ == "__main__":
    main()
