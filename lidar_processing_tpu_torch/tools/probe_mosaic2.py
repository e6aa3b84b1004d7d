"""Probe: gathered loads, dynamic 2-row slices and tile stores, on the card.

Port of tools/probe_mosaic2.py's three probes as parallel kernels
(csrc/probe_mosaic2.cu through ``kernels.probe_mosaic2``):

  A  sum of val[idx[i]] over 16384 gathered int32 loads (exact)
  B  sum of 16384 dynamic 2x384 row slices of a (640, 384) f32 array
  C  2 * x over 16384 floats stored as (128, 128) tiles (exact)

each on the JAX probe's seeded inputs, checked against numpy and timed
with CUDA events; A0 and C0 are A and C as the first port built them
(``gather_sum_v0``, ``tile_scale_v0``), timed beside them.

    python -m lidar_processing_tpu_torch.tools.probe_mosaic2
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.probe_mosaic2 import (gather_sum, gather_sum_v0, slice_sum,
                                     tile_scale, tile_scale_v0)
from ._common import clock, resolve_device, time_ms

ROWS = 640
WIDTH = 384


def scalar_loads_inputs(n_loads: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 8192, n_loads).astype(np.int32)
    val = rng.integers(0, 100, 8192).astype(np.int32)
    return idx, val


def dyn_slice_inputs(n_iters: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    off = rng.integers(0, ROWS - 2, n_iters).astype(np.int32)
    planes = rng.standard_normal((ROWS, WIDTH)).astype(np.float32)
    return off, planes


def accum_store_inputs(n_pairs: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n_pairs).astype(np.float32)


def slice_terms(off, planes) -> np.ndarray:
    """Every term B sums, (n, 2, W), in float64."""
    return planes[off[:, None] + np.arange(2)].astype(np.float64)


def main(device=None, n: int = 16384, reps: int = 30) -> dict:
    """Run A, A0, B, C, C0; check (A and C exact, B within 1e-5 of the sum
    of |terms|; raises if not); time; returns {name: (result, ms)}."""
    dev = resolve_device(device)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    idx, val = scalar_loads_inputs(n)
    off, planes = dyn_slice_inputs(n)
    x = accum_store_inputs(n)
    terms = slice_terms(off, planes)
    sum_ok = lambda r: int(r[0, 0]) == int(  # noqa: E731
        val[idx].astype(np.int64).sum())
    scale_ok = lambda r: np.array_equal(r.reshape(-1), x * 2.0)  # noqa
    cases = (
        ("A scalar loads", gather_sum, (to(idx), to(val)), sum_ok),
        ("A0 scalar loads, first port", gather_sum_v0, (to(idx), to(val)),
         sum_ok),
        ("B dyn 2x384 slices", slice_sum, (to(off), to(planes)),
         lambda r: abs(float(r[0, 0]) - terms.sum())
         <= 1e-5 * np.abs(terms).sum()),
        ("C accum+store", tile_scale, (to(x),), scale_ok),
        ("C0 accum+store, first port", tile_scale_v0, (to(x),), scale_ok),
    )
    out = {}
    for name, fn, args, check in cases:
        res = fn(*args).cpu().numpy()
        if not check(res):
            raise AssertionError(f"{name}: wrong result")
        ms = time_ms(lambda: fn(*args), dev, reps)
        print(f"{name} x{n} (ok=True): {ms * 1e3:9.1f} us -> "
              f"{ms * 1e6 / n:.2f} ns/item ({clock(dev)})", flush=True)
        out[name.split()[0]] = (res, ms)
    return out


if __name__ == "__main__":
    main()
