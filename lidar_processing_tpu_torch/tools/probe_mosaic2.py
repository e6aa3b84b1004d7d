"""Probe: gathered loads, dynamic 2-row slices and tile stores, on the card.

Port of tools/probe_mosaic2.py's three probes as parallel kernels
(csrc/probe_mosaic2.cu through ``kernels.probe_mosaic2``):

  A  sum of val[idx[i]] over 16384 gathered int32 loads (exact)
  B  sum of 16384 dynamic 2x384 row slices of a (640, 384) f32 array
  C  2 * x over 16384 floats stored as (128, 128) tiles (exact)

each on the JAX probe's seeded inputs, checked against numpy and timed
with CUDA events. ``slice_sum_order_model`` computes B's f32 sum in the
kernel's own order (the card tests and chip_smoke.py hold the kernel to
it bit for bit).

    python -m lidar_processing_tpu_torch.tools.probe_mosaic2
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.probe_mosaic2 import (SLICE_CHUNKS, SLICE_TERMS, SLICE_WARPS,
                                     gather_sum, slice_sum, tile_scale)
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


def _shuffle_tree(v: np.ndarray) -> np.ndarray:
    """Lane 0 of __shfl_down_sync adds at offsets 16, 8, 4, 2, 1 over the
    last axis (32 lanes), in float32."""
    v = v.copy()
    for step in (16, 8, 4, 2, 1):
        v[..., :step] = v[..., :step] + v[..., step:2 * step]
    return v[..., 0]


def _block_sums(lanes: np.ndarray, warps_per_block: int) -> np.ndarray:
    """(blocks * warps, 32) lane values -> (blocks,) block sums: a shuffle
    tree a warp, then the block's warps in warp order."""
    w = _shuffle_tree(lanes).reshape(-1, warps_per_block)
    b = w[:, 0].copy()
    for i in range(1, warps_per_block):
        b = b + w[:, i]
    return b


def slice_sum_order_model(off, planes, grid: int,
                          warps_per_block: int = SLICE_WARPS,
                          terms_in_flight: int = SLICE_TERMS,
                          chunks: int = SLICE_CHUNKS) -> np.float32:
    """slice_sum's f32 result as csrc/probe_mosaic2.cu computes it on a
    grid of `grid` blocks: every float32 add of the kernel in its order
    (the .cu file's head), vectorised over warps and lanes. A warp g of
    nw = grid * warps_per_block takes terms g, g + nw, ...; groups of
    `terms_in_flight` of them add, chunk group by chunk group, each term's
    items in chunk order into 4 accumulators (float4 components where
    W % 4 == 0, else chunk % 4), 0.0 for an item or a term past the end;
    then lanes by a shuffle tree, warps in order, and the last block adds
    the block sums, thread t blocks t, t + threads, ..., then a shuffle
    tree and warps in order again."""
    off = np.asarray(off, np.int32)
    planes = np.ascontiguousarray(planes, np.float32)
    rows, width = planes.shape
    n = off.shape[0]
    vec = width % 4 == 0
    span = width // 2 if vec else 2 * width          # items of a term
    nw = grid * warps_per_block
    g = np.arange(nw)
    lane = np.arange(32)
    flat = planes.reshape(-1)
    start = np.clip(off, 0, rows - 2).astype(np.int64) * width
    s = np.zeros((nw, 32, 4), np.float32)
    n_terms = -(-n // nw)                            # warp 0's
    for m0 in range(0, n_terms, terms_in_flight):
        active = g + m0 * nw < n                     # the group runs
        for c0 in range(0, -(-span // 32), chunks):
            for j in range(terms_in_flight):
                term = g + (m0 + j) * nw
                live = term < n
                base = start[np.where(live, term, 0)]
                for k in range(chunks):
                    q = (c0 + k) * 32 + lane
                    ok = live[:, None] & (q < span)[None, :]
                    if vec:
                        at = base[:, None, None] + 4 * q[None, :, None] \
                            + np.arange(4)
                        v = np.where(ok[..., None],
                                     flat[np.where(ok[..., None], at, 0)], 0)
                        np.add(s, v.astype(np.float32), out=s,
                               where=active[:, None, None])
                    else:
                        at = base[:, None] + q[None, :]
                        v = np.where(ok, flat[np.where(ok, at, 0)], 0)
                        acc = s[..., (c0 + k) % 4]
                        np.add(acc, v.astype(np.float32), out=acc,
                               where=active[:, None])
    lanes = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
    partial = _block_sums(lanes, warps_per_block)
    threads = 32 * warps_per_block
    p = np.zeros(threads, np.float32)
    for b0 in range(0, grid, threads):
        chunk = partial[b0:b0 + threads]
        p[:chunk.shape[0]] = p[:chunk.shape[0]] + chunk
    return np.float32(_block_sums(p.reshape(-1, 32), warps_per_block)[0])


def main(device=None, n: int = 16384, reps: int = 30) -> dict:
    """Run A, B, C; check (A and C exact, B within 1e-5 of the sum of
    |terms|; raises if not); time; returns {name: (result, ms)}."""
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
        ("B dyn 2x384 slices", slice_sum, (to(off), to(planes)),
         lambda r: abs(float(r[0, 0]) - terms.sum())
         <= 1e-5 * np.abs(terms).sum()),
        ("C accum+store", tile_scale, (to(x),), scale_ok),
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
