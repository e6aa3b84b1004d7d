"""Probe: union-find variants on a frame's edge list, on the card.

Port of tools/probe_uf2.py:

  v0  the TPU production kernel's serial design
      (kernels/probe_uf.py::uf_serial: separate eu/ev arrays, u-root
      cache, equal-parent skip)
  v1  packed single-array edges (u << 15 | v): half the edge loads
  v2  v1 without the equal-parent skip

``main(edges=(e_u, e_v, n_edges))`` takes a real edge list, such as
``ops.stixel.cluster_debug``'s on a full-size frame (chip_smoke.py feeds
synthetic frame 0's); without one it uses the JAX probe's synthetic
fallback (24000 edges sorted by u over 10240 nodes). Every variant must
give the same labels; each is timed with CUDA events.

    python -m lidar_processing_tpu_torch.tools.probe_uf2
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.probe_uf import (pack_edges, uf_packed, uf_packed_noskip,
                                uf_serial)
from ._common import clock, resolve_device, time_ms

S = 10240
E = 32768
NE = 24000


def make_inputs(s: int = S, e: int = E, ne: int = NE, seed: int = 0):
    """(eu, ev, ne): the JAX probe's synthetic fallback draws."""
    rng = np.random.default_rng(seed)
    eu = np.sort(rng.integers(0, s, e)).astype(np.int32)
    ev = rng.integers(0, s, e).astype(np.int32)
    return eu, ev, ne


def main(device=None, edges=None, s: int = S, reps: int = 50) -> dict:
    """Run v0-v2 on `edges` (or the synthetic fallback), require equal
    labels (raises otherwise), time each; returns {"edges", "labels",
    "ms": {variant: ms}}."""
    dev = resolve_device(device)
    eu, ev, ne = edges if edges is not None else make_inputs(s)
    # fresh copies: the kernels bulk-copy the edges from a 16-byte aligned
    # start, which a slice of a longer edge list need not have
    eu, ev = (torch.as_tensor(e, dtype=torch.int32, device=dev).clone(
        memory_format=torch.contiguous_format) for e in (eu, ev))
    ne = torch.as_tensor(ne, dtype=torch.int32, device=dev).reshape(())
    print(f"edges={int(ne)}", flush=True)
    euv = pack_edges(eu, ev)
    variants = (("v0 serial", lambda: uf_serial(eu, ev, ne, s)),
                ("v1 packed", lambda: uf_packed(euv, ne, s)),
                ("v2 packed, no precheck", lambda: uf_packed_noskip(euv, ne,
                                                                     s)))
    labels = [fn().cpu().numpy() for _, fn in variants]
    if not all(np.array_equal(labels[0], r) for r in labels[1:]):
        raise AssertionError("union-find variants disagree")
    times = {}
    for name, fn in variants:
        ms = time_ms(fn, dev, reps)
        times[name.split()[0]] = ms
        print(f"{name:24s} {ms:7.3f} ms  ({ms * 1e6 / max(int(ne), 1):5.1f}"
              f" ns/edge, {clock(dev)})", flush=True)
    return {"edges": int(ne), "labels": labels[0], "ms": times}


if __name__ == "__main__":
    main()
