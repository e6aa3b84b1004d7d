"""Probe: serial union-find (no skip, no root cache) on the card.

Port of tools/probe_uf.py: the same seeded graph (S=10240 nodes, E=32768
edge slots, 24000 live edges, local-ish like the supernode graph), the
kernel csrc/probe_uf.cu through ``kernels.probe_uf.uf_probe``, checked
against scipy's connected components and timed with CUDA events.

    python -m lidar_processing_tpu_torch.tools.probe_uf
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.probe_uf import uf_probe
from ._common import clock, resolve_device, time_ms

S = 10240
E = 32768
NE = 24000


def make_inputs(s: int = S, e: int = E, ne: int = NE, seed: int = 0):
    """(eu, ev, ne): the JAX probe's draws from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    eu = rng.integers(0, s, e).astype(np.int32)
    ev = rng.integers(0, s, e).astype(np.int32)
    ev[:ne] = np.minimum(s - 1, eu[:ne] + rng.integers(1, 40, ne))
    return eu, ev, ne


def scipy_labels(eu, ev, ne: int, s: int) -> np.ndarray:
    """Min node id per component over the first ne edges (scipy)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as cs
    g = sp.coo_matrix((np.ones(ne, np.int8), (eu[:ne], ev[:ne])),
                      shape=(s, s))
    _, comp = cs.connected_components(g, directed=False)
    mins = np.full(comp.max() + 1, 2 ** 31 - 1, np.int64)
    np.minimum.at(mins, comp, np.arange(s))
    return mins[comp]


def main(device=None, s: int = S, e: int = E, ne: int = NE,
         reps: int = 30) -> dict:
    """Run, check against scipy (raises if wrong), time; returns
    {"correct", "ms", "labels"}."""
    dev = resolve_device(device)
    eu, ev, ne = make_inputs(s, e, ne)
    args = (torch.from_numpy(eu).to(dev), torch.from_numpy(ev).to(dev),
            torch.tensor(ne, dtype=torch.int32, device=dev))
    got = uf_probe(*args, s).cpu().numpy()
    ok = bool(np.array_equal(got, scipy_labels(eu, ev, ne, s)))
    print("correct:", ok, flush=True)
    if not ok:
        raise AssertionError("uf_probe labels differ from scipy's")
    ms = time_ms(lambda: uf_probe(*args, s), dev, reps)
    print(f"UF kernel S={s} E={ne}: {ms * 1e3:.1f} us ({clock(dev)})",
          flush=True)
    return {"correct": ok, "ms": ms, "labels": got}


if __name__ == "__main__":
    main()
