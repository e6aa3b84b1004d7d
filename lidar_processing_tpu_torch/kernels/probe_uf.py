"""Union-find variants of the TPU probes: CUDA kernels + their twin.

Port of the Pallas kernels of ``tools/probe_uf.py`` (``uf_probe``: serial
union by min with path halving, no equal-parent skip, no root cache) and
``tools/probe_uf2.py`` (``uf_serial``: v0, the TPU production kernel's
design with separate edge arrays, the skip and the root cache;
``uf_packed``: v1, edges packed as ``u << 15 | v``, with the skip and the
cache; ``uf_packed_noskip``: v2, the same without the skip). All compute
labels[i] = min node id reachable from i over the first n_edges edges,
which is canonical: on a CUDA tensor each wrapper launches its
instantiation of csrc/probe_uf.cu and counts the launch; on a CPU tensor it
runs the plain twin ``cc_labels_ref``, which every variant equals exactly.
"""

from __future__ import annotations

import torch

from .union_find import cc_labels_ref, launch_labels

_PACK_SHIFT = 15
_V_MASK = (1 << _PACK_SHIFT) - 1


def pack_edges(eu: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """One int32 word per edge, u << 15 | v (ids below 2^15 and 2^16)."""
    return ((eu.long() << _PACK_SHIFT) | ev.long()).to(torch.int32)


def unpack_edges(euv: torch.Tensor):
    return euv >> _PACK_SHIFT, euv & _V_MASK


def uf_probe(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf.py's kernel: labels (s_cap,) i32 from (ec,) int32
    eu/ev and a () int32 n_edges on the same device (read there)."""
    if not eu.is_cuda:
        return cc_labels_ref(eu, ev, n_edges, s_cap)
    return launch_labels(uf_probe, "uf_probe_launch",
                         (("eu", eu), ("ev", ev)), n_edges, s_cap)


def uf_serial(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf2.py's v0: the serial union pass with the skip and
    the root cache, on (ec,) int32 eu/ev."""
    if not eu.is_cuda:
        return cc_labels_ref(eu, ev, n_edges, s_cap)
    return launch_labels(uf_serial, "uf_serial_launch",
                         (("eu", eu), ("ev", ev)), n_edges, s_cap)


def uf_packed(euv, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf2.py's v1: packed (ec,) int32 edges (pack_edges)."""
    if not euv.is_cuda:
        return cc_labels_ref(*unpack_edges(euv), n_edges, s_cap)
    return launch_labels(uf_packed, "uf_packed_launch", (("euv", euv),),
                         n_edges, s_cap)


def uf_packed_noskip(euv, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf2.py's v2: v1 without the equal-parent skip."""
    if not euv.is_cuda:
        return cc_labels_ref(*unpack_edges(euv), n_edges, s_cap)
    return launch_labels(uf_packed_noskip, "uf_packed_noskip_launch",
                         (("euv", euv),), n_edges, s_cap)


uf_probe.launches = 0
uf_serial.launches = 0
uf_packed.launches = 0
uf_packed_noskip.launches = 0
