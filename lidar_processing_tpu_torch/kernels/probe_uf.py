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

The wrappers launch the staged design: edges bulk-copied into shared
memory, the union pass in one warp. Their edge arrays must start on a
16-byte boundary (a bulk copy's source; the wrapper raises otherwise),
and the labels and the ring of edge chunks share a block's shared memory:
s_cap at most 41616 with separate edge arrays, 49808 with packed ones
(the launch raises past it). ``schedule_model`` and ``serial_model`` are
plain-Python models of the staged union pass and of the serial one it
computes, for the tests and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .union_find import cc_labels_ref, launch_labels

_PACK_SHIFT = 15
_V_MASK = (1 << _PACK_SHIFT) - 1
WINDOW = 32  # edges the warp screens at once: csrc/probe_uf.cu's kWindow
# (equal-parent skip, root cache) of each variant
VARIANTS = {"uf_probe": (False, False), "uf_serial": (True, True),
            "uf_packed": (True, True), "uf_packed_noskip": (False, True)}


def pack_edges(eu: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """One int32 word per edge, u << 15 | v (ids below 2^15 and 2^16)."""
    return ((eu.long() << _PACK_SHIFT) | ev.long()).to(torch.int32)


def unpack_edges(euv: torch.Tensor):
    return euv >> _PACK_SHIFT, euv & _V_MASK


def _staged(fn, entry, edges, n_edges, s_cap):
    """Raise ValueError unless every edge array starts on a 16-byte
    boundary (a bulk copy's source), then launch."""
    for what, t in edges:
        if t.data_ptr() % 16:
            raise ValueError(f"{fn.__name__}: {what} must start on a "
                             f"16-byte boundary for the bulk copies, got "
                             f"data_ptr() % 16 == {t.data_ptr() % 16}")
    return launch_labels(fn, entry, edges, n_edges, s_cap)


def uf_probe(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf.py's kernel: labels (s_cap,) i32 from (ec,) int32
    eu/ev and a () int32 n_edges on the same device (read there)."""
    if not eu.is_cuda:
        return cc_labels_ref(eu, ev, n_edges, s_cap)
    return _staged(uf_probe, "uf_probe_launch", (("eu", eu), ("ev", ev)),
                   n_edges, s_cap)


def uf_serial(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf2.py's v0: the serial union pass with the skip and
    the root cache, on (ec,) int32 eu/ev."""
    if not eu.is_cuda:
        return cc_labels_ref(eu, ev, n_edges, s_cap)
    return _staged(uf_serial, "uf_serial_launch", (("eu", eu), ("ev", ev)),
                   n_edges, s_cap)


def uf_packed(euv, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf2.py's v1: packed (ec,) int32 edges (pack_edges)."""
    if not euv.is_cuda:
        return cc_labels_ref(*unpack_edges(euv), n_edges, s_cap)
    return _staged(uf_packed, "uf_packed_launch", (("euv", euv),), n_edges,
                   s_cap)


def uf_packed_noskip(euv, n_edges, s_cap: int) -> torch.Tensor:
    """tools/probe_uf2.py's v2: v1 without the equal-parent skip."""
    if not euv.is_cuda:
        return cc_labels_ref(*unpack_edges(euv), n_edges, s_cap)
    return _staged(uf_packed_noskip, "uf_packed_noskip_launch",
                   (("euv", euv),), n_edges, s_cap)


for _fn in (uf_probe, uf_serial, uf_packed, uf_packed_noskip):
    _fn.launches = 0
del _fn


# ---- plain-Python models of the union passes ----------------------------

def _live_edges(eu, ev, n_edges, s_cap: int):
    """The first n_edges (clamped into [0, ec]) edges as lists of ids
    clamped into [0, s_cap), as the kernels read them."""
    eu, ev = np.asarray(eu), np.asarray(ev)
    ne = min(max(int(n_edges), 0), len(eu))
    return (np.clip(eu[:ne], 0, s_cap - 1).tolist(),
            np.clip(ev[:ne], 0, s_cap - 1).tolist())


def _roots(lab) -> np.ndarray:
    """The flatten: every node's root, read-only."""
    out = np.empty(len(lab), np.int32)
    for i in range(len(lab)):
        x = i
        while lab[x] != x:
            x = lab[x]
        out[i] = x
    return out


def _find2(lab, x, px, y, py):
    """csrc/probe_uf.cu's find2, step for step."""
    while px != x or py != y:
        mx, my = px != x, py != y
        gx = lab[px] if mx else x
        gy = lab[py] if my else y
        if mx:
            lab[x] = gx
            x = gx
        if my:
            lab[y] = gy
            y = gy
        if mx:
            px = lab[x]
        if my:
            py = lab[y]
    return x, y


def schedule_model(eu, ev, n_edges, s_cap: int, skip: bool, cache: bool):
    """The staged kernel's union pass (probe_uf_kernel): windows of
    WINDOW edges; with `skip`, the window's edges with equal parents at
    its start are screened out and lane 0 takes the rest in order with
    the skip test, the root cache and find2 on current labels; without,
    lane 0 takes every edge, its finds starting from the parents read at
    the window's start (or the cached node). eu, ev unpacked. Returns
    (labels (s_cap,) int32, the screened edges' indices)."""
    us, vs = _live_edges(eu, ev, n_edges, s_cap)
    lab = list(range(s_cap))
    pu, pru = -1, 0
    screened = []
    for w in range(0, len(us), WINDOW):
        win = range(w, min(w + WINDOW, len(us)))
        if skip:
            todo = [j for j in win if lab[us[j]] != lab[vs[j]]]
            screened += [j for j in win if lab[us[j]] == lab[vs[j]]]
        else:
            todo = list(win)
            pre = {j: (lab[us[j]], lab[vs[j]]) for j in win}
        for j in todo:
            a, b = us[j], vs[j]
            if skip:
                x = pru if cache and a == pu else a
                pa, pb = lab[a], lab[b]
                if pa == pb:
                    r = pa
                else:
                    ru, rv = _find2(lab, x, lab[x], b, pb)
                    r = min(ru, rv)
                    if ru != rv:
                        lab[max(ru, rv)] = r
            else:
                x = pru if cache and a == pu else pre[j][0]
                y = pre[j][1]
                ru, rv = _find2(lab, x, lab[x], y, lab[y])
                r = min(ru, rv)
                if ru != rv:
                    lab[max(ru, rv)] = r
            pu, pru = a, r
    return _roots(lab), screened


def serial_model(eu, ev, n_edges, s_cap: int, skip: bool, cache: bool):
    """The serial union pass the TPU probes run: every edge in order on
    one thread. Returns (labels, outcomes): per edge "skip"
    (equal parents), "joined" (the finds met one root) or "hooked"."""
    us, vs = _live_edges(eu, ev, n_edges, s_cap)
    lab = list(range(s_cap))

    def find(x):
        while lab[x] != x:
            lab[x] = lab[lab[x]]
            x = lab[x]
        return x

    pu, pru = -1, 0
    outcomes = []
    for a, b in zip(us, vs):
        if skip and lab[a] == lab[b]:
            r = lab[a]
            outcomes.append("skip")
        else:
            ru = find(pru if cache and a == pu else a)
            rv = find(b)
            r = min(ru, rv)
            if ru != rv:
                lab[max(ru, rv)] = r
            outcomes.append("hooked" if ru != rv else "joined")
        pu, pru = a, r
    return _roots(lab), outcomes
