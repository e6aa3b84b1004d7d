"""Connected components over compacted edge lists: CUDA kernel + twin.

Port of ``lidar_processing_tpu/kernels/union_find.py``. Contract:
labels[i] = min node id reachable from i over the first n_edges edges.
The edge arrays may carry a leading frame axis B (the batched step's
frames): each frame's labels come from its own edges and n_edges, exactly
as a call for that frame alone. On a CUDA tensor ``cc_labels`` launches
the parallel shared-memory hook-and-compress kernel (csrc/union_find.cu,
ECL-CC style), ONE launch of B blocks for B frames; on a CPU tensor it
runs the plain PyTorch twin ``cc_labels_ref``. The labelling is canonical,
so both give the same array exactly. The TPU kernel's serial design lives
on as the probe ``kernels/probe_uf.py::uf_serial``. ``cc_labels_hybrid``
(two vectorised hook rounds, then the kernel on the live edges) is the
JAX package's hybrid; the main path calls ``cc_labels``, as JAX does.
"""

from __future__ import annotations

import torch

from ..ops.scan_utils import scatter_drop, take
from . import _build

_IMAX = 2 ** 31 - 1
# dynamic shared memory a Hopper block may opt into (227 KB)
_SMEM_MAX = 232448


def cc_labels_ref(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """Plain twin: min-label hooking + pointer jumping to a fixpoint.

    The formulation of the JAX package's ``cc_labels_xla`` with
    ``scatter_reduce("amin")`` into a dump slot per frame in place of a
    dropping scatter. Unlike that twin (which stops after 32 outer rounds)
    it runs until nothing changes in any frame and raises if it has not
    converged, rather than returning partial labels. eu, ev (B, ec) with
    n_edges (B,), or (ec,) with n_edges ().
    """
    if eu.dim() == 1:
        return cc_labels_ref(eu[None], ev[None], n_edges.reshape(1),
                             s_cap)[0]
    dev = eu.device
    frames, ec = eu.shape
    ok = (torch.arange(ec, dtype=torch.int32, device=dev)
          < n_edges.reshape(frames, 1))
    uv = torch.cat([eu, ev], 1).clamp(0, s_cap - 1).long()
    ok2 = torch.cat([ok, ok], 1)
    labels = torch.arange(s_cap, dtype=torch.int32,
                          device=dev).expand(frames, s_cap)

    def hook(lab):
        luv = lab.gather(1, uv)
        mn = torch.minimum(luv[:, :ec], luv[:, ec:])
        mn2 = torch.where(ok2, torch.cat([mn, mn], 1), _IMAX)
        tgt = torch.where(ok2, luv, s_cap).long()
        buf = torch.cat([lab, lab.new_full((frames, 1), _IMAX)], 1)
        lab = buf.scatter_reduce(1, tgt, mn2, "amin")[:, :s_cap]
        for _ in range(4):
            lab = lab.gather(1, lab.long())
        return lab

    labels = hook(labels)
    # every round that changes anything lowers some label, so s_cap + 1
    # rounds bound the loop; real graphs settle in a handful
    for _ in range(s_cap + 1):
        nxt = hook(hook(labels))
        if torch.equal(nxt, labels):
            return labels.gather(1, labels.long())
        labels = nxt
    raise RuntimeError("cc_labels_ref: hooking did not converge")


def launch_labels(fn, entry: str, edges, n_edges, s_cap: int,
                  batched: bool = False) -> torch.Tensor:
    """Check and launch a union-find C entry point taking the edge arrays
    `edges` ((name, int32 tensor) pairs), n_edges (read on the device,
    never synced to the host), the labels, then (ec, s_cap): each edge
    array (ec,) with n_edges (), labels (s_cap,); or, with `batched`,
    (B, ec) with n_edges (B,), labels (B, s_cap), the entry point taking B
    before ec (one launch for the B graphs)."""
    name, dev = fn.__name__, edges[0][1].device
    for what, t in (*edges, ("n_edges", n_edges)):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name}: {what} must be int32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    shape = edges[0][1].shape
    lead = tuple(shape[:1]) if batched else ()
    if len(shape) != len(lead) + 1 or any(t.shape != shape for _, t in edges) \
            or n_edges.shape != lead:
        raise ValueError(f"{name}: edge arrays must be "
                         f"{'(B, ec)' if batched else '(ec,)'}, n_edges "
                         f"{'(B,)' if batched else '()'}")
    if not 0 < s_cap * 4 <= _SMEM_MAX:
        raise ValueError(f"{name}: s_cap={s_cap} labels do not fit a "
                         f"block's shared memory ({_SMEM_MAX} B)")
    out = torch.empty((*lead, s_cap), dtype=torch.int32, device=dev)
    _build.launch(fn, entry, dev, *(t.data_ptr() for _, t in edges),
                  n_edges.data_ptr(), out.data_ptr(), *lead, shape[-1],
                  s_cap)
    return out


def cc_labels(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """labels (B, s_cap) i32: min node id per component, per frame.

    eu, ev: (B, ec) int32 edge endpoints; n_edges: (B,) int32 on the same
    device; without the leading B (one frame: (ec,) and ()) the result has
    none either. A CUDA input launches csrc/union_find.cu once for the B
    frames and counts the launch in ``cc_labels.launches``; a CPU input
    runs the twin.
    """
    if not eu.is_cuda:
        return cc_labels_ref(eu, ev, n_edges, s_cap)
    if eu.dim() == 1:
        return cc_labels(eu[None], ev[None], n_edges.reshape(-1), s_cap)[0]
    return launch_labels(cc_labels, "union_find_launch",
                         (("eu", eu), ("ev", ev)), n_edges, s_cap,
                         batched=True)


cc_labels.launches = 0


def cc_labels_hybrid(eu, ev, n_edges, s_cap: int,
                     serial=None) -> torch.Tensor:
    """Vectorised min-label hook rounds, then `serial` on the LIVE edges.

    Port of the JAX package's ``cc_labels_hybrid`` (same contract as
    ``cc_labels``: min node id per component), batched like it: two hook
    + double-jump rounds resolve the bulk of the edges; the label pairs
    still straddling two labels are packed into one key, deduped by two
    single-operand sorts (a stable 3-operand sort that moves them to the
    front when s_cap > 2^15), and go to ``serial(le_u, le_v, n_live,
    s_cap)``, by default ``cc_labels``: on a CUDA tensor ONE launch of the
    union_find kernel for the B frames, on a CPU tensor the twin. eu, ev
    (B, ec) with n_edges (B,), or one frame without the B, which calls
    `serial` without the B too.
    """
    serial = serial or cc_labels
    if eu.dim() == 1:
        def one(u, v, n, s):
            return serial(u[0], v[0], n[0], s)[None]
        return cc_labels_hybrid(eu[None], ev[None], n_edges.reshape(1),
                                s_cap, one)[0]
    dev = eu.device
    frames, ec = eu.shape
    pos = torch.arange(ec, dtype=torch.int32, device=dev)
    ok = pos < n_edges.reshape(frames, 1)
    lab = torch.arange(s_cap, dtype=torch.int32,
                       device=dev).expand(frames, s_cap)
    for _ in range(2):
        lu, lv = take(lab, eu), take(lab, ev)
        mn = torch.where(ok, torch.minimum(lu, lv), _IMAX)
        # lab.at[idx].min(mn, mode="drop"): idx s_cap is dropped
        for side in (lu, lv):
            lab = torch.minimum(lab, scatter_drop(
                s_cap, torch.where(ok, side, s_cap), mn, _IMAX, "amin"))
        lab = take(lab, lab)
        lab = take(lab, lab)
    lu, lv = take(lab, eu), take(lab, ev)
    live = ok & (lu != lv)
    if s_cap <= (1 << 15):
        key = torch.where(live, torch.minimum(lu, lv) * (1 << 15)
                          + torch.maximum(lu, lv), 1 << 30)
        sk = torch.sort(key, dim=1).values
        # contraction maps many edges onto one label pair: dedup
        prev = torch.cat([sk.new_full((frames, 1), -1), sk[:, :-1]], 1)
        uniq = (sk != prev) & (sk < (1 << 30))
        n_live = uniq.sum(1, dtype=torch.int32)
        sk = torch.sort(torch.where(uniq, sk, 1 << 30), dim=1).values
        fresh = pos < n_live[:, None]
        le_u = torch.where(fresh, sk >> 15, 0)
        le_v = torch.where(fresh, sk & ((1 << 15) - 1), 0)
    else:
        n_live = live.sum(1, dtype=torch.int32)
        # a stable sort on ~live moves the live pairs to the front
        order = torch.sort((~live).to(torch.int32), dim=1,
                           stable=True).indices
        le_u = torch.where(live, lu, 0).gather(1, order)
        le_v = torch.where(live, lv, 0).gather(1, order)
    return take(serial(le_u, le_v, n_live, s_cap), lab)
