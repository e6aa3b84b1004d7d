"""Connected components over a compacted edge list: CUDA kernel + twin.

Port of ``lidar_processing_tpu/kernels/union_find.py``. Contract:
labels[i] = min node id reachable from i over the first n_edges edges.
On a CUDA tensor ``cc_labels`` launches the serial shared-memory
union-find (csrc/union_find.cu); on a CPU tensor it runs the plain
PyTorch twin ``cc_labels_ref``. The labelling is canonical, so both give
the same array exactly.
"""

from __future__ import annotations

import torch

from . import _build

_IMAX = 2 ** 31 - 1
# dynamic shared memory a Hopper block may opt into (227 KB)
_SMEM_MAX = 232448


def cc_labels_ref(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """Plain twin: min-label hooking + pointer jumping to a fixpoint.

    The formulation of the JAX package's ``cc_labels_xla`` with
    ``scatter_reduce("amin")`` into a dump slot in place of a dropping
    scatter. Unlike that twin (which stops after 32 outer rounds) it runs
    until nothing changes and raises if it has not converged, rather than
    returning partial labels.
    """
    dev = eu.device
    ec = eu.shape[0]
    ok = torch.arange(ec, dtype=torch.int32, device=dev) < n_edges
    uv = torch.cat([eu, ev]).clamp(0, s_cap - 1).long()
    ok2 = torch.cat([ok, ok])
    labels = torch.arange(s_cap, dtype=torch.int32, device=dev)

    def hook(lab):
        luv = lab[uv]
        mn = torch.minimum(luv[:ec], luv[ec:])
        mn2 = torch.where(ok2, torch.cat([mn, mn]), _IMAX)
        tgt = torch.where(ok2, luv, s_cap).long()
        buf = torch.cat([lab, lab.new_full((1,), _IMAX)])
        lab = buf.scatter_reduce(0, tgt, mn2, "amin")[:s_cap]
        for _ in range(4):
            lab = lab[lab.long()]
        return lab

    labels = hook(labels)
    # every round that changes anything lowers some label, so s_cap + 1
    # rounds bound the loop; real graphs settle in a handful
    for _ in range(s_cap + 1):
        nxt = hook(hook(labels))
        if torch.equal(nxt, labels):
            return labels[labels.long()]
        labels = nxt
    raise RuntimeError("cc_labels_ref: hooking did not converge")


def cc_labels(eu, ev, n_edges, s_cap: int) -> torch.Tensor:
    """labels (s_cap,) i32: min node id per component.

    eu, ev: (ec,) int32 edge endpoints; n_edges: () int32 tensor on the
    same device (read on the device, never synced to the host). A CUDA
    input launches csrc/union_find.cu and counts the launch in
    ``cc_labels.launches``; a CPU input runs the twin.
    """
    if not eu.is_cuda:
        return cc_labels_ref(eu, ev, n_edges, s_cap)
    for name, t in (("eu", eu), ("ev", ev), ("n_edges", n_edges)):
        if t.dtype != torch.int32 or t.device != eu.device:
            raise ValueError(f"cc_labels: {name} must be int32 on "
                             f"{eu.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"cc_labels: {name} must be contiguous")
    if eu.dim() != 1 or ev.shape != eu.shape or n_edges.numel() != 1:
        raise ValueError("cc_labels: eu/ev must be (ec,) and n_edges ()")
    if not 0 < s_cap * 4 <= _SMEM_MAX:
        raise ValueError(f"cc_labels: s_cap={s_cap} labels do not fit a "
                         f"block's shared memory ({_SMEM_MAX} B)")
    out = torch.empty((s_cap,), dtype=torch.int32, device=eu.device)
    lib = _build.library()
    with torch.cuda.device(eu.device):
        stream = torch.cuda.current_stream(eu.device).cuda_stream
        rc = lib.union_find_launch(eu.data_ptr(), ev.data_ptr(),
                                   n_edges.data_ptr(), out.data_ptr(),
                                   eu.shape[0], s_cap, stream)
    _build.check(rc, "cc_labels")
    cc_labels.launches += 1
    return out


cc_labels.launches = 0
