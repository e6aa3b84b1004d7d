"""Stixel-clustering cap occupancies over a frame directory.

    python -m lidar_processing_tpu_torch.tools.measure_caps \\
        [--data-dir DIR] [--device cuda]

The counterpart of the repo's ``tools/measure_caps.py``: every frame of
``--data-dir`` (default: the checkout's ``data/``) through segmentation
and ``ops/stixel.py::cluster_debug`` at DEFAULT_CONFIG, then the max over
the frames of every capacity-bound quantity, so the PipelineConfig caps
and tier tables can be sized: obstacle points, cells, supernodes,
columns, column pairs, supernode pairs, edges, the live edges left after
one hook round (what enters the connected-components fixpoint), the
tier occupancies and the expansion-band counts, beside the overflow and
the cluster count. Prints a line every 50 frames and the maxima; returns
the maxima. Runs on the card unless ``--device`` names another (it
raises without one).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ._common import resolve_device


def _live_edges(dbg, s_cap: int) -> torch.Tensor:
    """Edges still straddling two labels after one hook round + four
    pointer jumps (the JAX tool's replica of the fixpoint's round 1)."""
    from ..ops.scan_utils import IMAX, scatter_drop, take
    e_u, e_v, e_ok = dbg["e_u"], dbg["e_v"], dbg["e_ok"]
    lab = torch.arange(s_cap, dtype=torch.int32, device=e_u.device)
    mn = torch.where(e_ok, torch.minimum(take(lab, e_u), take(lab, e_v)),
                     IMAX)
    for side in (e_u, e_v):
        hit = scatter_drop(s_cap, torch.where(e_ok, take(lab, side), s_cap),
                           mn, IMAX, "amin")
        lab = torch.minimum(lab, hit)
    for _ in range(4):
        lab = take(lab, lab)
    return (e_ok & (take(lab, e_u) != take(lab, e_v))).sum(dtype=torch.int32)


def frame_stats(xyz: torch.Tensor, mask: torch.Tensor, cfg) -> dict:
    """One padded frame's capacity-bound quantities (numpy values), its
    obstacles from the frame's own segmentation."""
    from ..ops.segmentation import gpf_segment
    from ..types import SEG_OBSTACLE
    seg = gpf_segment(xyz, mask, cfg.segmentation)
    return cluster_stats(xyz, mask & (seg.labels == SEG_OBSTACLE), cfg)


def cluster_stats(xyz: torch.Tensor, obstacle: torch.Tensor, cfg) -> dict:
    """The capacity-bound quantities of clustering `obstacle`'s points."""
    from ..ops import stixel as sx
    res, dbg = sx.cluster_debug(xyz, obstacle, cfg.clustering, cfg.pipeline)
    out = dict(
        n_obst=dbg["sp"].n_obst,
        n_cells=dbg["cells"].n_cells,
        n_sn=dbg["sn"].n_sn,
        n_cols=(dbg["col_sn_count"] > 0).sum(dtype=torch.int32),
        n_cpairs=dbg["n_cpairs"],
        n_snp=dbg["n_snp"],
        n_edges=dbg["e_ok"].sum(dtype=torch.int32),
        n_live=_live_edges(dbg, cfg.pipeline.max_supernodes),
        tiers1=dbg["tiers1"],
        tiers2=dbg["tiers2"],
        n_cls=dbg["n_cls"],
        overflow=res.overflow,
        num=res.num_clusters,
    )
    return {k: v.cpu().numpy() for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..io.dataset import list_frames, load_frame
    from ..io.synthetic import pad_frame

    cfg = DEFAULT_CONFIG
    dev = resolve_device(args.device)
    frames = list_frames(args.data_dir) if args.data_dir else list_frames()
    maxima: dict = {}
    for i, path in enumerate(frames):
        x, m = pad_frame(load_frame(path)[0], cfg.pipeline.max_points)
        out = frame_stats(torch.from_numpy(x).to(dev),
                          torch.from_numpy(m).to(dev), cfg)
        for k, v in out.items():
            maxima[k] = np.maximum(maxima.get(k, v), v)
        if i % 50 == 0:
            print(f"frame {i}: " + " ".join(
                f"{k}={v}" for k, v in out.items() if v.ndim == 0),
                flush=True)
    print(f"\n=== maxima over {len(frames)} frames ({dev.type}) ===")
    for k, v in maxima.items():
        print(f"{k:12s} {v}")
    return maxima


if __name__ == "__main__":
    main()
